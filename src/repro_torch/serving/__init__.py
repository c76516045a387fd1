"""repro_torch.serving — the inference fabric (the reference's
``repro.serving``).

Two deployment shapes over one decode engine:

* :mod:`repro_torch.serving.host` — single-host ``Server``: one process owns
  prefill + the continuous batcher, fed ``srv_enqueue`` frames by an
  ``IfuncFrontend``.
* :mod:`repro_torch.serving.fabric` — disaggregated ``ServingFabric``:
  dedicated prefill peers, decode peers, and a pricing router; KV caches
  migrate between peers as streamed ifunc payloads (``kv_install``).

Shared machinery: :mod:`batcher` (per-slot-position continuous
batching), :mod:`kv` (the KV slab wire format), :mod:`workers` (the
prefill/decode peer implementations).
"""

from repro_torch.serving.batcher import ContinuousBatcher, Request
from repro_torch.serving.fabric import Router, ServingFabric
from repro_torch.serving.host import TINY, IfuncFrontend, Server
from repro_torch.serving.workers import DecodeWorker, PrefillWorker

__all__ = ["ContinuousBatcher", "Request", "Router", "ServingFabric",
           "TINY", "IfuncFrontend", "Server", "DecodeWorker",
           "PrefillWorker"]
