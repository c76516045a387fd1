"""Single-host serving: the continuous batcher fronted by the ifunc
transport — the baseline the disaggregated fabric (fabric.py) is measured
against, and the simplest deployment shape.

``Server`` owns one :class:`~repro_torch.serving.batcher.ContinuousBatcher`
on ``device`` (the card unless the caller asks for the CPU) plus the
shared prefill step; ``IfuncFrontend`` feeds it ``srv_enqueue``
request frames over a credit-flow-controlled ring.  Two serving-loop
contracts worth naming because earlier drivers got them wrong:

* **Completion comes off the decode path.**  ``admit`` returning True
  means the sequence *started*; ``tick`` returns the requests whose last
  token was just decoded, and only those are done — never inside the
  admit loop, before a single decode token exists.
* **Per-wave quantiles are deltas.**  ``wave_summary`` reconstructs the
  admit-latency histogram for *this wave only* via snapshot subtraction
  (``obs.delta`` + ``Histogram.from_snapshot``) instead of quoting the
  cumulative histogram, which buries a slow wave under the history.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.obs import Obs, delta
from repro_torch.obs.metrics import Histogram
from repro_torch.serving.batcher import ContinuousBatcher, Request
from repro_torch.train import serve as SRV

TINY = ModelConfig(name="serve-tiny", family="dense", num_layers=4, d_model=128,
                   num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
                   q_chunk=128)


class Server:
    """Continuous-batching single-host server (B slots, per-slot pos)."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int,
                 cache_len: int, *, obs: Obs | None = None,
                 device="cuda"):
        self.cfg, self.params = cfg, params
        self.obs = obs if obs is not None else Obs("server")
        self.batcher = ContinuousBatcher(cfg, params, batch_slots, cache_len,
                                         obs=self.obs, name="host",
                                         device=device)
        self.device = self.batcher.device
        self.B, self.W = batch_slots, cache_len
        self._prefill = SRV.jit_prefill_step(cfg)
        m = self.obs.metrics
        self.admit_hist = m.histogram("serve.admit_us")
        self._admitted = m.counter("serve.admitted")
        self._decoded = m.counter("serve.decoded")
        self._admit_full = m.counter("serve.admit_full")
        self._wave_snap = self.obs.snapshot()

    @property
    def active(self) -> dict[int, Request]:
        return self.batcher.active

    def admit(self, req: Request) -> bool:
        """Prefill + splice into a free slot.  True means the sequence is
        *running* — it is done only when ``tick`` returns it."""
        free = self.batcher.free_slots()
        if not free:
            self._admit_full.inc()
            return False
        t0 = time.perf_counter()
        cache1, last = self._prefill(self.params, {"tokens": torch.as_tensor(
            req.prompt[None], device=self.device)})
        first = torch.argmax(last[0, -1]).item()
        self.batcher.install(free[0], cache1, len(req.prompt), first, req)
        self._admitted.inc()
        self.admit_hist.observe((time.perf_counter() - t0) * 1e6)
        return True

    def tick(self) -> tuple[int, list[Request]]:
        """One decode step; returns (#tokens, requests that just finished).
        The finished list IS the completion signal — the decode reply
        path, not the admit loop."""
        emitted, finished = self.batcher.tick()
        self._decoded.inc(emitted)
        return emitted, finished

    # -- observability -------------------------------------------------------

    def metrics(self) -> dict:
        """Full registry snapshot (serving counters, admission latency
        histogram, and — when the transport's bundle was passed in —
        ingest/dispatch counters), JSON-serializable."""
        return self.obs.snapshot()

    def wave_summary(self) -> str:
        """One line covering activity since the previous call: requests
        admitted, tokens decoded, and the p50/p99 admission latency OF
        THIS WAVE (delta histogram, not the cumulative one)."""
        cur = self.obs.snapshot()
        d = delta(cur, self._wave_snap)
        self._wave_snap = cur
        dh = Histogram.from_snapshot(
            "serve.admit_us", d["histograms"].get("serve.admit_us", {}))
        return (f"wave: admitted={d['counters'].get('serve.admitted', 0)} "
                f"decoded={d['counters'].get('serve.decoded', 0)} "
                f"active={len(self.active)}/{self.B} "
                f"admit_us p50={dh.quantile(0.5)} p99={dh.quantile(0.99)}")


class IfuncFrontend:
    """Request/response ingestion over the task runtime: the frontend
    submits ``srv_enqueue`` ifuncs into the server's mailbox ring and gets
    an *admission ack future* back per request — the server's reply frame
    carries ``{rid, queued, depth}``, so the frontend knows not just that
    the frame left but that the batcher actually accepted the request.
    Ring credits remain the admission-control backpressure — a frontend
    outrunning the server sees ``submit`` return None instead of
    overwriting unconsumed requests, and the refused submit's future is
    unregistered from the corr table on the spot (no leak)."""

    def __init__(self, server_ctx, n_slots: int = 4, slot_size: int = 8 << 10):
        from repro_torch.core import Context, register_ifunc
        from repro_torch.tasks import TaskRuntime
        from repro_torch.transport import ProgressEngine, RdmaFabric

        self.inbox: dict = {"queue": []}
        self.ctx = Context("frontend")
        self.rt = TaskRuntime(self.ctx, engine=ProgressEngine(flush_threshold=4))
        self.dispatcher = self.rt.dispatcher
        self.rt.add_peer("server", RdmaFabric(), server_ctx,
                         n_slots=n_slots, slot_size=slot_size,
                         target_args=self.inbox)
        self._handle = register_ifunc(self.ctx, "srv_enqueue")

    def submit(self, req: Request):
        """Zero-copy ingestion: the request codec packs straight into the
        server ring's slab cell.  The first request ships the srv_enqueue
        code FULL; once delivery confirms the server's link cache, every
        later request goes SLIM (header + payload, codec elided) — the
        warmed-up steady state is the paper's cached fast path.  Returns
        the admission-ack Future, or None under backpressure."""
        return self.rt.submit(
            "server", self._handle,
            {"rid": req.rid, "max_new": req.max_new, "prompt": req.prompt},
            wait_credits=False)

    def server_poll(self, max_msgs: int = 16) -> list[Request]:
        """Server side: flush in-flight frames, drain the mailbox through
        the dispatcher's poll loop (which also posts + routes the acks),
        return newly arrived requests."""
        self.dispatcher.flush()
        self.dispatcher.poll(budget=max_msgs)
        out = [Request(d["rid"], np.asarray(d["prompt"], np.int32), d["max_new"])
               for d in self.inbox["queue"]]
        self.inbox["queue"] = []
        return out


__all__ = ["TINY", "Server", "IfuncFrontend", "Request"]
