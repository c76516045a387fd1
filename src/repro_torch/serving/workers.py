"""The two worker tiers of the disaggregated serving fabric.

``PrefillWorker`` — a dedicated prompt-processing peer.  The router ships
it ``srv_prefill`` jobs (prompt tokens + an already-reserved decode
slot); it batches same-length prompts into ONE prefill forward (the
architectural win disaggregation buys: the single-host server prefills
one prompt at a time, serially with decode), packs each sequence's KV
cache into a slab (kv.py), and *streams* it to the target decode peer as
a ``FLAG_STREAM`` payload over its own dispatcher — the stream's
admission ack resolves the job's future.

``DecodeWorker`` — a continuous-batching decode peer.  Its ingress dict
is the shared ``target_args`` of two mailboxes: the router's admission
ring (``srv_admit`` reserves a slot and advertises the accepted wire
codecs in the ack — negotiation, not a per-peer constructor argument)
and the prefill tier's KV stream ring (the streaming
``kv_install`` ifunc writes every chunk straight into the reserved
slot's landing slab on arrival — no buffered assembly).  ``pump()``
installs arrived slabs into the batcher, ticks decode, and reports each
finished sequence to the router with a ``srv_complete`` ifunc — the
decode-side completion reply path.

Both workers do their model work on ``device`` (the card unless the
caller asks for the CPU).  A prefill group makes one device-to-host copy
per cache entry; a decode peer hands the f32 numpy views of a landed slab
to the batcher, which moves them to the device at prompt width.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import Context, register_ifunc
from repro_torch.core import frame as F
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Obs
from repro_torch.serving import kv
from repro_torch.serving.batcher import ContinuousBatcher, Request
from repro_torch.tasks import TaskRuntime
from repro_torch.train import serve as SRV
from repro_torch.transport import Dispatcher, ProgressEngine, RdmaFabric

#: wire codecs a worker implementation can actually decode; negotiation
#: intersects the decode peer's advertisement with this
SUPPORTED_CODECS = ("raw", "rle", "quant8")


class PrefillWorker:
    """Prompt-prefill peer: batched prefill -> KV slab -> stream out.
    ``chunk_bytes`` and ``window`` shape each KV stream; the rings into
    the decode peers get slots of at least ``slot_size``, grown to hold a
    stream frame of ``window`` such chunks (``F.stream_slot_len``)."""

    def __init__(self, name: str, cfg: ModelConfig, params, decode_targets,
                 *, obs: Obs | None = None, max_batch: int = 8,
                 n_slots: int = 8, slot_size: int = 48 << 10,
                 chunk_bytes: int = 8 << 10, window: int = 4,
                 device="cuda"):
        self.name, self.cfg, self.params = name, cfg, params
        self.device = resolve_device(device)
        self.ctx = Context(name, device=self.device)
        self.ingress: dict = {"jobs": []}     # srv_prefill's target_args
        self.obs = obs if obs is not None else Obs(name)
        self.rt = TaskRuntime(
            self.ctx, Dispatcher(self.ctx, ProgressEngine(flush_threshold=4),
                                 obs=self.obs))
        # KV slabs auto-route into the stream path above the threshold —
        # every cache migration crosses the wire as chunked pipelined puts
        self.rt.dispatcher.set_streaming(True, chunk_bytes=chunk_bytes,
                                         window=window, threshold=2 << 10)
        self._kv = register_ifunc(self.ctx, "kv_install")
        self.slot_size = max(slot_size, F.stream_slot_len(
            len(self._kv.lib.code), chunk_bytes, window))
        for dname, (dctx, dargs) in decode_targets.items():
            self.rt.add_peer(dname, RdmaFabric(), dctx, n_slots=n_slots,
                             slot_size=self.slot_size, target_args=dargs)
        self._prefill = SRV.jit_prefill_step(cfg)   # shared across the fleet
        self.d2h_s = 0.0      # host s in the groups' device-to-host copies
        self.max_batch = max_batch
        self._negotiated: dict[str, str] = {}     # decode peer -> codec name
        self.inflight: list = []                  # unresolved install futures
        m = self.obs.metrics
        self._jobs_done = m.counter(f"serve.{name}.prefills")
        self._batches = m.counter(f"serve.{name}.prefill_batches")
        self._kv_bytes = m.counter(f"serve.{name}.kv_bytes")
        self.prefill_hist = m.histogram(f"serve.{name}.prefill_us")

    def depth(self) -> int:
        return len(self.ingress["jobs"]) + len(self.inflight)

    def _negotiate(self, dname: str, advertised) -> str:
        """Pick the decode peer's most-preferred codec this worker also
        implements (the ack lists them in preference order) and arm the
        dispatcher's per-peer wire codec with it."""
        got = self._negotiated.get(dname)
        if got is not None:
            return got
        chosen = next((c for c in advertised if c in SUPPORTED_CODECS), "raw")
        self.rt.dispatcher.set_peer_codec(dname, chosen)
        self._negotiated[dname] = chosen
        return chosen

    def pump(self) -> int:
        """Run up to ``max_batch`` queued jobs (same-length prompts batched
        into one forward), stream the slabs out, drive transport progress.
        Returns the number of sequences prefilled."""
        jobs = self.ingress["jobs"]
        ran = 0
        if jobs:
            take = jobs[:self.max_batch]
            del jobs[:len(take)]
            by_len: dict[int, list] = {}
            for j in take:
                by_len.setdefault(len(j["prompt"]), []).append(j)
            for S, group in by_len.items():
                self._run_group(S, group)
                ran += len(group)
        # resolved install futures leave the in-flight window
        self.inflight = [f for f in self.inflight if not f.done()]
        self.rt.progress()
        return ran

    def _run_group(self, S: int, group: list) -> None:
        t0 = time.perf_counter()
        k = len(group)
        prompts = np.stack([np.asarray(j["prompt"], np.int32) for j in group])
        tr = self.obs.tracer
        sp = tr.begin(f"prefill:{self.name}", cat="serve", actor=self.name,
                      corr=group[0]["rid"]) if tr.enabled else None
        cache, last = self._prefill(self.params, {"tokens": torch.as_tensor(
            prompts, device=self.device)})
        firsts = torch.argmax(last[:, -1], dim=-1).to(torch.int32).cpu().numpy()
        full = T.cache_shapes(self.cfg, k, S)
        one = T.cache_shapes(self.cfg, 1, S)
        bdims = {key: next((i for i, (a, b) in enumerate(
            zip(full[key].shape, one[key].shape)) if a != b), None)
            for key in full if not key.endswith("slot_pos")}
        # ONE device->host transfer per cache entry for the whole group;
        # per-row extraction below is pure numpy slicing
        t_d2h = time.perf_counter()
        host_cache = {key: cache[key].float().cpu().numpy()
                      for key in bdims}
        self.d2h_s += time.perf_counter() - t_d2h
        if sp is not None:
            tr.end(sp, batch=k, seq=S)
        for row, job in enumerate(group):
            entries = {}
            for key, bdim in bdims.items():
                arr = host_cache[key]
                if bdim is None:          # k == 1: shapes already per-row
                    entries[key] = arr
                else:
                    idx = tuple([slice(None)] * bdim
                                + [slice(row, row + 1)])
                    entries[key] = arr[idx]
            slab = kv.pack_kv(entries, job["rid"], job["slot"], S,
                              int(firsts[row]))
            self._negotiate(job["dpeer"], job.get("codecs", ("raw",)))
            fut = self.rt.submit(job["dpeer"], self._kv, slab)
            self.inflight.append(fut)
            self._kv_bytes.inc(len(slab))
            self._jobs_done.inc()
        self._batches.inc()
        self.prefill_hist.observe((time.perf_counter() - t0) * 1e6)


class DecodeWorker:
    """Continuous-batching decode peer + streamed-KV ingress."""

    def __init__(self, name: str, cfg: ModelConfig, params,
                 batch_slots: int, cache_len: int, *,
                 codecs=("rle", "raw"), obs: Obs | None = None,
                 device="cuda"):
        self.name, self.cfg = name, cfg
        self.obs = obs if obs is not None else Obs(name)
        self.batcher = ContinuousBatcher(cfg, params, batch_slots, cache_len,
                                         obs=self.obs, name=name,
                                         device=device)
        self.ctx = Context(name, device=self.batcher.device)
        self.codecs = tuple(codecs)
        cap = kv.slab_bytes(T.cache_shapes(cfg, 1, cache_len))
        # a KV stream executes on arrival into a landing slab of ``cap``
        # bytes, so the context accepts streams up to that size (the
        # default 64 MiB bound is below one SmolLM-360M slab of 820 tokens)
        self.ctx.max_stream_bytes = max(self.ctx.max_stream_bytes, cap)
        # landing slabs: ONE per decode slot, written in place by the
        # streaming kv_install chunks — the "cache slot" the stream lands in
        self.slabs = {s: bytearray(cap) for s in range(batch_slots)}
        self.arrivals: list[int] = []
        self.counters = {"buffered_installs": 0}
        self.ingress = self.kv_ingress()          # the router's admission view
        self.reserved: dict[int, dict] = {}       # slot -> admission meta
        self.rt: TaskRuntime | None = None        # armed by connect_router
        self._complete = None
        m = self.obs.metrics
        self._reserves = m.counter(f"serve.{name}.reserved")
        self._refused = m.counter(f"serve.{name}.admit_refused")
        self._installs = m.counter(f"serve.{name}.kv_installs")

    def kv_ingress(self) -> dict:
        """A fresh ``target_args`` view over the shared landing state.
        Every mailbox into this worker needs its OWN dict (the streaming
        installer stashes per-stream rx state under ``_kv_rx`` keyed by
        the mailbox's stream key, and keys from different mailboxes may
        collide) — but slabs/arrivals/counters are shared references, so
        all ingress paths land in one place."""
        return {"slabs": self.slabs, "kv_arrivals": self.arrivals,
                "counters": self.counters, "worker": self}

    # -- called from inside the srv_admit ifunc ------------------------------

    def reserve(self, rid: int, prompt_len: int, max_new: int) -> int:
        """Reserve a decode slot for an incoming sequence; -1 when full.
        The returned slot is the stream's landing address — it rides back
        to the router in the admission ack together with the advertised
        codec list."""
        if prompt_len >= self.batcher.W:
            return -1
        free = [s for s in self.batcher.free_slots()
                if s not in self.reserved]
        if not free:
            self._refused.inc()
            return -1
        slot = free[0]
        self.reserved[slot] = {"rid": rid, "max_new": max_new,
                               "prompt_len": prompt_len}
        self._reserves.inc()
        return slot

    def occupancy(self) -> int:
        return len(self.batcher.active) + len(self.reserved)

    # -- fabric wiring -------------------------------------------------------

    def connect_router(self, router_ctx, router_inbox: dict) -> None:
        self.rt = TaskRuntime(
            self.ctx, Dispatcher(self.ctx, ProgressEngine(flush_threshold=4),
                                 obs=self.obs))
        self.rt.add_peer("router", RdmaFabric(), router_ctx,
                         target_args=router_inbox)
        self._complete = register_ifunc(self.ctx, "srv_complete")

    # -- the decode loop -----------------------------------------------------

    def pump(self) -> tuple[int, int]:
        """Install every fully-arrived KV slab, run one decode tick, report
        completions.  Returns (#installed, #tokens decoded)."""
        installed = 0
        arrivals, self.arrivals[:] = list(self.arrivals), []
        for slot in arrivals:
            info = kv.unpack_kv(self.slabs[slot])
            meta = self.reserved.pop(slot, None)
            if meta is None or meta["rid"] != info["rid"]:
                raise RuntimeError(
                    f"{self.name}: stream landed in slot {slot} with no "
                    f"matching reservation (rid {info['rid']})")
            req = Request(info["rid"], np.empty(0, np.int32), meta["max_new"])
            self.batcher.install(slot, info["entries"], info["pos0"],
                                 info["first_token"], req)
            installed += 1
            self._installs.inc()
        emitted, finished = self.batcher.tick()
        for req in finished:
            self.rt.submit("router", self._complete,
                           {"rid": req.rid, "worker": self.name,
                            "tokens": req.out})
        if self.rt is not None:
            self.rt.progress()
        return installed, emitted


__all__ = ["PrefillWorker", "DecodeWorker", "SUPPORTED_CODECS"]
