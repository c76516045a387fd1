"""Router + single-process emulation harness for the disaggregated
serving fabric.

Request lifecycle (every hop is an ifunc over a dispatcher ring)::

    client -> Router: enqueue(Request)
    Router -> DecodeWorker:   srv_admit     (reserve slot; ack carries the
                                             slot + advertised codecs)
    Router -> PrefillWorker:  srv_prefill   (prompt + slot + dpeer + codecs)
    PrefillWorker -> DecodeWorker: kv_install as a FLAG_STREAM payload —
                              chunks execute on arrival into the slot's
                              landing slab (zero buffered assembly)
    DecodeWorker  -> Router:  srv_complete  (the decoded token string —
                              the decode-side completion reply path)

Placement pricing: the router owns a :class:`PlacementEngine` as a pure
hop pricer over its own dispatcher (``directory=None``) — a decode
peer's price is the modeled wire cost of the sequence's KV slab plus the
live ``queue_depth`` toll of its admission rings (striping-aware)
plus the decode occupancy the router has observed (admitted minus
completed).  Prefill jobs go to the shallowest prefill queue.

``ServingFabric(device=...)`` puts every worker's model work on the card
unless the caller asks for the CPU; the router does no model work.
"""

from __future__ import annotations

import time

from repro_torch.core import Context, register_ifunc
from repro_torch.models import transformer as T
from repro_torch.obs import Obs
from repro_torch.serving import kv
from repro_torch.serving.batcher import Request
from repro_torch.serving.workers import DecodeWorker, PrefillWorker
from repro_torch.tasks import PlacementEngine, TaskRuntime
from repro_torch.transport import Dispatcher, ProgressEngine, RdmaFabric


class Router:
    """Prices decode placement, drives admission + prefill dispatch, and
    collects completions."""

    def __init__(self, cfg, *, obs: Obs | None = None,
                 decode_service_s: float = 200e-6):
        self.cfg = cfg
        self.ctx = Context("router")
        self.obs = obs if obs is not None else Obs("router")
        self.inbox: dict = {"completions": []}
        self.rt = TaskRuntime(
            self.ctx, Dispatcher(self.ctx, ProgressEngine(flush_threshold=4),
                                 obs=self.obs))
        self.engine: PlacementEngine | None = None
        self.decode_service_s = decode_service_s
        self._admit = register_ifunc(self.ctx, "srv_admit")
        self._prefill = register_ifunc(self.ctx, "srv_prefill")
        self.prefills: list[str] = []
        self.decodes: list[str] = []
        self._pw: dict[str, PrefillWorker] = {}
        self.pending: list[Request] = []
        self.requests: dict[int, Request] = {}
        self.admitted: dict[int, str] = {}        # rid -> decode peer
        self.outstanding: dict[str, int] = {}     # decode peer -> live seqs
        self.capacity: dict[str, int] = {}        # decode peer -> batch slots
        self.done: dict[int, Request] = {}
        self._admit_futs: list = []               # (future, request, dname)
        self._prefill_futs: list = []
        self._slab_est: dict[int, int] = {}       # prompt len -> slab bytes
        m = self.obs.metrics
        self._routed = m.counter("serve.router.routed")
        self._retries = m.counter("serve.router.admit_retries")
        self._completions = m.counter("serve.router.completions")
        self.route_hist = m.histogram("serve.router.route_us")

    def attach(self, prefill_workers: list[PrefillWorker],
               decode_workers: list[DecodeWorker]) -> None:
        """Open the admission rings (striped x2 — the router is every
        sequence's first hop, so its slot budget scales with stripe width
        and the pricer divides depth by it) and the prefill job rings."""
        for dw in decode_workers:
            self.rt.add_peer(dw.name, RdmaFabric(), dw.ctx,
                             rings=2, stripe=True, n_slots=8,
                             target_args=dw.ingress)
            self.decodes.append(dw.name)
            self.outstanding[dw.name] = 0
            self.capacity[dw.name] = dw.batcher.B
        for pw in prefill_workers:
            self.rt.add_peer(pw.name, RdmaFabric(), pw.ctx, n_slots=8,
                             slot_size=16 << 10, target_args=pw.ingress)
            self.prefills.append(pw.name)
            self._pw[pw.name] = pw
        self.engine = PlacementEngine(None, self.rt.dispatcher,
                                      service_s=50e-6)

    # -- pricing -------------------------------------------------------------

    def _kv_bytes(self, prompt_len: int) -> int:
        est = self._slab_est.get(prompt_len)
        if est is None:
            est = self._slab_est[prompt_len] = kv.slab_bytes(
                T.cache_shapes(self.cfg, 1, prompt_len))
        return est

    def _price_decode(self, dname: str, prompt_len: int) -> float:
        """Wire cost of migrating this sequence's KV slab + admission-ring
        queue toll (PlacementEngine.hop_cost, striping-aware) + the decode
        occupancy this router has admitted and not yet seen complete."""
        return (self.engine.hop_cost(dname, self._kv_bytes(prompt_len))
                + self.outstanding[dname] * self.decode_service_s)

    def _pick_prefill(self) -> str:
        return min(self.prefills,
                   key=lambda p: (self._pw[p].depth(),
                                  self.engine.queue_depth(p)))

    # -- lifecycle -----------------------------------------------------------

    def enqueue(self, reqs) -> None:
        for r in reqs:
            self.requests[r.rid] = r
            self.pending.append(r)

    def step(self) -> None:
        """One router turn: drain completions, admit pending sequences at
        the cheapest decode peer, forward admitted ones to a prefill peer."""
        # 1. completions (the decode reply path — a request is done HERE)
        comps, self.inbox["completions"] = self.inbox["completions"], []
        for c in comps:
            req = self.requests[c["rid"]]
            req.out = list(c["tokens"])
            self.done[c["rid"]] = req
            dname = self.admitted.pop(c["rid"], None)
            if dname is not None:
                self.outstanding[dname] -= 1
            self._completions.inc()
        # 2. admission: cheapest decode peer with headroom first.  The
        # occupancy gate is the router-side half of admission control —
        # a full tier waits HERE instead of flooding the wire with
        # admits destined for a slot=-1 refusal.
        still = []
        for req in self.pending:
            t0 = time.perf_counter()
            open_ = [d for d in self.decodes
                     if self.outstanding[d] < self.capacity[d]]
            if not open_:
                still.append(req)
                continue
            dname = min(open_,
                        key=lambda d: self._price_decode(d, len(req.prompt)))
            fut = self.rt.submit(dname, self._admit,
                                 {"rid": req.rid, "max_new": req.max_new,
                                  "prompt_len": len(req.prompt)},
                                 wait_credits=False)
            if fut is None:                      # ring full: retry next step
                still.append(req)
                continue
            self.outstanding[dname] += 1         # provisionally occupied
            self.route_hist.observe((time.perf_counter() - t0) * 1e6)
            self._admit_futs.append((fut, req, dname))
        self.pending = still
        self.rt.progress()
        # 3. admission acks -> prefill dispatch (ack advertises the codecs)
        unresolved = []
        for fut, req, dname in self._admit_futs:
            if not fut.done():
                unresolved.append((fut, req, dname))
                continue
            ack = fut.result(timeout=0)
            if ack["slot"] < 0:                  # decode tier full: requeue
                self.outstanding[dname] -= 1     # provisional slot released
                self.pending.append(req)
                self._retries.inc()
                continue
            self.admitted[req.rid] = dname
            pname = self._pick_prefill()
            pfut = self.rt.submit(pname, self._prefill,
                                  {"rid": req.rid, "slot": ack["slot"],
                                   "max_new": req.max_new, "dpeer": dname,
                                   "codecs": ack["codecs"],
                                   "prompt": req.prompt})
            self._prefill_futs.append(pfut)
            self._routed.inc()
        self._admit_futs = unresolved
        self._prefill_futs = [f for f in self._prefill_futs if not f.done()]


class ServingFabric:
    """N prefill + M decode peers + router, emulated in one process: the
    run loop interleaves every tier's pump, which is what a real
    deployment's per-process event loops do concurrently.  Each KV cache
    streams in chunks of ``kv_chunk_bytes``, ``kv_window`` in flight; a
    subclass sets them to the slabs it serves."""

    kv_chunk_bytes = 8 << 10
    kv_window = 4

    def __init__(self, cfg, params, *, n_prefill: int = 2, n_decode: int = 2,
                 batch_slots: int = 8, cache_len: int = 64,
                 decode_codecs=("rle", "raw"), prefill_max_batch: int = 8,
                 obs: Obs | None = None, device="cuda"):
        self.cfg, self.params = cfg, params
        self.obs = obs if obs is not None else Obs("serving")
        self.router = Router(cfg, obs=self.obs)
        self.decode_workers = [
            DecodeWorker(f"decode{i}", cfg, params, batch_slots, cache_len,
                         codecs=decode_codecs, obs=self.obs, device=device)
            for i in range(n_decode)]
        for dw in self.decode_workers:
            dw.connect_router(self.router.ctx, self.router.inbox)
        # each prefill worker's mailbox into a decode peer gets its OWN
        # ingress view (per-mailbox stream-rx state; shared slabs)
        self.prefill_workers = [
            PrefillWorker(
                f"prefill{i}", cfg, params,
                {dw.name: (dw.ctx, dw.kv_ingress())
                 for dw in self.decode_workers},
                obs=self.obs, max_batch=prefill_max_batch,
                chunk_bytes=self.kv_chunk_bytes, window=self.kv_window,
                device=device)
            for i in range(n_prefill)]
        self.router.attach(self.prefill_workers, self.decode_workers)

    def run(self, requests, *, max_rounds: int = 100_000,
            tick_cb=None) -> dict[int, Request]:
        """Open-loop: every request enters the router queue up front; the
        loop turns every tier until all completions have landed."""
        reqs = list(requests)
        self.router.enqueue(reqs)
        rounds = 0
        while len(self.router.done) < len(self.router.requests):
            self.router.step()
            for pw in self.prefill_workers:
                pw.pump()
            for dw in self.decode_workers:
                dw.pump()
            if tick_cb is not None:
                tick_cb(self)
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError(
                    f"serving fabric wedged: {len(self.router.done)}/"
                    f"{len(self.router.requests)} done after {rounds} rounds")
        return self.router.done

    # -- invariants the demo and tests assert --------------------------------

    def buffered_installs(self) -> int:
        """KV slabs that arrived as store-and-forward frames instead of
        executing on arrival — MUST be zero: every migration streams."""
        return sum(dw.counters["buffered_installs"]
                   for dw in self.decode_workers)

    def streams_landed(self) -> int:
        return sum(dw.ctx.stats.get("streams", 0)
                   for dw in self.decode_workers)

    def drain(self, deadline: float = 5.0) -> None:
        self.router.rt.drain(deadline=deadline)
        for pw in self.prefill_workers:
            pw.rt.drain(deadline=deadline)
        for dw in self.decode_workers:
            dw.rt.drain(deadline=deadline)


__all__ = ["Router", "ServingFabric"]
