"""FlowNode: one peer's end of the dataflow engine — the continuation
hook plus that peer's *own* dispatcher.

When a continuation frame executes at this node (``poll_ifunc`` hands it
to :meth:`on_flow_frame` via ``ctx.flow``), the node packs the result
straight into the next request frame and forwards it peer-to-peer through
``self.dispatcher`` — the chain's origin host never sees the intermediate
result.  An empty remaining chain (or a failed stage) turns into an
OK/ERR reply posted to the origin's per-node return ring instead.

Gather rendezvous: a branch frame whose chain head is a gather entry
addressed *to this node* is buffered, not executed; when the group's
``expect``-th branch lands, the collected payloads are chunk-framed
(``tasks.wire.pack_chunks``) and the reduce ifunc — the linked fn of the
arriving frames themselves — runs once over all of them.  Partial
aggregation happens here, at the gather peer, not at the host.
"""

from __future__ import annotations

from collections import deque

from repro_torch.core import IfuncHandle, register_ifunc
from repro_torch.flow import descriptor as D
from repro_torch.tasks import wire
from repro_torch.transport import Dispatcher


class FlowNode:
    """A participating peer: context + fabric + forwarding dispatcher."""

    def __init__(self, engine, name: str, ctx, fabric, *,
                 n_slots: int = 8, slot_size: int = 64 << 10):
        self.engine = engine            # FlowEngine
        self.name = name
        self.ctx = ctx
        self.fabric = fabric
        self.n_slots, self.slot_size = n_slots, slot_size
        # every node's dispatcher shares the flow engine's obs bundle:
        # one trace, peers as swimlanes
        self.dispatcher = Dispatcher(ctx, engine.pe,
                                     obs=getattr(engine, "obs", None))
        if getattr(engine, "coalesce", False):
            # forwards ride the coalescing queue: a scatter fanning N
            # branches through the same downstream peer ships them as ONE
            # aggregate container instead of N frames
            self.dispatcher.set_coalescing(True)
        self._defer_flush = False       # batch a scatter's forwards into
        #                                 one flush (aggregation window)
        self.target_args: dict = {}     # shared by every inbound ring
        self.gathers: dict = {}         # (corr, gid) -> {"expect", "chunks"}
        self.outbox: deque = deque()    # forwards deferred on backpressure
        self._pricer = None
        self.stats = {"forwards": 0, "gather_buffered": 0,
                      "gather_reduced": 0, "replies": 0, "errors": 0,
                      "deferred": 0, "gather_orphans": 0, "dead_drops": 0}
        self.obs = self.dispatcher.obs
        self.obs.metrics.register_dict(f"node.{name}", self.stats)
        ctx.flow = self                 # install the poll_ifunc hook
        # flow inboxes are drained by the engine's poll crank, not by a
        # dedicated spinning consumer: a mid-put frame (header landed,
        # trailer withheld until the sender's flush) should surface as
        # IN_PROGRESS after a short spin and be picked up next crank —
        # burning the default 1M spins per hop would serialize the whole
        # pipeline on the emulation's wait loop
        ctx.max_trailer_spins = min(ctx.max_trailer_spins, 256)

    # -- source side (forwarding) -------------------------------------------

    def handle(self, ifunc: str, digest: bytes | None = None):
        """This node's handle for an ifunc (forwarding needs the library's
        payload codec + code for FULL frames / NACK rebuilds).

        ``digest`` pins the hop to the exact code the flow was compiled
        against: it resolves from the engine's digest-addressed library
        registry first (filled at compile time — CPython's ``marshal`` is
        not byte-deterministic across independent module loads, so a local
        reload of the *same source* can legitimately hash differently); a
        digest that matches neither the registry nor the local library is
        a short-circuiting error, never a silent substitution."""
        pinned = digest is not None and digest != D.NO_DIGEST
        h = self.ctx.handles.get(ifunc)
        if h is not None and (not pinned or h.digest == digest):
            return h
        if pinned:
            lib = self.engine.libraries.get(digest)
            if lib is not None:         # adopt the canonical compiled version
                h = IfuncHandle(self.ctx, lib)
                self.ctx.handles[ifunc] = h
                return h
        if h is None:
            h = register_ifunc(self.ctx, ifunc)
        if pinned and h.digest != digest:
            raise D.FlowError(
                f"code digest mismatch for {ifunc!r}: neither the engine's "
                f"library registry nor the local load matches the digest "
                f"this flow was compiled against")
        return h

    def ensure_peer(self, peer_name: str):
        """Lazily open a lane to another flow node (links materialize the
        first time a chain actually routes this way)."""
        peer = self.dispatcher.peers.get(peer_name)
        if peer is None:
            tgt = self.engine.nodes[peer_name]
            peer = self.dispatcher.add_peer(
                peer_name, tgt.fabric, tgt.ctx, n_slots=tgt.n_slots,
                slot_size=tgt.slot_size, target_args=tgt.target_args)
        return peer

    @property
    def pricer(self):
        """Hop pricer over this node's dispatcher (wire model + live queue
        depths) — what the flow compiler consults per candidate peer."""
        if self._pricer is None:
            from repro_torch.tasks.placement import PlacementEngine

            self._pricer = PlacementEngine(None, self.dispatcher)
        return self._pricer

    def pump(self) -> int:
        """Retry forwards deferred on backpressure; returns sends drained."""
        n = 0
        while self.outbox:
            peer, h, args, cont = self.outbox[0]
            if not self.dispatcher.send_ifunc(peer, h, args, cont=cont):
                break
            self.outbox.popleft()
            n += 1
        return n

    # -- the ctx.flow hook (runs inside poll_ifunc at THIS node) ------------

    def on_flow_frame(self, ctx, hdr, fn, payload, cont, target_args) -> None:
        chain = D.parse_chain(cont)     # FlowError -> frame REJECTED
        head = chain.entries[0] if chain.entries else None
        if (isinstance(head, D.Hop)
                and head.kind == D.KIND_GATHER_ARRIVAL):
            # the explicit wire marker for a branch RESULT reaching its
            # rendezvous — never confused with a branch stage that merely
            # runs the gather ifunc at the gather peer
            self._gather_arrival(chain, head, fn, target_args, payload)
            return
        if isinstance(target_args, dict):
            target_args.pop("result", None)
        tr = self.obs.tracer
        sp = (tr.begin(f"{hdr.name}@{self.name}", cat="flow",
                       actor=self.name, corr=chain.corr)
              if tr.enabled else None)
        try:
            fn(payload, len(payload), target_args)
        except Exception as e:          # stage failed: short-circuit to origin
            if sp is not None:
                tr.end(sp, status="error", error=type(e).__name__)
            self._short_circuit(chain, e, f"{hdr.name}@{self.name}")
            return
        if sp is not None:
            tr.end(sp, status="ok")
        ctx.stats["executed"] += 1
        value = (target_args.get("result")
                 if isinstance(target_args, dict) else None)
        self.continue_chain(chain, value)

    def _gather_arrival(self, chain: D.Chain, g: D.Hop, fn, target_args,
                        payload) -> None:
        if chain.corr not in self.engine.futures:
            # the chain already resolved (an error short-circuit beat this
            # sibling branch to the origin, or the caller cancelled): a
            # late arrival must not resurrect rendezvous state that
            # engine._cleanup dropped — it could never fill
            self.stats["gather_orphans"] += 1
            return
        key = (chain.corr, g.gid)
        st = self.gathers.setdefault(key, {"expect": g.expect, "chunks": {}})
        st["chunks"][g.idx] = bytes(payload)
        self.stats["gather_buffered"] += 1
        if len(st["chunks"]) < st["expect"]:
            return                      # rendezvous still filling
        del self.gathers[key]
        combined = wire.pack_chunks(
            [st["chunks"][i] for i in sorted(st["chunks"])])
        if isinstance(target_args, dict):
            target_args.pop("result", None)
        tr = self.obs.tracer
        sp = (tr.begin(f"{g.ifunc}@{self.name}", cat="flow",
                       actor=self.name, corr=chain.corr,
                       gather=st["expect"])
              if tr.enabled else None)
        try:
            fn(combined, len(combined), target_args)
        except Exception as e:
            if sp is not None:
                tr.end(sp, status="error", error=type(e).__name__)
            self._short_circuit(chain, e, g.label)
            return
        if sp is not None:
            tr.end(sp, status="ok")
        self.ctx.stats["executed"] += 1
        self.stats["gather_reduced"] += 1
        value = (target_args.get("result")
                 if isinstance(target_args, dict) else None)
        self.continue_chain(chain.advanced(), value)

    # -- continuation stepping ----------------------------------------------

    def continue_chain(self, chain: D.Chain, value) -> None:
        """Take one step of a chain with ``value`` in hand: forward to the
        next hop, fan out a scatter, hand a branch result to its gather,
        or — chain exhausted — reply to the origin."""
        ents = chain.entries
        if not ents:
            self.stats["replies"] += 1
            self.engine.post_reply(self, chain, value, is_err=False)
            return
        head = ents[0]
        if not (isinstance(head, D.Hop)
                and head.kind in (D.KIND_GATHER, D.KIND_GATHER_ARRIVAL)):
            # chain-level progress record (elastic replay resumes from the
            # last value that reached a stage boundary); a branch result
            # headed for its rendezvous is NOT chain progress — the whole
            # scatter replays if the gather peer dies
            self.engine.note_progress(chain.corr, ents, value, self.name)
        try:
            if isinstance(head, D.Scatter):
                rest = ents[1:]
                if not (rest and isinstance(rest[0], D.Hop)
                        and rest[0].kind == D.KIND_GATHER):
                    raise D.FlowError("scatter must be followed by a gather")
                g = rest[0]
                # defer the eager per-forward flush until every branch is
                # enqueued: branches sharing a downstream peer coalesce
                # into one aggregate put instead of one frame each
                self._defer_flush = True
                try:
                    for i, br in enumerate(head.branches):
                        g_i = D.Hop(g.peer, g.ifunc, g.digest, g.bind,
                                    expect=len(head.branches), gid=g.gid,
                                    idx=i, kind=D.KIND_GATHER)
                        self._forward(chain, br, (g_i,) + rest[1:], value)
                finally:
                    self._defer_flush = False
                    self._flush_forwards()
                return
            if head.kind in (D.KIND_GATHER, D.KIND_GATHER_ARRIVAL):
                # this value is one branch's result: ship it to the
                # rendezvous, restamped with the explicit arrival marker
                # (expect/gid/idx already baked in at scatter time)
                marked = D.Hop(head.peer, head.ifunc, head.digest, head.bind,
                               expect=head.expect, gid=head.gid,
                               idx=head.idx, kind=D.KIND_GATHER_ARRIVAL)
                self._forward(chain, marked, (marked,) + ents[1:], value)
                return
            self._forward(chain, head, ents[1:], value)
        except Exception as e:          # bind/registry/frame-size errors
            label = getattr(head, "label", type(head).__name__)
            self._short_circuit(chain, e, f"{label}")

    def _forward(self, chain: D.Chain, hop: D.Hop, remaining, value) -> None:
        if hop.peer not in self.engine.nodes:
            # the hop's peer was retired by elastic recovery between this
            # stage's execution and its forward: drop silently — the
            # engine's chain record already replayed (or failed) the chain
            # from the origin, and a short-circuit here would race that
            # resolution with a spurious ERR
            self.stats["dead_drops"] += 1
            return
        h = self.handle(hop.ifunc, hop.digest)
        args = D.apply_bind(hop.bind, value)
        cont = D.pack_chain(D.Chain(chain.origin, chain.corr,
                                    tuple(remaining)))
        peer = self.ensure_peer(hop.peer)
        if self.dispatcher.send_ifunc(hop.peer, h, args, cont=cont):
            # forwards sit on the chain's critical path: publish the
            # trailer now so the downstream sweep — often later in this
            # same progress crank — consumes the hop instead of idling a
            # crank on an in-flight window.  (Inside a scatter the flush
            # is deferred to the end of the fan-out so the branches get
            # an aggregation window first.)
            self.stats["forwards"] += 1
            if not self._defer_flush:
                self.dispatcher.flush_coalesced(hop.peer)
                for r in peer.rings:
                    self.engine.pe.flush(r.channel)
        else:                           # backpressure: retry from pump()
            self.outbox.append((hop.peer, h, args, cont))
            self.stats["deferred"] += 1

    def _flush_forwards(self) -> None:
        """Pack + publish every queued forward on this node (the scatter
        batch flush): coalescing queues first, then the channel trailers."""
        self.dispatcher.flush_coalesced()
        for peer in self.dispatcher.peers.values():
            for r in peer.rings:
                self.engine.pe.flush(r.channel)

    def _short_circuit(self, chain: D.Chain, exc: BaseException,
                       hop_label: str) -> None:
        """A failed stage kills the whole chain: ERR reply straight to the
        origin, carrying the failing hop."""
        self.ctx.stats["flow_errors"] += 1
        self.stats["errors"] += 1
        self.obs.record("flow_error", self.name,
                        f"corr={chain.corr} hop={hop_label}")
        self.engine.post_reply(self, chain, exc, is_err=True, hop=hop_label)

    def summary(self) -> str:
        s = self.stats
        return (f"{self.name:<10s} fabric={self.fabric.kind:<9s} "
                f"fwd={s['forwards']:<4d} gather={s['gather_buffered']:<4d} "
                f"reduced={s['gather_reduced']:<3d} "
                f"replies={s['replies']:<3d} errors={s['errors']:<3d} "
                f"deferred={s['deferred']}")


__all__ = ["FlowNode"]
