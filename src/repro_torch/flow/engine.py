"""FlowEngine + Flow: continuation-passing dataflow over ifunc peers.

The engine owns a set of :class:`~repro_torch.flow.node.FlowNode` s — one
per participating peer, the submitting host included — and the origin-side
bookkeeping: per-node *return rings* the final hop posts OK/ERR replies
into, the corr_id -> Future table, and the progress crank that advances
every node's dispatcher each turn.

:class:`Flow` describes the DAG::

    flow = (Flow("etl")
            .stage("csd_decompress", at="csd")
            .then("dpu_filter", at=["dpu_a", "dpu_b"],
                  bind={"mode": "kw", "key": "data",
                        "static": {"threshold": 40}})
            .then("host_aggregate", at="agg"))
    total = engine.submit(flow, compressed_blob).result()

``compile`` lowers a ``Flow`` into packed continuation descriptors.  A
stage with several candidate peers is *priced* per hop at submit time —
fabric wire model + live queue depth, via
``tasks.placement.PlacementEngine.hop_cost`` over the upstream node's
dispatcher — so congestion steers chains around busy peers.  Scatter
fans the upstream result out to N branch stages; the mandatory gather
that follows reduces the branch results *at the gather peer* (partial
aggregation in the network path), and only the reduced value travels on.

Submission itself is uniform with forwarding: ``submit`` treats the
initial args as the result of a virtual stage at the origin and calls
``origin.continue_chain`` — so a flow may begin with a hop, or directly
with a scatter.

Device-mesh peers cannot join a flow (the compiled sweep has no
forwarding hook); chains are host-tier — RDMA, loopback/CSD.  A node's
context runs its μVM stages where its ``device`` says: a node that
``add_node`` builds sits on the origin context's device, so an engine
over a ``device="cpu"`` origin stays on the CPU and one over the default
runs each μVM stage as one ``ifunc_vm`` launch on the card, its result a
tensor there that the next hop's payload codec reads.

Elastic recovery (``on_peer_death``, driven by
``repro_torch.runtime.ElasticController``) is the reference's.
"""

from __future__ import annotations

from repro_torch.core import Context, register_ifunc
from repro_torch.core import frame as F
from repro_torch.flow import descriptor as D
from repro_torch.flow.node import FlowNode
from repro_torch.obs import Obs
from repro_torch.tasks import wire
from repro_torch.tasks.future import Future
from repro_torch.transport import ProgressEngine, TransportError

DEFAULT_EST_BYTES = 4096


class Flow:
    """Chainable flow description; ``FlowEngine.submit`` compiles + runs."""

    def __init__(self, label: str = "flow"):
        self.label = label
        self._ops: list[tuple] = []

    def stage(self, ifunc: str, at, *, bind: dict | None = None,
              est_bytes: int = DEFAULT_EST_BYTES) -> "Flow":
        """Run ``ifunc`` at ``at`` (a peer name, or a list of candidate
        peers priced per hop at submit time)."""
        self._ops.append(("stage", ifunc, at, bind, est_bytes))
        return self

    #: ``then`` reads better after the first stage; same operation.
    then = stage

    def scatter(self, ifunc: str, at: list, *, bind: dict | None = None,
                binds: list | None = None,
                est_bytes: int = DEFAULT_EST_BYTES) -> "Flow":
        """Fan the upstream result out: run ``ifunc`` at every peer in
        ``at``.  ``binds`` gives each branch its own bind spec (e.g. a
        per-shard static arg); ``bind`` is the shared fallback.  Must be
        followed by :meth:`gather`."""
        if not at:
            raise D.FlowError("scatter needs at least one branch peer")
        if binds is not None and len(binds) != len(at):
            raise D.FlowError("binds must match the branch peers 1:1")
        self._ops.append(("scatter", ifunc, list(at), bind, binds, est_bytes))
        return self

    def gather(self, ifunc: str, at: str, *,
               bind: dict | None = None) -> "Flow":
        """Join the preceding scatter: branch results accumulate at ``at``
        and ``ifunc`` reduces them in one shot (payload = chunk-framed
        branch results, see ``tasks.wire.pack_chunks``)."""
        self._ops.append(("gather", ifunc, at, bind))
        return self

    def compile(self, engine: "FlowEngine") -> tuple:
        """Lower to descriptor entries, resolving candidate peers via hop
        pricing and pinning every hop to its library digest."""
        entries: list = []
        prev = engine.ctx.name
        ops = list(self._ops)
        i = 0
        while i < len(ops):
            op = ops[i]
            if op[0] == "stage":
                _, ifunc, at, bind, est = op
                peer = engine.pick_peer(prev, at, est)
                entries.append(D.Hop(peer, ifunc, engine.digest_of(ifunc),
                                     bind))
                prev = peer
            elif op[0] == "scatter":
                _, ifunc, at, bind, binds, est = op
                if i + 1 >= len(ops) or ops[i + 1][0] != "gather":
                    raise D.FlowError("scatter must be followed by a gather")
                digest = engine.digest_of(ifunc)
                branches = tuple(
                    D.Hop(p, ifunc, digest,
                          binds[j] if binds is not None else bind)
                    for j, p in enumerate(at))
                entries.append(D.Scatter(branches))
                _, g_ifunc, g_at, g_bind = ops[i + 1]
                # u16 wire field; uniqueness only matters within one corr
                engine._gid = (engine._gid % 0xFFFF) + 1
                entries.append(D.Hop(g_at, g_ifunc,
                                     engine.digest_of(g_ifunc), g_bind,
                                     gid=engine._gid, kind=D.KIND_GATHER))
                prev = g_at
                i += 1                  # the gather op is consumed here
            else:
                raise D.FlowError("gather without a preceding scatter")
            i += 1
        if not entries:
            raise D.FlowError("empty flow")
        return tuple(entries)


class FlowEngine:
    """Nodes + return rings + futures + the progress crank."""

    def __init__(self, ctx: Context, *, engine: ProgressEngine | None = None,
                 default_timeout: float | None = 60.0,
                 n_slots: int = 8, slot_size: int = 64 << 10,
                 coalesce: bool = False, obs: Obs | None = None):
        self.ctx = ctx
        self.pe = engine if engine is not None else ProgressEngine(
            flush_threshold=8, inflight_window="trailer")
        #: ONE obs bundle for the whole flow topology: every node's
        #: dispatcher and context share it, so one Perfetto export shows
        #: the chain hopping across the peers' swimlanes
        self.obs = obs if obs is not None else Obs("flow")
        if getattr(self.pe, "obs", None) is None:
            self.pe.obs = self.obs
        self.default_timeout = default_timeout
        #: coalesced forwarding: every node's dispatcher aggregates
        #: cache-warm continuation forwards (frame v2.3 FLAG_AGG), so a
        #: scatter's branches through one downstream peer share a frame
        self.coalesce = coalesce
        self.nodes: dict[str, FlowNode] = {}
        self.returns: dict[str, dict] = {}   # node -> {mb, ch, tail}
        self.libraries: dict[bytes, object] = {}   # digest -> IfuncLibrary:
        # the digest-addressed code registry forwarding nodes resolve hop
        # digests from (a fresh module load is NOT byte-deterministic —
        # marshal interning — so the compiled version is canonical)
        self.futures: dict[int, Future] = {}
        self._corr = 0
        self._gid = 0
        #: per-live-chain progress records for elastic replay: corr ->
        #: {entries, entry_ops, remaining, value, node} — updated by every
        #: node's continue_chain (branch arrivals excluded: a branch result
        #: in flight is not chain-level progress), consumed by
        #: :meth:`on_peer_death` to replay from the last completed stage
        self._chains: dict[int, dict] = {}
        self.stats = {"submitted": 0, "completed": 0, "errors": 0,
                      "orphan_replies": 0, "reply_rejects": 0,
                      "replays": 0, "replay_failed": 0}
        self.obs.metrics.register_dict("flow", self.stats)
        # the origin is a node like any other, so chains may route through
        # (or even end at) the submitting host; its 'fabric' to itself is
        # the loopback bus
        from repro_torch.transport import LoopbackFabric

        self.origin = self.add_node(ctx.name, LoopbackFabric(), ctx,
                                    n_slots=n_slots, slot_size=slot_size)

    # -- topology -----------------------------------------------------------

    def add_node(self, name: str, fabric, ctx: Context | None = None, *,
                 n_slots: int = 8, slot_size: int = 64 << 10) -> FlowNode:
        if name in self.nodes:
            raise TransportError(f"flow node {name!r} already attached")
        if fabric.kind == "device":
            raise TransportError(
                "device-mesh peers cannot join a flow: the compiled sweep "
                "has no continuation hook (host tiers only)")
        if ctx is None:
            ctx = Context(name, lib_dir=self.ctx.lib_dir,
                          device=self.ctx.device)
        if getattr(ctx, "obs", None) is None:
            ctx.obs = self.obs      # target-side exec/sweep metrics land
            #                         in the same bundle as the chain spans
        node = FlowNode(self, name, ctx, fabric,
                        n_slots=n_slots, slot_size=slot_size)
        self.nodes[name] = node
        # the node's return path: a source-owned ring the node's final-hop
        # replies land in, over the node's own fabric
        mb = fabric.open_mailbox(self.ctx, n_slots, slot_size)
        ch = fabric.connect(ctx, mb)
        self.returns[name] = {"mb": mb, "ch": ch, "tail": 0}
        return node

    # -- compile-time helpers ----------------------------------------------

    def digest_of(self, ifunc: str) -> bytes:
        """The library digest every hop is pinned to (loaded once at the
        origin, published in the digest-addressed registry forwarding
        nodes resolve hops from)."""
        h = self.ctx.handles.get(ifunc)
        if h is None:
            h = register_ifunc(self.ctx, ifunc)
        self.libraries[h.digest] = h.lib
        return h.digest

    def pick_peer(self, prev: str, at, est_bytes: int) -> str:
        """Resolve a stage's placement: a single name passes through; a
        candidate list is priced from the upstream node's dispatcher
        (wire model + live queue depth) and the cheapest hop wins."""
        if isinstance(at, str):
            if at not in self.nodes:
                raise D.FlowError(f"unknown flow node {at!r}")
            return at
        if not at:
            raise D.FlowError("empty candidate list")
        src = self.nodes[prev]
        for cand in at:
            if cand not in self.nodes:
                raise D.FlowError(f"unknown flow node {cand!r}")
            src.ensure_peer(cand)
        return min(at, key=lambda c: src.pricer.hop_cost(c, est_bytes))

    # -- submission ---------------------------------------------------------

    def submit(self, flow: Flow, args) -> Future:
        """Compile + launch: the initial ``args`` play the role of a
        virtual stage-zero result at the origin, so the first entry (hop
        or scatter) forwards exactly like any mid-chain continuation."""
        entries = flow.compile(self)
        self._corr += 1
        corr = self._corr
        first = entries[0]
        peer = (first.peer if isinstance(first, D.Hop)
                else "+".join(b.peer for b in first.branches))
        fut = Future(self, corr, peer, flow.label)
        self.futures[corr] = fut
        # the replay record: compiled entries align 1:1 with the Flow's
        # ops (stage -> Hop, scatter -> Scatter, gather -> gather Hop), so
        # a re-route can recover a dead stage's *candidate list* from the
        # op its entry was compiled from
        self._chains[corr] = {
            "entries": entries, "entry_ops": tuple(flow._ops),
            "remaining": entries, "value": args, "node": self.ctx.name}
        self.stats["submitted"] += 1
        tr = self.obs.tracer
        sp = None
        if tr.enabled:
            # the chain's end-to-end span on the origin lane; each hop's
            # stage spans (cat "flow", same corr) nest across peer lanes
            sp = tr.begin(f"chain:{flow.label}", cat="chain",
                          actor=self.ctx.name, corr=corr,
                          route=peer, stages=len(entries))

            def _close(f, _sp=sp, _tr=tr):
                if _sp.dur is None:
                    _tr.end(_sp, state=f.state.name)
            fut.add_done_callback(_close)
        try:
            self.origin.continue_chain(D.Chain(self.ctx.name, corr, entries),
                                       args)
        except BaseException:
            self.futures.pop(corr, None)
            if sp is not None and sp.dur is None:
                tr.end(sp, state="SUBMIT_ERROR")
            raise
        return fut

    # -- reply path (origin side) -------------------------------------------

    def post_reply(self, node: FlowNode, chain: D.Chain, value, *,
                   is_err: bool, hop: str | None = None) -> None:
        """Called by a node whose chain finished (or died): pack the value
        into a FLAG_REPLY frame on the node's return ring.  The origin can
        always drain its own inbox, so a full ring drains inline."""
        ent = self.returns[node.name]
        mb = ent["mb"]
        try:
            payload = (wire.encode_error(value, hop=hop) if is_err
                       else wire.encode(value))
        except Exception as e:          # unencodable result: the error IS it
            payload, is_err = wire.encode_error(e, hop=hop), True
        if ent["tail"] - mb.consumed >= mb.n_slots:
            self._drain_returns()
        name = ("flow:" + node.name)[:F.NAME_LEN - 1]
        frame = F.pack_reply(name, payload, F.CodeKind.PYBC, chain.corr,
                             err=is_err)
        if len(frame) > mb.slot_size:   # oversized value: error reply
            frame = F.pack_reply(
                name, wire.encode_error(
                    wire.WireError(f"flow reply {len(frame)}B exceeds "
                                   f"return slot {mb.slot_size}B"), hop=hop),
                F.CodeKind.PYBC, chain.corr, err=True)
        self.pe.post(ent["ch"], frame, ent["tail"], peer=node.name)
        ent["tail"] += 1

    def _drain_returns(self) -> int:
        n = 0
        for name, ent in self.returns.items():
            mb = ent["mb"]
            self.pe.flush(ent["ch"])
            while True:
                buf = mb.slot_view(mb.head)
                try:
                    hdr = F.peek_header(buf)
                except F.FrameError:
                    F.scrub_slot(buf)
                    mb.head += 1
                    mb.consumed += 1
                    self.stats["reply_rejects"] += 1
                    continue
                if hdr is None or not F.trailer_arrived(buf, hdr):
                    break
                payload = bytes(F.frame_sections(buf, hdr)[1])
                corr, is_err = hdr.corr_id, hdr.is_err
                F.clear_frame(buf, hdr)
                mb.head += 1
                mb.consumed += 1
                self._resolve(corr, payload, is_err)
                n += 1
        return n

    def _resolve(self, corr: int, payload: bytes, is_err: bool) -> None:
        fut = self.futures.pop(corr, None)
        if fut is None:                 # duplicate / cancelled chain
            self.stats["orphan_replies"] += 1
            return
        self._cleanup(corr)
        try:
            value = wire.decode(payload)
        except Exception as e:          # corrupt reply: resolve, don't crash
            fut.set_exception(e)
            self.stats["errors"] += 1
            return
        if is_err or isinstance(value, wire.RemoteExecutionError):
            if not isinstance(value, BaseException):
                value = wire.RemoteExecutionError("RemoteError", str(value))
            fut.set_exception(value)
            self.stats["errors"] += 1
        else:
            fut.set_result(value)
            self.stats["completed"] += 1

    def _cleanup(self, corr: int) -> None:
        """Drop gather state a resolved (or failed) chain left behind — an
        error short-circuit races its sibling branches, which may still be
        rendezvousing at the gather peer."""
        self._chains.pop(corr, None)
        for node in self.nodes.values():
            for key in [k for k in node.gathers if k[0] == corr]:
                del node.gathers[key]

    # -- elastic replay ------------------------------------------------------

    def note_progress(self, corr: int, remaining, value, node_name: str
                      ) -> None:
        """Record a chain's last completed stage: ``remaining`` is the
        entry suffix still to run, ``value`` the result in hand at
        ``node_name``.  Called from every node's ``continue_chain``."""
        st = self._chains.get(corr)
        if st is not None:
            st["remaining"] = tuple(remaining)
            st["value"] = value
            st["node"] = node_name

    @staticmethod
    def _touches(entries, dead: str) -> bool:
        for e in entries:
            if isinstance(e, D.Scatter):
                if any(b.peer == dead for b in e.branches):
                    return True
            elif e.peer == dead:
                return True
        return False

    def _recompile(self, st: dict, dead: str) -> tuple:
        """Rebuild a chain's remaining entries with ``dead`` excluded.
        A multi-candidate stage re-prices ``hop_cost`` over its surviving
        candidates (the dead hop now costs infinity everywhere anyway); a
        stage *pinned* to the dead peer, a scatter branch placed there, or
        a gather rendezvous there is semantic placement — the chain fails
        with the death instead of silently running somewhere else.
        Surviving gather entries get a fresh gid so branch results of the
        pre-death fan-out can never rendezvous with the replayed one."""
        entries, rem = st["entries"], st["remaining"]
        base = len(entries) - len(rem)
        out = []
        prev_peer = self.ctx.name
        for k, ent in enumerate(rem):
            op = st["entry_ops"][base + k]
            if isinstance(ent, D.Scatter):
                if any(b.peer == dead for b in ent.branches):
                    raise D.FlowError(
                        f"scatter branch placed at dead peer {dead!r}")
                out.append(ent)
                continue
            if ent.kind == D.KIND_GATHER:
                if ent.peer == dead:
                    raise D.FlowError(
                        f"gather rendezvous at dead peer {dead!r}")
                self._gid = (self._gid % 0xFFFF) + 1
                out.append(D.Hop(ent.peer, ent.ifunc, ent.digest, ent.bind,
                                 gid=self._gid, kind=D.KIND_GATHER))
                prev_peer = ent.peer
                continue
            if ent.peer != dead:
                out.append(ent)
                prev_peer = ent.peer
                continue
            _, ifunc, at, bind, est = op
            cands = [c for c in (at if isinstance(at, (list, tuple))
                                 else [at])
                     if c != dead and c in self.nodes]
            if not cands:
                raise D.FlowError(
                    f"stage {ifunc!r} pinned to dead peer {dead!r} "
                    f"(no surviving candidate)")
            peer = self.pick_peer(prev_peer, cands, est)
            out.append(D.Hop(peer, ent.ifunc, ent.digest, ent.bind))
            prev_peer = peer
        return tuple(out)

    def on_peer_death(self, dead: str) -> int:
        """Elastic recovery, flow side (driven by the ElasticController):
        retire the dead node and its lanes everywhere, then for every live
        chain whose *remaining* route touches the dead peer, re-route
        around it and replay from the last completed stage — the replayed
        frames reuse the normal forward path, so SLIM->NACK->FULL rebuild
        machinery covers any cache the survivors are missing.  Chains that
        cannot re-route (stage/scatter/gather pinned to the dead peer)
        fail their futures with a TransportError.  Returns chains
        replayed."""
        node = self.nodes.pop(dead, None)
        ret = self.returns.pop(dead, None)
        if ret is not None:
            self.pe.release_slab(ret["ch"])
        for nd in self.nodes.values():
            nd.dispatcher.remove_peer(dead)
            if nd.outbox:
                # deferred forwards to the dead peer: the chain record
                # still shows the pre-forward remaining, so the replay
                # below covers them — the queued copy would only duplicate
                nd.outbox = type(nd.outbox)(
                    e for e in nd.outbox if e[0] != dead)
        if node is not None:
            for pname in list(node.dispatcher.peers):
                node.dispatcher.remove_peer(pname)   # release its slabs
        replayed = 0
        for corr, st in list(self._chains.items()):
            fut = self.futures.get(corr)
            if fut is None or fut.done():
                self._chains.pop(corr, None)
                continue
            if not self._touches(st["remaining"], dead):
                continue                 # untouched chains keep running —
                #                          replaying them would double-run
            try:
                new = self._recompile(st, dead)
            except D.FlowError as e:
                self.futures.pop(corr, None)
                self._cleanup(corr)
                fut.set_exception(TransportError(
                    f"chain corr={corr}: peer {dead!r} died and the route "
                    f"cannot be rebuilt: {e}"))
                self.stats["errors"] += 1
                self.stats["replay_failed"] += 1
                continue
            # pre-death rendezvous state for this chain is unusable (fresh
            # gids); drop it, keep the chain record
            for nd in self.nodes.values():
                for key in [k for k in nd.gathers if k[0] == corr]:
                    del nd.gathers[key]
            done_prefix = len(st["entries"]) - len(st["remaining"])
            st["entries"] = st["entries"][:done_prefix] + new
            st["remaining"] = new
            self.stats["replays"] += 1
            replayed += 1
            self.origin.continue_chain(
                D.Chain(self.ctx.name, corr, new), st["value"])
        return replayed

    # -- progress -----------------------------------------------------------

    def progress(self) -> int:
        """One crank: retry deferred forwards, flush every node's pending
        puts, let every node's dispatcher execute + forward at its
        downstream targets, then drain final replies into futures."""
        n = 0
        for node in self.nodes.values():
            node.pump()
            for p in node.dispatcher.peers.values():
                node.dispatcher._flush_resends(p)
        self.pe.progress()
        for node in self.nodes.values():
            n += node.dispatcher.poll()
        n += self._drain_returns()
        return n

    def drain(self, max_rounds: int = 256) -> int:
        total = 0
        for _ in range(max_rounds):
            n = self.progress()
            total += n
            if (n == 0 and self.pe.outstanding() == 0
                    and not any(node.outbox or any(
                        p.resend or any(q.subs for q in p.coalesce.values())
                        for p in node.dispatcher.peers.values())
                        for node in self.nodes.values())):
                break
        return total

    def pending(self) -> int:
        return sum(1 for f in self.futures.values() if not f.done())

    def print_stats(self) -> None:
        for node in self.nodes.values():
            print(" ", node.summary())


__all__ = ["DEFAULT_EST_BYTES", "Flow", "FlowEngine"]
