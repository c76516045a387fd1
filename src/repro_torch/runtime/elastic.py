"""Elastic fleet membership, heartbeats, straggler detection & mitigation.

Policy layer for 1000+-node runs (the mechanisms the multi-pod launcher
invokes between steps):

* heartbeats + deadline -> dead-worker detection; data shards of dead
  workers are reassigned round-robin to survivors (deterministic, so every
  survivor computes the same assignment without coordination);
* per-step duration tracking -> straggler flagging (median + k·MAD rule)
  and backup-task dispatch (Dean-style duplicate work for the tail);
* on membership change the runner restores the latest checkpoint (see
  CheckpointManager.restore; a restore onto a new mesh comes with the
  parallel layer) — the control messages themselves travel as ifuncs
  (runtime/controller.py).

:class:`ElasticController` is the transport half: heartbeats become
``hb_beat`` ifuncs on a dedicated per-member control ring, driven off the
dispatcher poll loop, and a missed deadline fires the full recovery path
— scoped ``fail_inflight`` (futures resolve instead of hanging), peer
retirement, deterministic shard reassignment, flow re-route/replay, a
generation bump that fences the dead peer's stale replies, and a one-frame
LinkCache manifest restore at re-admission.  See ARCHITECTURE.md
"Elastic recovery".
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field


@dataclass
class WorkerInfo:
    worker_id: str
    last_heartbeat: float = 0.0
    alive: bool = True
    step_times: list[float] = field(default_factory=list)
    backup_of: str | None = None


class FleetState:
    def __init__(self, workers: list[str], heartbeat_deadline: float = 30.0):
        self.workers = {w: WorkerInfo(w) for w in workers}
        self.deadline = heartbeat_deadline
        self.generation = 0            # bumps on every membership change

    # -- membership ---------------------------------------------------------
    def heartbeat(self, worker_id: str, now: float) -> None:
        w = self.workers.get(worker_id)
        if w is None or not w.alive:
            # late join OR revival: either way the worker gets a FRESH
            # WorkerInfo — step_times/backup_of from a previous life used
            # to survive a restart and leak into the straggler math
            self.workers[worker_id] = w = WorkerInfo(worker_id)
            self.generation += 1
        w.last_heartbeat = now

    def sweep_dead(self, now: float) -> list[str]:
        dead = []
        for w in self.workers.values():
            if w.alive and now - w.last_heartbeat > self.deadline:
                w.alive = False
                dead.append(w.worker_id)
        if dead:
            self.generation += 1
        return dead

    def alive(self) -> list[str]:
        return sorted(w.worker_id for w in self.workers.values() if w.alive)

    # -- deterministic shard reassignment ------------------------------------
    def shard_assignment(self, n_shards: int) -> dict[str, list[int]]:
        """Round-robin data-shard ownership over live workers; every worker
        computes this identically from (generation, membership)."""
        live = self.alive()
        if not live:
            return {}
        out = {w: [] for w in live}
        for s in range(n_shards):
            out[live[s % len(live)]].append(s)
        return out


class StragglerMitigator:
    """Median + k·MAD outlier rule over recent step durations."""

    def __init__(self, window: int = 32, k: float = 4.0, min_samples: int = 8):
        self.window, self.k, self.min_samples = window, k, min_samples
        self.times: dict[str, list[float]] = {}

    def record(self, worker_id: str, step_s: float) -> None:
        t = self.times.setdefault(worker_id, [])
        t.append(step_s)
        del t[:-self.window]

    def stragglers(self) -> list[str]:
        last = {w: t[-1] for w, t in self.times.items() if t}
        if len(last) < self.min_samples:
            return []
        med = statistics.median(last.values())
        mad = statistics.median(abs(v - med) for v in last.values()) or 1e-9
        return sorted(w for w, v in last.items() if v > med + self.k * mad)

    def backup_plan(self, n_shards: int, fleet: FleetState) -> dict[str, int]:
        """Assign each straggler's current shard *also* to the fastest
        non-straggler (duplicate dispatch; first result wins)."""
        strag = set(self.stragglers())
        if not strag:
            return {}
        speed = sorted((t[-1], w) for w, t in self.times.items()
                       if w not in strag and t)
        plan = {}
        assign = fleet.shard_assignment(n_shards)
        fast = [w for _, w in speed]
        for i, s in enumerate(sorted(strag)):
            if i < len(fast) and assign.get(s):
                plan[fast[i]] = assign[s][0]
        return plan


@dataclass
class _Member:
    """One watched peer's control-ring state (heartbeat side-band)."""

    name: str
    fabric: object
    ctx: object                 # the member's target context
    mailbox: object             # control ring (opened on the member ctx)
    channel: object             # source -> member path into it
    targs: dict                 # sweep target_args; hb_beat writes ["hb"]
    tail: int = 0               # next control-ring produce slot
    seq: int = 0                # beat sequence (monotone per admission)
    folded: int = 0             # beats already folded into FleetState
    last_beat: float = -1e18    # when the last beat was pumped
    active: bool = True         # False once death recovery ran: the record
    #                             stays (its manifest seeds a readmit) but
    #                             the ring is never pumped or swept again —
    #                             a post-mortem sweep executing a queued
    #                             beat must not auto-revive the worker
    manifest: list = field(default_factory=list)   # (name, digest) snapshot
    #                             of the peer's warm LinkCache, taken at
    #                             death for the re-admission restore


class ElasticController:
    """Wire :class:`FleetState` into the live transport.

    Heartbeats are small ``hb_beat`` ifuncs on a dedicated control ring
    per watched member — NOT dispatcher data traffic, so a data-plane
    backlog can't starve liveness, and a wedged member is visible as
    control frames that stop executing.  The controller rides
    ``Dispatcher.pollers``: every ``poll()`` turn pumps due beats, sweeps
    control mailboxes (a sweep that executes a beat IS the liveness
    proof), folds them into ``FleetState.heartbeat``, and runs
    ``sweep_dead``.  A missed deadline fires the recovery path:

    1. snapshot the peer's warm-cache manifest (for a later re-admission),
    2. ``fail_inflight(peers={name})`` — the dead peer's futures resolve
       with TransportError; every other peer's in-flight work is untouched,
    3. ``remove_peer`` — credits, queues, stripe state, obs alias released,
    4. deterministic shard reassignment of the dead peer's directory
       shards to survivors + a ``PlacementEngine.rebalance`` pass,
    5. flow re-route/replay via ``FlowEngine.on_peer_death`` (multi-
       candidate stages re-price ``hop_cost`` around the dead hop),
    6. ``runtime.generation`` takes the new fleet generation, so corr_ids
       allocated from here on are distinguishable from the dead epoch's.

    ``readmit`` is the inverse: fresh WorkerInfo (generation bump), fresh
    peer + control ring, ``peer.fence`` stamped with the new generation
    (stale-generation replies drop as ``fenced_orphans``), and ONE
    manifest frame that warm-restores the member's LinkCache — zero
    NACK_UNCACHED on the first SLIM wave after re-admission.
    """

    def __init__(self, runtime, fleet: FleetState, *, placement=None,
                 flow=None, injector=None, lib_dir=None,
                 beat_interval: float | None = None,
                 n_slots: int = 4, slot_size: int = 2048,
                 auto_poll: bool = True):
        from repro_torch.core import api as A

        self.runtime = runtime
        self.fleet = fleet
        self.placement = placement
        self.flow = flow
        self.injector = injector
        self.dispatcher = runtime.dispatcher
        self.obs = self.dispatcher.obs
        # a beat every deadline/3 keeps two chances to observe liveness
        # inside one deadline window even if a single beat is lost
        self.beat_interval = (fleet.deadline / 3.0 if beat_interval is None
                              else beat_interval)
        self.n_slots = n_slots
        self.slot_size = slot_size
        self._hb = A.register_ifunc(
            runtime.ctx, "hb_beat",
            lib_dir if lib_dir is not None else runtime.ctx.lib_dir)
        self.members: dict[str, _Member] = {}
        self.on_death: list = []     # callables(name) after recovery ran
        self.stats = {"beats_sent": 0, "beats_folded": 0, "beats_skipped": 0,
                      "deaths": 0, "readmissions": 0, "manifest_entries": 0,
                      "futures_failed": 0, "shards_moved": 0}
        self.obs.metrics.register_dict("elastic", self.stats)
        if injector is not None:
            self.dispatcher.faults = injector
        if auto_poll:
            self.dispatcher.pollers.append(self.step)

    # -- membership ---------------------------------------------------------

    def watch(self, name: str, fabric, target_ctx,
              target_args: dict | None = None,
              now: float | None = None) -> _Member:
        """Open a control ring to ``name`` and start heartbeating it.  The
        ring lives on the member's context like any data mailbox, but the
        controller pumps and sweeps it directly — dispatcher credits,
        coalescing, and striping never touch it."""
        now = time.monotonic() if now is None else now
        mb = fabric.open_mailbox(target_ctx, self.n_slots, self.slot_size)
        ch = fabric.connect(self.runtime.ctx, mb)
        targs = dict(target_args) if target_args else {}
        m = _Member(name, fabric, target_ctx, mb, ch, targs)
        self.members[name] = m
        self.fleet.heartbeat(name, now)      # admission = first heartbeat
        return m

    def unwatch(self, name: str) -> None:
        m = self.members.pop(name, None)
        if m is not None:
            self.dispatcher.engine.release_slab(m.channel)

    # -- the poll-loop hook --------------------------------------------------

    def step(self, now: float | None = None) -> list[str]:
        """One liveness turn: pump due beats, sweep control mailboxes,
        fold executed beats into FleetState, sweep the deadline.  Runs on
        every ``Dispatcher.poll`` (via ``pollers``); ``now`` is explicit
        for deterministic tests.  Returns the names recovery fired for."""
        now = time.monotonic() if now is None else now
        inj = self.injector
        for m in list(self.members.values()):
            if not m.active:
                continue
            down = inj is not None and inj.is_down(m.name)
            if not down and now - m.last_beat >= self.beat_interval:
                if inj is not None and inj.should_drop_beat(m.name):
                    m.last_beat = now    # the beat left the source and
                    self.stats["beats_skipped"] += 1   # vanished: next one
                    #                      waits a full interval, as it would
                else:
                    self._pump_beat(m, now)
            if down:
                continue                 # dead progress side: frames sit
            m.mailbox.sweep(m.ctx, m.targs, budget=self.n_slots)
            beats = m.targs.get("hb", {}).get("beats", 0)
            if beats > m.folded:         # ONLY an executed beat proves life
                self.stats["beats_folded"] += beats - m.folded
                m.folded = beats
                self.fleet.heartbeat(m.name, now)
        dead = self.fleet.sweep_dead(now)
        for name in dead:
            self._on_death(name)
        return dead

    def _pump_beat(self, m: _Member, now: float) -> None:
        from repro_torch.core import api as A

        credits = m.mailbox.n_slots - (m.tail - m.mailbox.consumed)
        if credits <= 0:
            return                       # ring full of unexecuted beats —
            #                              itself a death signal; don't wedge
        m.seq += 1
        msg = A.ifunc_msg_create(self._hb, {"worker": m.name, "seq": m.seq})
        eng = self.dispatcher.engine
        slab = eng.slab_slot(m.channel, m.tail)
        n = len(msg.frame)
        slab[:n] = msg.frame
        eng.post(m.channel, slab[:n], m.tail, peer=f"hb:{m.name}")
        eng.flush(m.channel)
        m.tail += 1
        m.last_beat = now
        self.stats["beats_sent"] += 1

    # -- failure path --------------------------------------------------------

    def _on_death(self, name: str) -> None:
        d = self.dispatcher
        self.stats["deaths"] += 1
        self.obs.record("peer_death", name,
                        f"heartbeat deadline {self.fleet.deadline}s exceeded")
        m = self.members.get(name)
        peer = d.peers.get(name)
        if peer is not None and m is not None:
            # snapshot the warm-cache manifest NOW (remove_peer drops it):
            # digest -> ifunc name via the source's handle table
            by_digest = {h.digest: n
                         for n, h in self.runtime.ctx.handles.items()}
            m.manifest = sorted(
                (by_digest[dg], dg) for dg in peer.cached if dg in by_digest)
        if m is not None:
            m.active = False
            d.engine.release_slab(m.channel)
        failed = d.fail_inflight(
            f"peer {name!r} missed its heartbeat deadline",
            peers={name})
        self.stats["futures_failed"] += failed
        d.remove_peer(name)
        # the fleet generation already bumped in sweep_dead; corr_ids
        # allocated from here on carry the post-death epoch
        self.runtime.generation = self.fleet.generation
        if self.placement is not None:
            self._reassign_shards(name)
        if self.flow is not None:
            self.flow.on_peer_death(name)
        for cb in tuple(self.on_death):
            cb(name)

    def _reassign_shards(self, dead: str) -> None:
        """Move the dead peer's directory shards to survivors with the
        same deterministic round-robin every survivor would compute from
        (generation, membership) — then let the work-stealing rebalance
        smooth any residual skew."""
        pl = self.placement
        alive = set(self.fleet.alive())
        survivors = sorted(n for n in self.dispatcher.peers if n in alive)
        if not survivors:
            return
        owned = sorted(pl.dir.owned_by(dead))
        for i, sid in enumerate(owned):
            pl.dir.move(sid, survivors[i % len(survivors)])
            self.stats["shards_moved"] += 1
        if owned:
            pl.rebalance(eligible=survivors)

    # -- re-admission --------------------------------------------------------

    def readmit(self, name: str, fabric, target_ctx, *,
                target_args: dict | None = None, warm: bool = True,
                now: float | None = None, **add_peer_kw):
        """Bring a restarted peer back: fresh WorkerInfo + generation bump,
        fresh data peer + reply ring, generation fence against its previous
        life's replies, fresh control ring, and (``warm``) the one-frame
        LinkCache manifest restore.  ``target_args`` is the *data* peer's
        sweep state (as in ``add_peer``); the control ring keeps its own."""
        now = time.monotonic() if now is None else now
        if self.injector is not None:
            self.injector.revive(name)
        self.fleet.heartbeat(name, now)      # fresh WorkerInfo, gen bump
        self.runtime.generation = self.fleet.generation
        peer = self.runtime.add_peer(name, fabric, target_ctx,
                                     target_args=target_args, **add_peer_kw)
        peer.fence = self.fleet.generation   # replies minted before this
        #                                      epoch are fenced orphans
        prev = self.members.get(name)     # the dead incarnation's record —
        m = self.watch(name, fabric, target_ctx, now=now)
        if prev is not None:              # its manifest snapshot carries over
            m.manifest = prev.manifest
        if warm and m.manifest:
            self._send_manifest(m, m.manifest)
            peer.cached.update(dg for _, dg in m.manifest)
        self.stats["readmissions"] += 1
        return peer

    def _send_manifest(self, m: _Member, manifest: list) -> None:
        """ONE control frame re-seeds the member's LinkCache: each entry
        relinks from the member's *local* library but is inserted under
        the manifest's digest — marshal serialization is not byte-stable
        across loads, and the digest on the wire is what the source's
        SLIM frames will carry."""
        from repro_torch.core import api as A
        from repro_torch.core import codegen as CG
        from repro_torch.core.frame import CodeKind
        from repro_torch.core.registry import IfuncLibrary

        ctx = m.ctx

        def relink(name: str, digest: bytes, _ctx=ctx) -> None:
            lib = IfuncLibrary.load(name, _ctx.lib_dir,
                                    hmac_key=_ctx.policy.hmac_key)
            if lib.kind != CodeKind.PYBC:
                return                   # device/HLO lanes link at
                #                          mailbox-open time, not here
            fn = CG.link_pybc(lib.code, _ctx.symbol_space,
                              hmac_key=_ctx.policy.hmac_key)
            _ctx.link_cache.insert(name, digest, fn)
            _ctx.stats["links"] += 1

        m.targs["relink"] = relink
        msg = A.ifunc_msg_create(self._hb, {"manifest": manifest})
        eng = self.dispatcher.engine
        slab = eng.slab_slot(m.channel, m.tail)
        n = len(msg.frame)
        if n > len(slab):
            raise ValueError(
                f"manifest frame {n}B exceeds control slot {len(slab)}B")
        slab[:n] = msg.frame
        eng.post(m.channel, slab[:n], m.tail, peer=f"hb:{m.name}")
        eng.flush(m.channel)
        m.tail += 1
        m.mailbox.sweep(m.ctx, m.targs, budget=self.n_slots)
        m.targs.pop("relink", None)
        self.stats["manifest_entries"] += len(manifest)
