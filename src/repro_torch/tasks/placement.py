"""Locality-aware placement: where should this task run?

The paper's motivating scenario — "large-scale irregular applications
(such as semantic graph analysis) ... it may be more efficient to
dynamically choose where code runs as the application progresses" — needs
three ingredients the transport layer alone does not have:

* a **data directory** mapping shard-id -> owning peer (plus replicas and
  a hotness trace), so the engine knows where the operands live;
* a **cost model** comparing, per task, *migrate-code-to-data* (ship the
  ifunc: code bytes — zero once the peer's link cache is SLIM-confirmed —
  plus argument bytes), *fetch-data-to-host* (pull the shard over the
  wire, run locally), and *run-local* (a replica is already resident);
* **live congestion feedback** from the dispatcher: per-peer queue depth
  (consumed credits + queued retransmits) weights every option — fetch
  requests ride the same rings, so they pay the toll of whichever replica
  holder serves them — and a backlogged owner organically loses tasks to
  replica-fetch/local execution (work stealing as a price signal), while
  :meth:`PlacementEngine.rebalance` migrates *ownership* of hot shards
  when the divergence persists.

The engine is workload-agnostic: ``chip_smoke.graph_workload`` (the
port's ``examples/graph_analysis.py``) drives it with delta-stepping
relax rounds over a sharded edge list.  It reads only the dispatcher's
live peer state — ``credits``, ``rings[*].mailbox.n_slots``, ``resend``,
``cached`` and ``fabric.kind`` — so its costs and decisions are the
reference's (``repro.tasks.placement``) on the same state.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

LOCAL_SITE = "local"        # directory name for the source process itself

#: per-fabric wire model (bytes/s, per-message seconds) — relative weights
#: matter, absolute values are the emulation's knobs
FABRIC_BW = {"rdma": 2e9, "loopback": 8e9, "device": 1e9, None: 2e9}
FABRIC_LAT = {"rdma": 10e-6, "loopback": 2e-6, "device": 50e-6, None: 10e-6}


class Decision(enum.Enum):
    MIGRATE = "migrate"      # ship the ifunc to the shard's owner
    FETCH = "fetch"          # pull the shard to the source, run there
    LOCAL = "local"          # a local replica exists: no wire at all


@dataclass
class Placement:
    decision: Decision
    shard: int
    peer: str | None         # owner peer for MIGRATE/FETCH; None for LOCAL
    costs: dict              # decision-name -> modeled seconds
    stolen: bool = False     # queue pressure overrode the locality choice


@dataclass
class Shard:
    sid: int
    owner: str
    nbytes: int
    replicas: set = field(default_factory=set)   # sites holding a copy
    hotness: float = 0.0                         # decayed touch count


class DataDirectory:
    """shard-id -> placement metadata.  The single source of truth the
    engine, the runtime, and the workload all consult."""

    def __init__(self):
        self.shards: dict[int, Shard] = {}
        self.moves: list[tuple[int, str, str]] = []   # (sid, from, to) log

    def register(self, sid: int, owner: str, nbytes: int) -> Shard:
        sh = Shard(sid, owner, nbytes, replicas={owner})
        self.shards[sid] = sh
        return sh

    def lookup(self, sid: int) -> Shard:
        return self.shards[sid]

    def owner(self, sid: int) -> str:
        return self.shards[sid].owner

    def owned_by(self, site: str) -> list[int]:
        return [s.sid for s in self.shards.values() if s.owner == site]

    def add_replica(self, sid: int, site: str) -> None:
        self.shards[sid].replicas.add(site)

    def drop_replica(self, sid: int, site: str) -> None:
        self.shards[sid].replicas.discard(site)

    def has_local(self, sid: int) -> bool:
        return LOCAL_SITE in self.shards[sid].replicas

    def move(self, sid: int, new_owner: str) -> None:
        """Ownership migration (the work-stealing outcome).  The caller is
        responsible for actually shipping the shard's data first."""
        sh = self.shards[sid]
        self.moves.append((sid, sh.owner, new_owner))
        sh.owner = new_owner
        sh.replicas.add(new_owner)

    def touch(self, sid: int, weight: float = 1.0) -> None:
        self.shards[sid].hotness += weight

    def decay(self, factor: float = 0.5) -> None:
        for sh in self.shards.values():
            sh.hotness *= factor


class PlacementEngine:
    """Per-task migrate / fetch / local decisions + ownership rebalance.

    ``directory=None`` builds a pure *hop pricer* over the dispatcher —
    the flow layer uses :meth:`hop_cost` to choose among candidate peers
    for each chain stage without any shard directory."""

    def __init__(self, directory: DataDirectory | None, dispatcher, *,
                 service_s: float = 50e-6, steal_depth: int = 3,
                 fabric_bw: dict | None = None,
                 fabric_lat: dict | None = None):
        self.dir = directory
        self.dispatcher = dispatcher
        self.service_s = service_s       # modeled per-queued-task service time
        self.steal_depth = steal_depth   # rebalance when depths diverge by this
        self.bw = dict(FABRIC_BW, **(fabric_bw or {}))
        self.lat = dict(FABRIC_LAT, **(fabric_lat or {}))
        self.stats = {"migrate": 0, "fetch": 0, "local": 0,
                      "stolen": 0, "rebalances": 0}

    # -- congestion signals (live, from the dispatcher) ---------------------

    def queue_depth(self, peer_name: str) -> float:
        """Outstanding work at a peer: consumed ring credits + queued
        NACK retransmits.  A striped peer drains its backlog ``width``
        rings at a time, so its *effective* depth — the wait a new task
        actually sees — is the consumed-credit count divided by the
        stripe width; retransmits stay unscaled (the resend queue is
        per-peer FIFO regardless of striping)."""
        p = self.dispatcher.peers[peer_name]
        total = sum(r.mailbox.n_slots for r in p.rings)
        width = len(p.rings) if getattr(p, "stripe", False) else 1
        return (total - p.credits) / width + len(p.resend)

    def _wire(self, peer_name: str, nbytes: int) -> float:
        kind = self.dispatcher.peers[peer_name].fabric.kind
        return self.lat.get(kind, self.lat[None]) + nbytes / self.bw.get(
            kind, self.bw[None])

    def hop_cost(self, peer_name: str, nbytes: int) -> float:
        """Modeled seconds for one hop carrying ``nbytes`` to a peer:
        fabric wire time plus the toll of everything already queued there.
        The one formula every decision below — and the flow compiler's
        per-stage candidate pricing — is built from.  A peer the
        dispatcher no longer knows (retired by elastic recovery between
        compile and re-price) costs infinity: the dead hop loses every
        candidate comparison instead of KeyErroring the re-route."""
        if peer_name not in self.dispatcher.peers:
            return float("inf")
        return (self._wire(peer_name, nbytes)
                + self.queue_depth(peer_name) * self.service_s)

    def _code_bytes(self, peer_name: str, handle) -> int:
        """Marginal code cost of migrating to this peer: zero once the
        peer's link cache is SLIM-confirmed for the handle's digest (or the
        peer is a device lane, which links at mailbox-open time)."""
        p = self.dispatcher.peers[peer_name]
        if p.fabric.kind == "device":
            return 0
        lib = handle.lib
        return 0 if lib.code_digest in p.cached else len(lib.code)

    # -- the decision -------------------------------------------------------

    def decide(self, sid: int, handle, arg_bytes: int, *,
               reply_bytes: int = 256) -> Placement:
        """Choose where one task over shard ``sid`` runs.  ``arg_bytes`` is
        the operand payload the task would carry if migrated (for graph
        relax: the frontier slice); the shard's own size and the live queue
        depths come from the directory and dispatcher."""
        sh = self.dir.lookup(sid)
        owner = sh.owner
        self.dir.touch(sid)
        costs: dict[str, float] = {}
        # migrate: code (amortized by SLIM) + args out + reply back, queued
        # behind everything already sitting in the owner's rings
        costs["migrate"] = self.hop_cost(
            owner, self._code_bytes(owner, handle) + arg_bytes + reply_bytes)
        # fetch: the whole shard crosses the wire once, from the cheapest
        # replica holder — the fetch request rides the same rings as a
        # migrated task, so it pays that peer's queue toll too
        def fetch_cost(site: str) -> float:
            return self.hop_cost(site, sh.nbytes + arg_bytes)

        sources = [s for s in sh.replicas if s in self.dispatcher.peers]
        fetch_src = min(sources, key=fetch_cost) if sources else None
        if fetch_src is not None:
            costs["fetch"] = fetch_cost(fetch_src)
        # local: free wire — only on the table when a replica is resident
        if self.dir.has_local(sid):
            costs["local"] = 0.0
        best = min(costs, key=costs.get)
        decision = Decision(best)
        # steal detection: locality said migrate, congestion said otherwise
        stolen = False
        if decision is not Decision.MIGRATE:
            uncongested = (costs["migrate"]
                           - self.queue_depth(owner) * self.service_s)
            if uncongested < min(c for k, c in costs.items()
                                 if k != "migrate"):
                stolen = True
                self.stats["stolen"] += 1
        self.stats[best] += 1
        peer = {"migrate": owner, "fetch": fetch_src, "local": None}[best]
        return Placement(decision, sid, peer, costs, stolen=stolen)

    # -- ownership rebalance (persistent divergence) ------------------------

    def rebalance(self, eligible: list | None = None) -> list[tuple[int, str, str]]:
        """When one peer's queue depth diverges from the idlest peer's by
        ``steal_depth`` or more, move its hottest shard to the idle peer.
        Returns the (sid, from, to) moves; the caller ships the data and
        re-seeds the new owner's shard store before the next round.
        ``eligible`` restricts candidate owners (e.g. host peers only — a
        device mesh cannot own a host-tier edge shard)."""
        peers = [p for p in self.dispatcher.peers
                 if eligible is None or p in eligible]
        if len(peers) < 2:
            return []
        depths = {p: self.queue_depth(p) for p in peers}
        hot = max(peers, key=depths.get)
        cold = min(peers, key=depths.get)
        if depths[hot] - depths[cold] < self.steal_depth or hot == cold:
            return []
        owned = self.dir.owned_by(hot)
        if not owned:
            return []
        sid = max(owned, key=lambda s: self.dir.lookup(s).hotness)
        self.dir.move(sid, cold)
        self.stats["rebalances"] += 1
        return [(sid, hot, cold)]


__all__ = ["DataDirectory", "Decision", "LOCAL_SITE", "Placement",
           "PlacementEngine", "Shard"]
