"""Multi-peer ifunc dispatcher: N peers x M rings, credit-based flow
control, per-peer backpressure, and a fairness-aware poll loop.

A :class:`Dispatcher` owns any number of :class:`Peer` s — each a
(fabric, channel(s), mailbox(s), target context) bundle on any backend
(RDMA host, loopback, device mesh) — and

* ``send`` consumes a credit (one free ring slot) or reports backpressure
  instead of silently overwriting unconsumed frames;
* credits return as the target's sweep advances its mailbox ``consumed``
  counter (the credit-return counter a real target writes back);
* ``poll`` drains mailboxes round-robin, starting one past the lane served
  first last time, so a chatty peer cannot starve the rest;
* all sends go through a shared :class:`ProgressEngine`, so batching,
  in-flight windows, and completions are uniform across fabrics.

The cached-invocation fast path (paper §3.4):

* every frame is packed straight into the engine's slab cell for its ring
  slot — the send path allocates no per-message buffers;
* a host peer's first delivery of an ifunc ships a FULL frame; once the
  delivery is confirmed (the target's link cache provably holds the code
  digest) later sends of the same handle ship SLIM — header + payload,
  code elided;
* a SLIM frame that misses the target's cache (eviction, restart) comes
  back ``NACK_UNCACHED``: the dispatcher rebuilds the FULL frame from the
  handle's library and the slab-resident payload and resends it ahead of
  newer traffic, once the peer's rings are quiescent, so the resends
  replay ring order;
* device-mesh lanes are always SLIM-eligible: the μVM program is bound at
  mailbox-open time, so code words never travel.

*Coalesced dispatch* (``FLAG_AGG``): with :meth:`set_coalescing` on, a
cache-warm ``send_ifunc`` / ``send_ifunc_many`` to a host peer, or to a
device peer whose mailboxes are agg-bound (``agg_k=``), does not claim a
ring slot per invocation — the records pack into ONE aggregate container
(one put, one slot, one credit), flushed when the slot budget or the
sub-record cap fills, on an explicit ``flush``/``drain``, or when the
oldest record has waited ``max_age``.  A record above ``max_sub_bytes``
ships as a plain SLIM singleton after the queue ahead of it, so per-peer
FIFO holds.  The target reports per-sub-record outcomes
(``Mailbox.last_agg``): a NACKed record alone is rebuilt as a FULL
singleton on the resend queue (its siblings are never replayed), a
rejected one counts, and the corr-carrying records' results come back
coalesced too: ONE ``FLAG_AGG|FLAG_REPLY`` frame on the reply ring.

The result-return path (the task runtime's wire, see ``repro_torch.tasks``):

* a request carrying a nonzero ``corr_id`` asks for the ifunc's output
  back; a host peer gets a *reply ring* (a source-owned mailbox the target
  writes ``FLAG_REPLY`` frames into) through :meth:`attach_reply_ring`;
* the poll loop, executing a corr-carrying request at such a peer,
  captures ``target_args["result"]`` (or the exception the ifunc raised:
  the slot is consumed, not wedged) and posts it, encoded by the pluggable
  ``reply_codec``, as a reply frame with the same corr id;
  :meth:`poll_replies` drains the reply rings into ``reply_router``;
* device lanes have no reverse ring: sweep results *are* the replies,
  correlated to corr ids by the coordinates each send staged into;
* every tracked frame is timestamped, and ``drain(deadline=)`` fails the
  futures of frames stuck at a wedged peer (:meth:`fail_inflight`)
  instead of letting them hang.

Every peer's stats dict, the dispatcher's and the engine's are aliased
into one :class:`~repro_torch.obs.Obs` registry; puts, NACKs, resends,
rejects and backpressure land in its flight recorder, and with tracing on
each host frame's life is a ``wire`` span from put to poll outcome (a
resend its own ``resend`` span, a container its ``agg`` span).

Streams, wire codecs and striping; fault injection, side-band pollers and
peer removal raise :class:`TransportError` naming the ROADMAP.md item they
come with.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from repro_torch.core import frame as F
from repro_torch.core.api import (_AGG_PLAIN_OK, IfuncMsg, Status,
                                  ifunc_msg_to_full)
from repro_torch.obs import Obs
from repro_torch.transport.fabric import Fabric, TransportError
from repro_torch.transport.progress import ProgressEngine

DEFAULT_SLOT_SIZE = 64 << 10
DEFAULT_N_SLOTS = 8

#: the per-peer stats schema (the reference's, paths not ported yet
#: included), seeded at construction and by ``Peer.reset_stats`` so
#: ``per_peer_stats()`` always returns the same keys
_PEER_STAT_KEYS = (
    "sent", "bytes", "delivered", "rejected", "backpressure",
    "inflight_polls", "slim_sent", "nacks", "resent", "replies", "errors",
    "coalesced", "agg_sent", "agg_subs", "agg_replies", "agg_harvest_lost",
    "nack_lost", "reply_rejects", "streams", "stream_chunks", "timed_out",
    "fenced_orphans", "dropped_puts")


def _later(what: str, item: str) -> TransportError:
    return TransportError(f"{what}: not ported yet (ROADMAP.md Queue 1 "
                          f"item {item})")


@dataclass
class _TxRec:
    """Source-side record of one in-flight frame (digest confirmation,
    NACK rebuild, reply correlation, liveness age).  ``subs`` non-None
    marks an aggregate container: the :class:`_PendingSub` records it
    carries."""

    name: str
    digest: bytes
    handle: object          # IfuncHandle (None for raw-frame sends)
    slim: bool
    corr_id: int = 0
    sent_at: float = field(default_factory=time.monotonic)
    subs: list | None = None
    span: object = None     # open obs wire span (tracing runs only): put ->
    #                         delivery confirmation / NACK / reject


@dataclass(slots=True)
class _PendingSub:
    """One coalesced invocation awaiting (or riding) an aggregate: the
    payload plus what a FULL-singleton rebuild needs.  Its attributes are
    those of :class:`frame.AggSub`, so ``seal_agg_frame`` packs it
    directly."""

    handle: object
    name: str
    kind: object
    digest: bytes
    payload: object         # bytes, or a view into the slab cell it rides in
    corr_id: int
    cont: bytes | None      # always None: no flow hook is ported
    future: object          # the task runtime's Future, or None
    enq_at: float
    err: bool = False       # request records never carry the reply-err bit


class _CoalesceQ:
    """One (peer, ring)'s pending sub-records with an exact running byte
    count of the aggregate frame they would pack into."""

    __slots__ = ("subs", "names", "bytes")

    #: header + sub/name counts + aggregate signal + frame trailer
    BASE = F.HEADER_LEN + 4 + 4 + F.TRAILER_LEN

    def __init__(self):
        self.subs: list[_PendingSub] = []
        self.names: set[str] = set()
        self.bytes = self.BASE

    def would_take(self, sub: _PendingSub) -> int:
        extra = F.AGG_SUB_OVERHEAD + len(sub.payload)
        if sub.name not in self.names:
            # ifunc names are ASCII: len == byte length
            extra += 1 + len(sub.name)
        return self.bytes + extra

    def add(self, sub: _PendingSub) -> None:
        self.bytes = self.would_take(sub)
        self.names.add(sub.name)
        self.subs.append(sub)


@dataclass
class RingState:
    """One (mailbox, channel) lane of a peer."""

    mailbox: object
    channel: object
    tail: int = 0            # source-side produce index
    inflight: dict = field(default_factory=dict)   # host lanes: abs slot ->
    #                                    _TxRec awaiting its poll outcome
    corr_by_coords: dict = field(default_factory=dict)  # device lanes:
    #                                    slot_coords -> (corr_id, sent_at)
    #                                    of a singleton awaiting its result
    agg_by_coords: dict = field(default_factory=dict)   # device lanes:
    #                                    slot_coords -> _TxRec of a staged
    #                                    aggregate

    @property
    def credits(self) -> int:
        return self.mailbox.n_slots - (self.tail - self.mailbox.consumed)


@dataclass
class Peer:
    name: str
    fabric: Fabric
    target_ctx: object
    target_args: dict
    rings: list[RingState] = field(default_factory=list)
    cached: set = field(default_factory=set)       # digests confirmed cached
    resend: deque = field(default_factory=deque)   # FULL msgs queued post-NACK
    coalesce: dict = field(default_factory=dict)   # ring key -> _CoalesceQ
    reply_mailbox: object = None   # source-owned ring the target replies into
    reply_channel: object = None   # target->source path into it
    reply_tail: int = 0            # target-side produce index for replies
    fence: int = 0                 # generation fence: a reply whose corr was
    #                                allocated under an earlier generation
    #                                (corr_gen < fence) is dropped and counted
    #                                as fenced_orphans; 0 = never fenced
    stats: dict = field(
        default_factory=lambda: dict.fromkeys(_PEER_STAT_KEYS, 0))

    def reset_stats(self) -> None:
        """Zero every counter in place (the dict is aliased into the obs
        registry and shared with callers — never replace it)."""
        for k in _PEER_STAT_KEYS:
            self.stats[k] = 0

    @property
    def credits(self) -> int:
        return sum(r.credits for r in self.rings)

    @property
    def reply_credits(self) -> int:
        if self.reply_mailbox is None:
            return 0
        return self.reply_mailbox.n_slots - (self.reply_tail
                                             - self.reply_mailbox.consumed)

    def oldest_inflight_age(self, now: float | None = None) -> float:
        """Age (seconds) of the oldest tracked frame still awaiting its
        target's sweep; 0.0 when nothing is in flight."""
        now = time.monotonic() if now is None else now
        oldest = None
        for r in self.rings:
            for slot, rec in r.inflight.items():
                if slot < r.mailbox.consumed:
                    continue            # consumed by an external sweeper
                if oldest is None or rec.sent_at < oldest:
                    oldest = rec.sent_at
            for _, sent_at in r.corr_by_coords.values():
                if oldest is None or sent_at < oldest:
                    oldest = sent_at
            for rec in r.agg_by_coords.values():
                if oldest is None or rec.sent_at < oldest:
                    oldest = rec.sent_at
        return 0.0 if oldest is None else max(0.0, now - oldest)

    def summary(self) -> str:
        s = self.stats
        agg = (f" agg={s['agg_sent']}x{s['agg_subs'] / s['agg_sent']:.1f}"
               if s["agg_sent"] else "")
        return (f"{self.name:<12s} fabric={self.fabric.kind:<9s} "
                f"sent={s['sent']:<4d} slim={s['slim_sent']:<4d} "
                f"delivered={s['delivered']:<4d} "
                f"rejected={s['rejected']:<3d} nacks={s['nacks']:<3d} "
                f"backpressure={s['backpressure']:<3d} "
                f"replies={s['replies']:<4d} "
                f"credits={self.credits}{agg}")


def _args_size(source_args, source_args_size):
    if source_args_size is not None:
        return source_args_size
    try:
        return len(source_args)
    except TypeError:
        return 0


class Dispatcher:
    """One source fanning ifunc frames out to host and device targets."""

    def __init__(self, src_ctx=None, engine: ProgressEngine | None = None, *,
                 coalesce: bool = False, obs: Obs | None = None):
        self.src_ctx = src_ctx
        self.engine = engine if engine is not None else ProgressEngine()
        self.peers: dict[str, Peer] = {}
        self._rr = 0             # fairness cursor over (peer, ring) lanes
        self.stats = {"sent": 0, "polled": 0, "poll_rounds": 0, "nacks": 0,
                      "replies": 0, "reply_dropped": 0, "agg_sent": 0,
                      "streams": 0, "timed_out": 0}
        # one bundle shared by the dispatcher, its engine and every peer's
        # target context, so the source's puts and the targets' exec spans
        # land in one trace; counters-only unless the caller opted in
        self.obs = obs if obs is not None else Obs("dispatcher")
        self.obs.metrics.register_dict("dispatcher", self.stats)
        if getattr(self.engine, "obs", None) is None:
            self.engine.obs = self.obs
            self.obs.metrics.register_dict("engine", self.engine.stats)
        # task-runtime hooks (see repro_torch.tasks): the router receives
        # (corr_id, name, value, is_err, decoded); the codec provides
        # encode(value) -> bytes / encode_error(exc) -> bytes for replies
        self.reply_router = None
        self.reply_codec = None
        self._sweep_raise = None   # deferred mid-batch ifunc exception (a
        #       corr-less poisoned slot behind already-swept frames): poll
        #       re-raises it after processing those frames' statuses
        self._coalesce = False
        self._agg_max_subs = 16
        self._agg_max_age = 5e-4
        self._agg_max_sub_bytes = 16 << 10
        if coalesce:
            self.set_coalescing(True)

    def set_coalescing(self, enabled: bool = True, *, max_subs: int = 16,
                       max_age: float = 5e-4,
                       max_sub_bytes: int = 16 << 10) -> None:
        """Turn coalesced dispatch on/off.  ``max_subs`` caps sub-records
        per aggregate (also capped by a device lane's ``agg_k``; reaching
        it flushes at once, so a steady burst ships in full containers);
        ``max_age`` (seconds) bounds how long the oldest queued record may
        wait before a poll flushes its queue; a record above
        ``max_sub_bytes`` bypasses the queue as a plain SLIM singleton.  A
        device lane's payloads are whole tiles (64 KiB each), so to
        coalesce them ``max_sub_bytes`` must be raised past the default."""
        if max_subs < 1:
            raise TransportError(f"max_subs must be >= 1, got {max_subs}")
        self._coalesce = enabled
        self._agg_max_subs = max_subs
        self._agg_max_age = max_age
        self._agg_max_sub_bytes = max_sub_bytes

    # -- paths that come with later modules ---------------------------------

    def set_streaming(self, *a, **kw) -> None:
        raise _later("streams", "3(b)")

    def send_stream(self, *a, **kw) -> bool:
        raise _later("streams", "3(b)")

    def remove_peer(self, name: str) -> None:
        raise _later("peer removal", "5")

    @property
    def faults(self):
        return None

    @faults.setter
    def faults(self, injector) -> None:
        if injector is not None:
            raise _later("fault injection", "5")

    @property
    def pollers(self) -> tuple:
        return ()

    @pollers.setter
    def pollers(self, callables) -> None:
        if callables:
            raise _later("side-band pollers", "5")

    # -- topology -----------------------------------------------------------

    def add_peer(self, name: str, fabric: Fabric, target_ctx, *,
                 n_slots: int = DEFAULT_N_SLOTS,
                 slot_size: int = DEFAULT_SLOT_SIZE,
                 rings: int = 1, stripe: bool = False,
                 target_args: dict | None = None,
                 codec=None, **mailbox_kw) -> Peer:
        """``mailbox_kw`` passes backend-specific binds through to
        ``fabric.open_mailbox`` (``prog=``/``externals=``/``n_tiles=``/
        ``agg_k=``/``prog_name=`` on the device-mesh fabric).  The peer's
        stats dict is aliased into the obs registry as ``peer.<name>``,
        and a target context without an ``obs`` bundle gets this
        dispatcher's."""
        if stripe and rings > 1:
            raise _later("striping (stripe=True)", "3(b)")
        if codec is not None:
            raise _later("wire codecs (codec=)", "3(b)")
        if name in self.peers:
            raise TransportError(f"peer {name!r} already attached")
        peer = Peer(name, fabric, target_ctx,
                    target_args if target_args is not None else {})
        for _ in range(rings):
            mb = fabric.open_mailbox(target_ctx, n_slots, slot_size,
                                     **mailbox_kw)
            ch = fabric.connect(self.src_ctx, mb)
            peer.rings.append(RingState(mb, ch))
        self.peers[name] = peer
        self.obs.metrics.register_dict(f"peer.{name}", peer.stats)
        if (target_ctx is not None
                and getattr(target_ctx, "obs", None) is None
                and hasattr(target_ctx, "obs")):
            target_ctx.obs = self.obs
        return peer

    def attach_reply_ring(self, name: str, mailbox, channel) -> None:
        """Give a host peer a result-return path: ``mailbox`` is a
        source-owned ring (opened on the source context), ``channel`` the
        target->source path into it.  Corr-carrying requests executed at
        this peer post their outputs there as FLAG_REPLY frames; device
        peers need none (sweep results are correlated directly)."""
        peer = self.peers[name]
        if peer.fabric.kind == "device":
            raise TransportError(
                "device-mesh peers reply through the sweep, not a ring")
        peer.reply_mailbox = mailbox
        peer.reply_channel = channel
        peer.reply_tail = 0

    # -- source side --------------------------------------------------------

    @staticmethod
    def _slim_ok(peer: Peer, lib) -> bool:
        """SLIM-eligible: device lanes link at mailbox-open time (code never
        travels); host lanes need a confirmed FULL delivery of this
        digest."""
        if peer.fabric.kind == "device":
            return True
        return lib.code_digest in peer.cached

    @staticmethod
    def _check_full_fits(lane: RingState, lib, payload_len: int,
                         cont_len: int = 0) -> None:
        """A SLIM frame must stay FULL-retransmittable: if the target evicts
        the digest, the NACK fallback rebuilds code + payload into this same
        ring — refuse at send time rather than wedge a later drain."""
        need = (F.HEADER_LEN + len(lib.code) + payload_len + cont_len
                + F.TRAILER_LEN)
        if need > lane.mailbox.slot_size:
            raise TransportError(
                f"SLIM frame's FULL fallback ({need}B) exceeds slot "
                f"{lane.mailbox.slot_size}B — NACK retransmit impossible")

    @staticmethod
    def _agg_eligible(peer: Peer) -> bool:
        """Aggregate-eligible: host lanes always; device lanes when every
        mailbox of the peer was opened agg-bound (``agg_k=``)."""
        if peer.fabric.kind != "device":
            return True
        return all(r.mailbox.supports_agg for r in peer.rings)

    @staticmethod
    def _pick_lane(peer: Peer, ring: int | None) -> RingState | None:
        lanes = peer.rings if ring is None else [peer.rings[ring]]
        lane = max(lanes, key=lambda r: r.credits)
        return lane if lane.credits > 0 else None

    def _bp(self, peer: Peer) -> None:
        """Count (and flight-record) one backpressure event."""
        peer.stats["backpressure"] += 1
        if self.obs.enabled:
            self.obs.recorder.add("backpressure", peer.name,
                                  f"credits={peer.credits}")

    def _post_view(self, peer: Peer, lane: RingState, view, rec,
                   on_complete, future=None) -> None:
        o = self.obs
        device = peer.fabric.kind == "device"
        if o.enabled and rec is not None:
            o.recorder.add("put", peer.name,
                           f"{rec.name} corr={rec.corr_id} {len(view)}B"
                           f"{' slim' if rec.slim else ''}")
            if o.tracer.enabled and rec.span is None and not device:
                # the wire span: post -> delivery confirmation (poll OK),
                # NACK, or reject — ended where the inflight record pops
                rec.span = o.tracer.begin(
                    f"put:{rec.name}@{peer.name}", cat="wire",
                    actor=getattr(self.src_ctx, "name", "source"),
                    corr=rec.corr_id or None, bytes=len(view))
        self.engine.post(lane.channel, view, lane.tail, peer=peer.name,
                         on_complete=on_complete, future=future)
        if rec is not None:
            if not device:
                lane.inflight[lane.tail] = rec
                if len(lane.inflight) > 2 * lane.mailbox.n_slots:
                    # the target swept outside this poll loop: drop
                    # records of slots consumed elsewhere
                    low = lane.mailbox.consumed
                    for s in [s for s in lane.inflight if s < low]:
                        del lane.inflight[s]
            elif rec.subs is not None:
                # device aggregates complete by the coordinates this send
                # stages into: the sweep leaves per-sub outcomes in
                # Mailbox.last_agg keyed the same way
                lane.agg_by_coords[lane.mailbox.slot_coords(lane.tail)] = rec
            elif rec.corr_id:
                # device replies come back as sweep results at the
                # coordinates this send stages into
                lane.corr_by_coords[lane.mailbox.slot_coords(lane.tail)] = (
                    rec.corr_id, rec.sent_at)
        lane.tail += 1
        peer.stats["sent"] += 1
        peer.stats["bytes"] += len(view)
        if rec is not None and rec.slim:
            peer.stats["slim_sent"] += 1
        self.stats["sent"] += 1

    def _slab_post(self, peer: Peer, lane: RingState, frame, rec,
                   on_complete=None, future=None) -> None:
        """Stage a ready frame into the lane's slab cell and post it."""
        slab = self.engine.slab_slot(lane.channel, lane.tail)
        n = len(frame)
        if n > len(slab):
            raise TransportError(
                f"frame {n}B exceeds slot {lane.mailbox.slot_size}B")
        slab[:n] = frame
        self._post_view(peer, lane, slab[:n], rec, on_complete, future)

    def _flush_resends(self, peer: Peer) -> bool:
        """Post queued FULL rebuilds (the NACK fallback) ahead of any new
        traffic; False while the queue cannot drain.

        They wait until the peer's rings are quiescent (every frame in
        flight resolved): an eviction NACKs every in-flight SLIM frame of
        the digest, but the NACKs surface one sweep at a time — posting
        the first rebuild before the rest have reported would reorder
        execution at the target.  Waiting makes the resend queue a replay
        of ring order."""
        if not peer.resend:
            return True
        if any(r.tail != r.mailbox.consumed for r in peer.rings):
            return False                       # storm not fully observed yet
        o = self.obs
        while peer.resend:
            lane = self._pick_lane(peer, None)
            if lane is None:
                return False
            msg = peer.resend.popleft()
            lib = msg.handle.lib
            rec = _TxRec(lib.name, lib.code_digest, msg.handle, slim=False,
                         corr_id=msg.corr_id)
            if o.enabled:
                o.recorder.add("resend", peer.name,
                               f"{rec.name} corr={rec.corr_id} FULL")
                if o.tracer.enabled and peer.fabric.kind != "device":
                    # the resend is its own interval under "resend", tied
                    # to the NACKed wire span by corr
                    rec.span = o.tracer.begin(
                        f"resend:{rec.name}@{peer.name}", cat="resend",
                        actor=getattr(self.src_ctx, "name", "source"),
                        corr=rec.corr_id or None)
            self._slab_post(peer, lane, msg.frame, rec)
            peer.stats["resent"] += 1
        return True

    def _queued_ahead(self, peer: Peer) -> bool:
        """Post what is queued for the peer (resends, then coalesced
        records); True — counting a backpressure event — when something
        could not post, so a new frame must not overtake it."""
        if self._flush_resends(peer) and self._flush_coalesce_peer(peer):
            return False
        self._bp(peer)
        return True

    def send(self, peer_name: str, msg, *, ring: int | None = None,
             on_complete=None, future=None) -> bool:
        """Post one ifunc message to a peer.  Returns False (and counts a
        backpressure event) when every eligible ring is out of credits, or
        resends or coalesced records queued ahead of it cannot post yet.

        The frame is staged into the engine's slab cell for the chosen ring
        slot; if the peer is known to hold this handle's digest (or links
        at open time), the code section is elided on the fly (SLIM).
        ``future`` is marked SENT by the flush that publishes the frame."""
        peer = self.peers[peer_name]
        if self._queued_ahead(peer):
            return False
        lane = self._pick_lane(peer, ring)
        if lane is None:
            self._bp(peer)
            return False
        frame = msg.frame if hasattr(msg, "frame") else msg
        handle = getattr(msg, "handle", None)
        if handle is None:                       # raw frame: no slim protocol
            self._slab_post(peer, lane, frame, None, on_complete, future)
            return True
        lib = handle.lib
        corr_id = getattr(msg, "corr_id", 0)
        cont = getattr(msg, "cont", None)
        device = peer.fabric.kind == "device"
        if cont is not None and device:
            raise TransportError(
                "continuation frames are host-tier only (the device sweep "
                "has no forwarding hook)")
        already_slim = bool(getattr(msg, "slim", False))
        want_slim = self._slim_ok(peer, lib)
        rec = _TxRec(lib.name, lib.code_digest, handle,
                     already_slim or want_slim, corr_id=corr_id)
        if rec.slim and not device:
            self._check_full_fits(lane, lib, len(msg.payload_view),
                                  0 if cont is None else len(cont))
        if want_slim and not already_slim:
            # elide the code section while staging — the slab cell is the
            # only buffer the SLIM frame ever occupies
            slab = self.engine.slab_slot(lane.channel, lane.tail)
            n = F.pack_frame_into(slab, lib.name, b"", msg.payload_view,
                                  lib.kind, digest=lib.code_digest, slim=True,
                                  corr_id=corr_id, cont=cont)
            self._post_view(peer, lane, slab[:n], rec, on_complete, future)
        else:
            self._slab_post(peer, lane, frame, rec, on_complete, future)
        return True

    def send_ifunc(self, peer_name: str, handle, source_args,
                   source_args_size: int | None = None, *,
                   ring: int | None = None, on_complete=None,
                   corr_id: int = 0, future=None) -> bool:
        """Zero-copy send: the payload codec writes straight into the
        peer's slab cell and the header is sealed around it in place.  SLIM
        once the peer's cache is known warm.  With coalescing on and an
        aggregate-eligible peer, a cache-warm record queues for an
        aggregate instead.  ``corr_id`` nonzero asks for the result back
        (a reply frame, or a device sweep result, to ``reply_router``);
        ``future`` is marked SENT by the flush that publishes the frame."""
        peer = self.peers[peer_name]
        lib = handle.lib
        if (self._coalesce and on_complete is None
                and self._agg_eligible(peer) and self._slim_ok(peer, lib)):
            return self._enqueue_sub(peer, handle, source_args,
                                     source_args_size, ring, corr_id, future)
        if self._queued_ahead(peer):
            return False
        lane = self._pick_lane(peer, ring)
        if lane is None:
            self._bp(peer)
            return False
        source_args_size = _args_size(source_args, source_args_size)
        max_size = int(lib.payload_get_max_size(source_args, source_args_size))
        slim = self._slim_ok(peer, lib)
        if slim and peer.fabric.kind != "device":
            self._check_full_fits(lane, lib, max_size)
        code = b"" if slim else lib.code
        slab = self.engine.slab_slot(lane.channel, lane.tail)
        if (F.HEADER_LEN + len(code) + max_size
                + F.TRAILER_LEN) > len(slab):
            raise TransportError(
                f"frame would exceed slot {lane.mailbox.slot_size}B")
        pv = F.frame_payload_view(slab, len(code), max_size)
        used = lib.payload_init(pv, max_size, source_args, source_args_size)
        used = max_size if used in (None, 0) else int(used)
        n = F.seal_frame(slab, lib.name, code, lib.kind, used,
                         digest=lib.code_digest, slim=slim, corr_id=corr_id)
        self._post_view(peer, lane, slab[:n],
                        _TxRec(lib.name, lib.code_digest, handle, slim,
                               corr_id=corr_id), on_complete, future)
        return True

    # -- coalesced dispatch -------------------------------------------------

    @staticmethod
    def _materialize_payload(lib, source_args, source_args_size) -> bytes:
        """Run the library's payload codec into a scratch buffer: a queued
        record's final offset inside its aggregate is unknown until
        flush."""
        source_args_size = _args_size(source_args, source_args_size)
        max_size = int(lib.payload_get_max_size(source_args, source_args_size))
        buf = bytearray(max_size)
        used = lib.payload_init(memoryview(buf), max_size, source_args,
                                source_args_size)
        used = max_size if used in (None, 0) else int(used)
        return bytes(memoryview(buf)[:used])

    def _enqueue_sub(self, peer: Peer, handle, source_args, source_args_size,
                     ring, corr_id, future=None) -> bool:
        """Queue one invocation for aggregate packing (no ring credit is
        claimed until flush); flushes the queue first when this record
        would overflow the slot byte budget, and after adding when the
        sub-record cap fills.  The queue is bounded at a full ring's worth
        of containers (``max_subs * n_slots`` records): past that, with
        flushes backpressured, the send reports False."""
        lib = handle.lib
        lane0 = peer.rings[ring if ring is not None else 0]
        bound = self._agg_max_subs * lane0.mailbox.n_slots
        q0 = peer.coalesce.get(ring)
        if q0 is not None and len(q0.subs) >= bound:
            self._flush_coalesce_peer(peer, ring)
            q0 = peer.coalesce.get(ring)
            if q0 is not None and len(q0.subs) >= bound:
                self._bp(peer)
                return False
        payload = self._materialize_payload(lib, source_args,
                                            source_args_size)
        if peer.fabric.kind != "device":
            # the NACK fallback rebuilds this record as a FULL singleton
            # into the same ring (device lanes never ship code)
            self._check_full_fits(lane0, lib, len(payload))
        sub = _PendingSub(handle, lib.name, lib.kind, lib.code_digest,
                          payload, corr_id, None, future, time.monotonic())
        if len(payload) > self._agg_max_sub_bytes:
            # bandwidth-bound record: ship it as a plain SLIM singleton,
            # after anything queued before it
            if not self._flush_coalesce_peer(peer, ring):
                self._bp(peer)
                return False
            lane = self._pick_lane(peer, ring)
            if lane is None:
                self._bp(peer)
                return False
            self._post_agg(peer, lane, [sub])
            return True
        q = peer.coalesce.get(ring)
        if q is None:
            q = peer.coalesce[ring] = _CoalesceQ()
        cap = lane0.mailbox.slot_size
        if q.subs and q.would_take(sub) > cap:
            self._flush_coalesce_peer(peer, ring)      # slot budget filled
            q = peer.coalesce.get(ring)
            if q is None:
                q = peer.coalesce[ring] = _CoalesceQ()
        q.add(sub)
        peer.stats["coalesced"] += 1
        if len(q.subs) >= self._agg_max_subs or q.bytes > cap:
            self._flush_coalesce_peer(peer, ring)      # best effort: on
            #                           backpressure the records stay queued
        return True

    def send_ifunc_many(self, peer_name: str, handle, payloads, *,
                        ring: int | None = None, corr_ids=None,
                        futures=None) -> int:
        """Bulk coalescing send: K invocations of one handle in one call.
        ``corr_ids`` / ``futures`` (parallel lists) tie records to the task
        runtime's reply path.  Returns the number of records accepted,
        stopping early at one it cannot accept (backpressure, or a record
        whose FULL fallback would not fit a ring slot).  Falls back to per-record
        :meth:`send_ifunc` when coalescing is off, the peer is not
        aggregate-eligible or its cache is not known warm."""
        peer = self.peers[peer_name]
        lib = handle.lib
        if not (self._coalesce and self._agg_eligible(peer)
                and self._slim_ok(peer, lib)):
            n = 0
            for i, args in enumerate(payloads):
                if not self.send_ifunc(peer_name, handle, args, ring=ring,
                                       corr_id=corr_ids[i] if corr_ids
                                       else 0,
                                       future=futures[i] if futures
                                       else None):
                    break
                n += 1
            return n
        is_device = peer.fabric.kind == "device"
        lane0 = peer.rings[ring if ring is not None else 0]
        cap = lane0.mailbox.slot_size
        agg_k = getattr(lane0.mailbox, "agg_k", 0)
        full_base = F.HEADER_LEN + len(lib.code) + F.TRAILER_LEN
        gms, init = lib.payload_get_max_size, lib.payload_init
        name, kind, digest = lib.name, lib.kind, lib.code_digest
        kind_int = int(kind)
        max_subs = (min(self._agg_max_subs, agg_k) if agg_k
                    else self._agg_max_subs)
        max_sub_bytes = self._agg_max_sub_bytes
        now = time.monotonic()
        payloads = (payloads if isinstance(payloads, (list, tuple))
                    else list(payloads))
        N = len(payloads)
        n = i = 0
        q = peer.coalesce.get(ring)

        # -- direct slab pack: with nothing queued ahead (FIFO safe) and a
        # -- ring slot free, each record's payload codec writes STRAIGHT
        # -- into the slab cell at its final offset in the container (the
        # -- columnar layout streams payloads first; the fixed headers
        # -- settle as one table write at the end)
        if (q is None or not q.subs) and self._flush_resends(peer):
            while i < N:
                args = payloads[i]
                sz = _args_size(args, None)
                mx = int(gms(args, sz))
                if not is_device and full_base + mx > cap:
                    break                # FULL fallback cannot fit a ring
                    #                      slot: the queue path refuses it
                lane = self._pick_lane(peer, ring)
                if lane is None:
                    break                # no credits: queue the remainder
                slab = self.engine.slab_slot(lane.channel, lane.tail)
                view = F.frame_payload_view(
                    slab, 0, len(slab) - F.HEADER_LEN - F.TRAILER_LEN)
                if mx > max_sub_bytes:
                    # aggregation buys nothing for a bandwidth-bound
                    # record: a SLIM singleton, packed in place
                    used = init(view[:mx], mx, args, sz)
                    used = mx if used in (None, 0) else int(used)
                    cid = corr_ids[i] if corr_ids else 0
                    fl = F.seal_frame(slab, name, b"", kind, used,
                                      digest=digest, slim=True, corr_id=cid)
                    self._post_view(peer, lane, slab[:fl],
                                    _TxRec(name, digest, handle, slim=True,
                                           corr_id=cid), None,
                                    futures[i] if futures else None)
                    n += 1
                    i += 1
                    continue
                off = prologue_end = F.begin_agg(view, [name])
                budget = len(view) - 4
                hdrs: list[tuple] = []
                subs: list[_PendingSub] = []
                stop = False
                while i < N and len(subs) < max_subs:
                    args = payloads[i]
                    sz = _args_size(args, None)
                    mx = int(gms(args, sz))
                    if not is_device and full_base + mx > cap:
                        stop = True      # FULL fallback cannot fit a ring
                        break            # slot: the queue path refuses it
                    if mx > max_sub_bytes:
                        break            # seal first; the outer loop
                        #                  ships this record alone
                    if (off + mx + (len(subs) + 1) * F.AGG_SUB_OVERHEAD
                            > budget):
                        break            # container full
                    pv = view[off:off + mx]
                    used = init(pv, mx, args, sz)
                    used = mx if used in (None, 0) else int(used)
                    cid = corr_ids[i] if corr_ids else 0
                    hdrs.append((0, kind_int, 0, digest, cid, used, 0))
                    subs.append(_PendingSub(
                        handle, name, kind, digest,
                        pv if used == mx else view[off:off + used],
                        cid, None, futures[i] if futures else None, now))
                    off += used
                    i += 1
                if not subs:
                    break                # one record overflows the slot:
                    #                      the queue path reports it
                plen = F.finish_agg(view, prologue_end, off, hdrs)
                fl = F.seal_frame(slab, F.AGG_NAME, b"", kind, plen,
                                  digest=F.NO_DIGEST, flags=F.FLAG_AGG)
                futs = [s.future for s in subs if s.future is not None]
                self._post_view(peer, lane, slab[:fl],
                                _TxRec(F.AGG_NAME, F.NO_DIGEST, None,
                                       slim=True, subs=subs), None,
                                futs or None)
                peer.stats["agg_sent"] += 1
                peer.stats["agg_subs"] += len(subs)
                peer.stats["coalesced"] += len(subs)
                self.stats["agg_sent"] += 1
                n += len(subs)
                if stop:
                    break

        # -- the queue path: records behind an existing queue, and the
        # -- leftovers of backpressure — ONE implementation of the policy
        while i < N:
            try:
                ok = self._enqueue_sub(peer, handle, payloads[i], None, ring,
                                       corr_ids[i] if corr_ids else 0,
                                       futures[i] if futures else None)
            except TransportError:
                break   # un-retransmittable record: a send_ifunc of it
                #         raises the error with this record's identity
            if not ok:
                break
            i += 1
            n += 1
        return n

    def _post_agg(self, peer: Peer, lane: RingState,
                  subs: list[_PendingSub]) -> None:
        """Pack queued sub-records into the lane's slab cell and post: one
        container, one credit.  A single record ships as a plain SLIM
        singleton — the aggregate wrapper is never latency overhead."""
        slab = self.engine.slab_slot(lane.channel, lane.tail)
        if len(subs) == 1:
            sub = subs[0]
            n = F.pack_frame_into(slab, sub.name, b"", sub.payload,
                                  sub.kind, digest=sub.digest, slim=True,
                                  corr_id=sub.corr_id)
            self._post_view(peer, lane, slab[:n],
                            _TxRec(sub.name, sub.digest, sub.handle,
                                   slim=True, corr_id=sub.corr_id), None,
                            sub.future)
            return
        # the container header carries the records' code kind: the device
        # put rejects non-UVM frames at the header
        n = F.seal_agg_frame(slab, subs, kind=subs[0].kind)
        futs = [s.future for s in subs if s.future is not None]
        rec = _TxRec(F.AGG_NAME, F.NO_DIGEST, None, slim=True,
                     subs=list(subs))
        o = self.obs
        if o.tracer.enabled and peer.fabric.kind != "device":
            # the flush of queued records is its own span (a directly
            # packed container rides a plain wire span)
            rec.span = o.tracer.begin(
                f"agg:{len(subs)}@{peer.name}", cat="agg",
                actor=getattr(self.src_ctx, "name", "source"),
                subs=len(subs), bytes=n)
        self._post_view(peer, lane, slab[:n], rec, None, futs or None)
        peer.stats["agg_sent"] += 1
        peer.stats["agg_subs"] += len(subs)
        self.stats["agg_sent"] += 1

    @staticmethod
    def _split_budget(subs: list[_PendingSub], cap: int,
                      max_subs: int) -> int:
        """Longest prefix of ``subs`` that packs into ONE container within
        the slot byte budget and the record cap.  Always >= 1: a lone
        record posts as a SLIM singleton."""
        names: set = set()
        total = _CoalesceQ.BASE
        n = 0
        for s in subs:
            extra = F.AGG_SUB_OVERHEAD + len(s.payload)
            if s.name not in names:
                extra += 1 + len(s.name)
            if n and (total + extra > cap or n >= max_subs):
                break
            total += extra
            names.add(s.name)
            n += 1
        return n

    def _flush_coalesce_peer(self, peer: Peer,
                             ring: int | None | str = "all") -> bool:
        """Drain a peer's coalescing queue(s) into aggregate posts, as many
        containers as the slot budget and ``agg_k`` require.  False when a
        queue could not fully drain (no ring credits, or resends still
        waiting) — its remaining records stay queued, in order."""
        if not peer.coalesce:
            return True
        if not self._flush_resends(peer):
            return False     # NACK rebuilds outrank queued new traffic
        keys = list(peer.coalesce) if ring == "all" else [ring]
        ok = True
        for key in keys:
            q = peer.coalesce.get(key)
            if q is None or not q.subs:
                peer.coalesce.pop(key, None)
                continue
            subs = q.subs
            mb0 = peer.rings[key if key is not None else 0].mailbox
            agg_k = getattr(mb0, "agg_k", 0)
            max_subs = (min(self._agg_max_subs, agg_k) if agg_k
                        else self._agg_max_subs)
            posted = 0
            while posted < len(subs):
                lane = self._pick_lane(peer, key)
                if lane is None:
                    self._bp(peer)
                    ok = False
                    break
                take = self._split_budget(subs[posted:], mb0.slot_size,
                                          max_subs)
                self._post_agg(peer, lane, subs[posted:posted + take])
                posted += take
            if posted >= len(subs):
                peer.coalesce.pop(key, None)
            elif posted:
                nq = _CoalesceQ()          # keep the unposted tail queued
                for s in subs[posted:]:
                    nq.add(s)
                peer.coalesce[key] = nq
        return ok

    def flush_coalesced(self, peer_name: str | None = None,
                        ring: int | None | str = "all") -> bool:
        """Explicit coalescing-queue flush (all peers by default); False
        when a queue could not fully drain."""
        if peer_name is not None:
            return self._flush_coalesce_peer(self.peers[peer_name], ring)
        ok = True
        for p in self.peers.values():
            ok = self._flush_coalesce_peer(p, ring) and ok
        return ok

    def _age_flush(self) -> None:
        """Flush any queue whose oldest record has waited past the age
        bound."""
        now = time.monotonic()
        for p in self.peers.values():
            for key in list(p.coalesce):
                q = p.coalesce.get(key)
                if (q is not None and q.subs
                        and now - q.subs[0].enq_at >= self._agg_max_age):
                    self._flush_coalesce_peer(p, key)

    def flush(self) -> int:
        """Publish all in-flight puts (completes trailers -> frames become
        consumable at the targets).  Coalescing queues flush first."""
        for p in self.peers.values():
            self._flush_coalesce_peer(p)
        return self.engine.flush()

    # -- target side: fairness-aware poll loop ------------------------------

    def _lanes(self) -> list[tuple[Peer, RingState]]:
        return [(p, r) for p in self.peers.values() for r in p.rings]

    def _rebuild_full(self, lane: RingState, abs_slot: int, rec: _TxRec):
        """NACK fallback: the SLIM frame still sits in the source slab cell
        for its slot (the credit only just returned, nothing has overwritten
        it); ``ifunc_msg_to_full`` restores the code section."""
        view = self.engine.slab_slot(lane.channel, abs_slot)
        return ifunc_msg_to_full(IfuncMsg(rec.handle, view, slim=True))

    def _sweep_task(self, peer: Peer, lane: RingState,
                    max_slots: int = 1) -> list:
        """Sweep up to ``max_slots`` ready slots of a reply-enabled host
        lane: per slot, read the request's corr id before execution clears
        the frame, take the ifunc's output (``target_args["result"]``) or
        the exception it raised after, and post the encoded reply.  An
        ifunc exception consumes the slot instead of wedging the ring; the
        error travels back as a FLAG_ERR reply.  A corr-less frame has no
        reply to carry the error, so after consuming the slot the
        exception re-raises to the poll caller; mid-batch the raise is
        deferred (``_sweep_raise``) until ``poll`` has processed the
        statuses of the slots already swept, so a delivered aggregate
        ahead of a poisoned slot still confirms digests and resolves its
        futures.  Aggregate containers pass through here (header corr 0);
        their replies coalesce in :meth:`_complete_agg`."""
        mb = lane.mailbox
        out: list = []
        for _ in range(max_slots):
            buf = mb.slot_view(mb.head)
            hdr = mb.peek()
            corr = 0 if hdr is None else hdr.corr_id
            name = "" if hdr is None else hdr.name
            kind = F.CodeKind.PYBC if hdr is None else hdr.code_kind
            targs = peer.target_args
            if isinstance(targs, dict):
                targs.pop("result", None)
            err = None
            try:
                sts = mb.sweep(peer.target_ctx, targs, budget=1)
            except Exception as e:           # raised *inside* the ifunc
                err = e
                F.scrub_slot(buf)
                mb.head += 1                 # consume the poisoned slot
                mb.consumed += 1
                peer.stats["errors"] += 1
                if not corr:
                    if not out:
                        raise                # no future to carry the error
                    self._sweep_raise = e    # raise after the batch's
                    break                    # statuses are processed
                sts = [Status.OK]            # delivered: it just raised
            if corr and sts and sts[0] in (Status.OK, Status.REJECTED):
                if err is not None:
                    value, is_err = err, True
                elif sts[0] == Status.REJECTED:
                    value, is_err = TransportError(
                        str(peer.target_ctx.stats.get(
                            "last_reject", "frame rejected"))), True
                else:
                    value = (targs.get("result")
                             if isinstance(targs, dict) else None)
                    is_err = False
                self._post_reply(peer, name, kind, corr, value, is_err)
            out.extend(sts)
            if not sts or sts[-1] not in (Status.OK, Status.REJECTED,
                                          Status.NACK_UNCACHED):
                break                        # empty / in progress: stop here
        return out

    def _post_agg_reply(self, peer: Peer, reply_subs: list[tuple]) -> None:
        """Coalesce the results of one aggregate's corr-carrying records
        into ONE ``FLAG_AGG|FLAG_REPLY`` frame on the peer's reply ring;
        singleton replies when there is one result or the encoded batch
        outgrows a reply slot."""
        if peer.reply_channel is None or self.reply_codec is None:
            self.stats["reply_dropped"] += len(reply_subs)
            return
        codec = self.reply_codec
        wire = []
        for sub, value, is_err in reply_subs:
            try:
                payload = (codec.encode_error(value) if is_err
                           else codec.encode(value))
            except Exception as e:           # unencodable result: the error
                payload, is_err = codec.encode_error(e), True   # IS the reply
            wire.append(F.AggSub(sub.name, sub.kind, F.NO_DIGEST,
                                 sub.corr_id, payload, err=is_err))
        if (len(wire) > 1
                and F.agg_frame_len(wire) <= peer.reply_mailbox.slot_size):
            if peer.reply_credits <= 0:
                self._drain_replies(peer)
            slab = self.engine.slab_slot(peer.reply_channel, peer.reply_tail)
            n = F.seal_agg_frame(slab, wire, reply=True)
            self.engine.post(peer.reply_channel, slab[:n], peer.reply_tail,
                             peer=peer.name)
            peer.reply_tail += 1
            peer.stats["replies"] += len(wire)
            peer.stats["agg_replies"] += 1
            self.stats["replies"] += len(wire)
            return
        for sub, value, is_err in reply_subs:
            self._post_reply(peer, sub.name, sub.kind, sub.corr_id, value,
                             is_err)

    def _post_reply(self, peer: Peer, name: str, kind, corr: int, value,
                    is_err: bool) -> None:
        """Pack a result into a FLAG_REPLY frame and post it target ->
        source.  The source can always drain its own inbox, so a full reply
        ring is drained inline rather than dropping the result."""
        if peer.reply_channel is None or self.reply_codec is None:
            self.stats["reply_dropped"] += 1
            return
        if peer.reply_credits <= 0:
            self._drain_replies(peer)
        codec = self.reply_codec
        try:
            payload = (codec.encode_error(value) if is_err
                       else codec.encode(value))
        except Exception as e:               # unencodable result: the error
            payload, is_err = codec.encode_error(e), True   # IS the reply
        slab = self.engine.slab_slot(peer.reply_channel, peer.reply_tail)
        try:
            n = F.pack_reply_into(slab, name, payload, kind, corr, err=is_err)
        except F.FrameError as e:            # oversized value: error reply
            n = F.pack_reply_into(slab, name, codec.encode_error(e), kind,
                                  corr, err=True)
        self.engine.post(peer.reply_channel, slab[:n], peer.reply_tail,
                         peer=peer.name)
        peer.reply_tail += 1
        peer.stats["replies"] += 1
        self.stats["replies"] += 1

    def _route_reply(self, corr: int, name: str, value, is_err: bool,
                     decoded: bool) -> None:
        if self.reply_router is None:
            self.stats["reply_dropped"] += 1
            return
        self.reply_router(corr, name, value, is_err, decoded)

    def _drain_replies(self, peer: Peer, budget: int | None = None) -> int:
        """Source side of the reply path: flush the target's pending reply
        puts, then consume FLAG_REPLY frames from the peer's reply ring
        into the router.  Corrupt reply slots are cleared and counted,
        never wedged; a record stamped under a generation older than the
        peer's fence is dropped as a fenced orphan."""
        if peer.reply_mailbox is None:
            return 0
        self.engine.flush(peer.reply_channel)
        mb = peer.reply_mailbox
        n = 0
        while budget is None or n < budget:
            buf = mb.slot_view(mb.head)
            try:
                hdr = F.peek_header(buf)
            except F.FrameError:
                F.scrub_slot(buf)
                mb.head += 1
                mb.consumed += 1
                peer.stats["reply_rejects"] += 1
                continue
            if hdr is None or not F.trailer_arrived(buf, hdr):
                break
            if hdr.is_agg:
                # coalesced reply: one container, many corr ids
                try:
                    routed = F.parse_agg(
                        F.frame_sections(buf, hdr)[1]).reply_tuples()
                except F.FrameError:
                    F.scrub_slot(buf)
                    mb.head += 1
                    mb.consumed += 1
                    peer.stats["reply_rejects"] += 1
                    continue
                F.clear_frame(buf, hdr)
                mb.head += 1
                mb.consumed += 1
                for corr, name, payload, is_err in routed:
                    if peer.fence and F.corr_gen(corr) < peer.fence:
                        peer.stats["fenced_orphans"] += 1
                        continue
                    self._route_reply(corr, name, payload, is_err,
                                      decoded=False)
                n += len(routed)
                continue
            payload = bytes(F.frame_sections(buf, hdr)[1])
            corr, name, is_err = hdr.corr_id, hdr.name, hdr.is_err
            F.clear_frame(buf, hdr)
            mb.head += 1
            mb.consumed += 1
            if peer.fence and F.corr_gen(corr) < peer.fence:
                peer.stats["fenced_orphans"] += 1
                if self.obs.enabled:
                    self.obs.recorder.add(
                        "fenced_orphan", peer.name,
                        f"corr={corr} gen={F.corr_gen(corr)} "
                        f"fence={peer.fence}")
                n += 1
                continue
            self._route_reply(corr, name, payload, is_err, decoded=False)
            n += 1
        return n

    def poll_replies(self) -> int:
        """Drain every peer's reply ring; returns replies routed."""
        return sum(self._drain_replies(p) for p in self.peers.values())

    def _end_span(self, rec: _TxRec | None, **args) -> None:
        if rec is not None and rec.span is not None:
            self.obs.tracer.end(rec.span, **args)
            rec.span = None

    def _complete_agg(self, peer: Peer, lane: RingState, rec: _TxRec,
                      coords) -> int:
        """Source-side completion of one delivered aggregate: walk the
        per-sub outcomes the sweep left in ``Mailbox.last_agg`` under
        ``coords``, confirm cached digests, queue a FULL-singleton rebuild
        for each NACKed record (its executed siblings are never replayed),
        and coalesce the corr-carrying records' results into one reply
        frame (a device lane, with no reply ring, routes each straight to
        ``reply_router``).  Returns the consumed (OK or
        rejected) sub-records: the container's share of the poll
        budget."""
        o = self.obs
        if o.enabled:
            o.rtt_hist.observe((time.monotonic() - rec.sent_at) * 1e6)
            self._end_span(rec, subs=len(rec.subs))
        results = lane.mailbox.last_agg.pop(coords, None)
        subs = rec.subs
        if results is not None and len(results) != len(subs):
            # a harvest that does not match the container sent: per-index
            # outcomes would be misattributed — delivered, without detail
            peer.stats["agg_harvest_lost"] += 1
            results = None
        device = peer.fabric.kind == "device"
        if results is not None and all(r is _AGG_PLAIN_OK for r in results):
            # the dominant outcome: every record executed clean,
            # fire-and-forget — the target handed back the shared OK
            # marker for all of them, so skip the per-record walk
            for sub in subs:
                peer.cached.add(sub.digest)
            peer.stats["delivered"] += len(subs)
            reply_subs = [(sub, None, False) for sub in subs if sub.corr_id]
            if reply_subs:
                self._post_agg_reply(peer, reply_subs)
            return len(subs)
        consumed = n_ok = n_rej = n_nack = n_err = 0
        reply_subs = []
        for i, sub in enumerate(subs):
            res = results[i] if results is not None else None
            st = Status.OK if res is None else res.status
            if st == Status.NACK_UNCACHED:
                n_nack += 1
                if o.enabled:
                    o.recorder.add("nack", peer.name,
                                   f"agg sub {sub.name} corr={sub.corr_id}")
                peer.cached.discard(sub.digest)
                if sub.handle is not None:
                    lib = sub.handle.lib
                    frame = F.pack_frame(lib.name, lib.code, sub.payload,
                                         lib.kind, digest=lib.code_digest,
                                         corr_id=sub.corr_id)
                    peer.resend.append(IfuncMsg(sub.handle, frame, slim=False,
                                                corr_id=sub.corr_id))
                else:
                    peer.stats["nack_lost"] += 1
                continue
            consumed += 1
            if st == Status.REJECTED:
                n_rej += 1
                if sub.corr_id:
                    err = (res.error if res is not None
                           and res.error is not None
                           else TransportError("sub-record rejected"))
                    reply_subs.append((sub, err, True))
                continue
            n_ok += 1
            peer.cached.add(sub.digest)
            if sub.corr_id:
                if res is not None and res.error is not None:
                    n_err += 1
                    reply_subs.append((sub, res.error, True))
                else:
                    reply_subs.append(
                        (sub, None if res is None else res.value, False))
        s = peer.stats
        s["delivered"] += n_ok
        s["rejected"] += n_rej
        s["errors"] += n_err
        s["nacks"] += n_nack
        self.stats["nacks"] += n_nack
        if reply_subs and device:
            # no reply ring on a mesh lane: the sweep's values ARE the
            # results — route them directly, decoded
            for sub, value, is_err in reply_subs:
                self._route_reply(sub.corr_id, peer.name, value, is_err,
                                  decoded=True)
            s["replies"] += len(reply_subs)
            self.stats["replies"] += len(reply_subs)
        elif reply_subs:
            self._post_agg_reply(peer, reply_subs)
        return consumed

    def poll(self, budget: int | None = None) -> int:
        """Drain up to ``budget`` messages total across all peers' rings,
        round-robin.  A *budgeted* poll consumes at most one message per
        lane per round, starting one lane past last round's first server;
        an *unbudgeted* poll (the drain path) sweeps a whole ring's worth
        of ready slots per host-lane visit.  A device-mesh lane always
        sweeps whole-ring (one launch) and an aggregate container yields
        all its sub-records at once, so a poll can overshoot ``budget`` by
        one sweep.

        OK deliveries confirm the target's code cache for the frame's
        digest (enabling SLIM framing); NACK_UNCACHED consumes the slot,
        un-confirms the digest and queues a FULL rebuild — for an
        aggregate, per sub-record.  Device results of corr-carrying sends
        and reply frames go to ``reply_router`` (the reply rings drain at
        the end of every poll); they do not count against ``budget``.  An
        ifunc that raised behind frames this sweep consumed re-raises
        after those frames' statuses are processed.  Returns the messages
        delivered or rejected."""
        if self._coalesce:
            self._age_flush()            # no record waits past max_age
        lanes = self._lanes()
        if not lanes:
            return 0
        o = self.obs
        done = 0
        self.stats["poll_rounds"] += 1
        take = 1 if budget is not None else None    # None -> whole ring
        progressed = True
        while progressed and (budget is None or done < budget):
            progressed = False
            start = self._rr % len(lanes)
            for k in range(len(lanes)):
                peer, lane = lanes[(start + k) % len(lanes)]
                if budget is not None and done >= budget:
                    break
                mb = lane.mailbox
                track = peer.fabric.kind != "device"
                slot = mb.head
                if track and peer.reply_channel is not None:
                    sts = self._sweep_task(
                        peer, lane, take if take is not None else mb.n_slots)
                    coords = res_new = None
                elif track:
                    sts = mb.sweep(peer.target_ctx, peer.target_args,
                                   budget=take)
                    coords = res_new = None
                else:
                    res_before = len(mb.results)
                    sts = mb.sweep(peer.target_ctx, peer.target_args,
                                   budget=1)
                    coords = mb.last_coords
                    # one results entry per consumed OK container or
                    # frame: a cursor over them keeps statuses aligned
                    res_new = iter(mb.results[res_before:])
                for i, st in enumerate(sts):
                    rec = None
                    coord = coords[i] if coords is not None else None
                    if st in (Status.OK, Status.REJECTED,
                              Status.NACK_UNCACHED):
                        rec = (lane.inflight.pop(slot, None) if track
                               else lane.agg_by_coords.pop(coord, None))
                        slot += 1
                    if st == Status.OK:
                        progressed = True
                        val = None if track else next(res_new, None)
                        if rec is not None and rec.subs is not None:
                            done += self._complete_agg(
                                peer, lane, rec,
                                mb.slot_coords(slot - 1) if track else coord)
                            continue
                        peer.stats["delivered"] += 1
                        done += 1
                        if rec is not None:
                            peer.cached.add(rec.digest)
                            if o.enabled:
                                o.rtt_hist.observe(
                                    (time.monotonic() - rec.sent_at) * 1e6)
                                self._end_span(rec, status="ok")
                        if not track:
                            ent = lane.corr_by_coords.pop(coord, None)
                            if ent:          # device reply: the result IS it
                                self._route_reply(ent[0], peer.name, val,
                                                  False, decoded=True)
                    elif st == Status.REJECTED:
                        peer.stats["rejected"] += 1
                        done += 1
                        progressed = True
                        if rec is not None and o.enabled:
                            o.recorder.add("reject", peer.name,
                                           f"{rec.name} corr={rec.corr_id}")
                            self._end_span(rec, status="rejected")
                        if rec is not None and rec.subs is not None:
                            # whole container rejected: every corr-carrying
                            # record resolves with the error, none ran
                            for sub in rec.subs:
                                if sub.corr_id:
                                    self._route_reply(
                                        sub.corr_id, peer.name,
                                        TransportError(
                                            "aggregate container rejected"),
                                        True, decoded=True)
                        if not track:
                            ent = lane.corr_by_coords.pop(coord, None)
                            if ent:
                                self._route_reply(
                                    ent[0], peer.name,
                                    "frame rejected on device sweep", True,
                                    decoded=True)
                    elif st == Status.NACK_UNCACHED:
                        peer.stats["nacks"] += 1
                        self.stats["nacks"] += 1
                        progressed = True
                        if rec is not None and o.enabled:
                            o.recorder.add("nack", peer.name,
                                           f"{rec.name} corr={rec.corr_id} "
                                           f"slim miss")
                            self._end_span(rec, status="nack")
                        if rec is not None and rec.handle is not None:
                            peer.cached.discard(rec.digest)
                            peer.resend.append(
                                self._rebuild_full(lane, slot - 1, rec))
                        else:
                            # a SLIM frame with no record or handle (a raw
                            # send): nothing to rebuild — surface the loss
                            peer.stats["nack_lost"] += 1
                    elif st == Status.IN_PROGRESS:
                        peer.stats["inflight_polls"] += 1
                err = self._sweep_raise or mb.pending_raise
                if err is not None:
                    # an ifunc raised behind frames this sweep consumed
                    # (the reply lane's _sweep_task or a plain sweep):
                    # their completions are processed above — now the
                    # exception surfaces
                    self._sweep_raise = None
                    mb.pending_raise = None
                    raise err
            self._rr += 1
        self.poll_replies()
        self.stats["polled"] += done
        return done

    def _pending_inflight(self) -> int:
        """Tracked frames still awaiting their target's sweep (host-lane
        records, pruning those consumed elsewhere; device corr ids and
        aggregates), plus queued resends and coalesced records."""
        n = 0
        for peer in self.peers.values():
            for lane in peer.rings:
                low = lane.mailbox.consumed
                for s in [s for s in lane.inflight if s < low]:
                    del lane.inflight[s]
                n += (len(lane.inflight) + len(lane.corr_by_coords)
                      + len(lane.agg_by_coords))
            n += len(peer.resend)
            n += sum(len(q.subs) for q in peer.coalesce.values())
        return n

    def _fail(self, corr: int, peer: Peer, msg: str) -> int:
        """Resolve one corr id with a TransportError; 1 if it carried one."""
        if not corr:
            return 0
        self._route_reply(corr, peer.name, TransportError(msg), True,
                          decoded=True)
        return 1

    def fail_inflight(self, reason: str = "liveness deadline exceeded",
                      min_age: float = 0.0,
                      peers: set | None = None) -> int:
        """Give up on tracked in-flight frames at least ``min_age`` seconds
        old: corr-carrying records resolve their futures with a
        TransportError through the reply router instead of hanging on a
        wedged peer, and the records and that peer's queued resends and
        coalesced records are dropped.  ``min_age`` makes this a per-frame
        floor: a healthy peer consuming its backlog only has young records
        and keeps them.  ``peers`` scopes the pass to named peers.  Returns
        the futures failed."""
        now = time.monotonic()
        o = self.obs
        failed = 0
        targets = (list(self.peers.values()) if peers is None
                   else [p for n, p in self.peers.items() if n in peers])
        for peer in targets:
            timed_out = 0
            for lane in peer.rings:
                low = lane.mailbox.consumed
                for slot in sorted(lane.inflight):
                    rec = lane.inflight[slot]
                    if slot >= low and now - rec.sent_at < min_age:
                        continue         # young: the peer may still be alive
                    del lane.inflight[slot]
                    self._end_span(rec, status="failed")
                    if slot < low:
                        continue
                    if o.enabled:
                        o.recorder.add(
                            "fail_inflight", peer.name,
                            f"{rec.name} corr={rec.corr_id} "
                            f"age={now - rec.sent_at:.3f}s")
                    if rec.subs is not None:
                        for sub in rec.subs:   # aggregate: fail per record
                            timed_out += self._fail(
                                sub.corr_id, peer,
                                f"{sub.name} (coalesced) to {peer.name!r}: "
                                f"{reason}")
                        continue
                    timed_out += self._fail(
                        rec.corr_id, peer,
                        f"{rec.name} to {peer.name!r}: {reason} "
                        f"(in flight {now - rec.sent_at:.3f}s)")
                for coords, (corr, sent_at) in list(
                        lane.corr_by_coords.items()):
                    if now - sent_at < min_age:
                        continue
                    del lane.corr_by_coords[coords]
                    timed_out += self._fail(
                        corr, peer, f"device lane {peer.name!r}: {reason}")
                for coords, rec in list(lane.agg_by_coords.items()):
                    if now - rec.sent_at < min_age:
                        continue         # device aggregate: fail per record
                    del lane.agg_by_coords[coords]
                    for sub in rec.subs or ():
                        timed_out += self._fail(
                            sub.corr_id, peer,
                            f"{sub.name} (device agg) to {peer.name!r}: "
                            f"{reason}")
            if timed_out:
                while peer.resend:       # resends to a dead peer: drop
                    msg = peer.resend.popleft()
                    timed_out += self._fail(
                        getattr(msg, "corr_id", 0), peer,
                        f"queued retransmit to {peer.name!r}: {reason}")
                for key in list(peer.coalesce):  # queued coalesced records
                    q = peer.coalesce.pop(key)   # to a dead peer: drop too
                    for sub in q.subs:
                        timed_out += self._fail(
                            sub.corr_id, peer,
                            f"queued coalesced {sub.name} to "
                            f"{peer.name!r}: {reason}")
                peer.stats["timed_out"] += timed_out
                failed += timed_out
        self.stats["timed_out"] += failed
        if failed and o.enabled:
            o.recorder.add("fail_inflight", "",
                           f"{failed} futures failed: {reason}")
            if o.dump_on_fail:
                o.dump(f"fail_inflight: {reason}")
        return failed

    def drain(self, max_rounds: int = 64, deadline: float | None = None) -> int:
        """flush + poll until quiescent: no outstanding puts, no consumable
        frames, no queued resends or coalesced records (or ``max_rounds``).
        Returns total messages delivered/rejected (a NACKed frame counts
        once, when its FULL rebuild lands).

        ``deadline`` (seconds) is the liveness floor: the drain cranks
        while tracked frames are in flight (``max_rounds`` does not apply;
        the bound is wall time), and once the deadline passes it fails,
        through :meth:`fail_inflight`, the futures of frames in flight for
        at least the whole deadline."""
        t0 = time.monotonic()
        total = 0
        rounds = 0
        while True:
            rounds += 1
            for p in self.peers.values():
                self._flush_resends(p)
                self._flush_coalesce_peer(p)   # drain = explicit flush
            self.engine.progress()
            n = self.poll()
            total += n
            idle = (n == 0 and self.engine.outstanding() == 0
                    and not any(p.resend or any(
                        q.subs for q in p.coalesce.values())
                        for p in self.peers.values()))
            if deadline is None:
                if idle or rounds >= max_rounds:
                    break
                continue
            if idle and self._pending_inflight() == 0:
                break
            if time.monotonic() - t0 >= deadline:
                self.obs.record(
                    "drain_deadline", "",
                    f"{deadline:.3g}s exceeded, "
                    f"{self._pending_inflight()} frames inflight")
                self.fail_inflight(
                    f"drain deadline ({deadline:.3g}s) exceeded",
                    min_age=deadline)
                break
            if idle:
                time.sleep(0)        # wedged-peer spin: yield the CPU
        return total

    # -- reporting ----------------------------------------------------------

    def per_peer_stats(self) -> dict[str, dict]:
        now = time.monotonic()
        return {name: dict(p.stats, credits=p.credits,
                           oldest_inflight_s=round(
                               p.oldest_inflight_age(now), 6))
                for name, p in self.peers.items()}

    def print_stats(self) -> None:
        for p in self.peers.values():
            print(" ", p.summary())


__all__ = ["DEFAULT_N_SLOTS", "DEFAULT_SLOT_SIZE", "Dispatcher", "Peer",
           "RingState"]
