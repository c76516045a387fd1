"""Multi-peer ifunc dispatcher: N peers x M rings, credit-based flow
control, per-peer backpressure, and a fairness-aware poll loop.

A :class:`Dispatcher` owns any number of :class:`Peer` s — each a
(fabric, channel(s), mailbox(s), target context) bundle — and

* ``send`` consumes a credit (one free ring slot) or reports backpressure
  instead of silently overwriting unconsumed frames;
* credits return as the target's sweep advances its mailbox ``consumed``
  counter (the credit-return counter a real target writes back);
* ``poll`` drains mailboxes round-robin, starting one past the lane served
  first last time, so a chatty peer cannot starve the rest;
* all sends go through a shared :class:`ProgressEngine`, so batching,
  in-flight windows, and completions are uniform across fabrics.

Every frame is packed straight into the engine's slab cell for its ring
slot.  Device-mesh lanes are always SLIM-eligible: the μVM program is
bound at mailbox-open time, so code words never travel — ``send`` elides
the code section while staging.

*Coalesced dispatch* (``FLAG_AGG``): with :meth:`set_coalescing` on, a
``send_ifunc`` / ``send_ifunc_many`` to a peer whose mailboxes are
agg-bound (``agg_k=``) does not claim a ring slot per invocation — the
records pack into ONE aggregate container (one put, one slot, one credit
for up to K invocations), flushed when the slot budget or the sub-record
cap fills, on an explicit ``flush``/``drain``, or when the oldest record
has waited ``max_age``.  A record above ``max_sub_bytes`` ships as a plain
SLIM singleton after the queue ahead of it, so per-peer FIFO holds.  The
target's sweep reports per-sub-record outcomes (``Mailbox.last_agg``):

* a SUB_READY record's result goes to ``target_args["results"]`` and, for
  a corr id, to ``reply_router``;
* a SUB_NACK record (its name is not the lane's bound program) is rebuilt
  alone as a FULL singleton on the resend queue, which posts ahead of new
  traffic once the peer's rings are quiescent; its siblings are not
  replayed;
* a SUB_BAD (poisoned) record gets an error reply, its siblings unharmed;
* a corrupt container is REJECTED whole: every corr id in it gets the
  error.

Device lanes have no reverse ring: sweep results *are* the replies,
correlated to corr ids by the coordinates each send staged into.

This package carries the device lanes only.  Host lanes (with their
digest confirmation and SLIM-miss retransmits), streams, the reply ring,
striping and liveness failure come with the modules they need.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from repro_torch.core import frame as F
from repro_torch.core.api import IfuncMsg, Status
from repro_torch.transport.fabric import Fabric, TransportError
from repro_torch.transport.progress import ProgressEngine

DEFAULT_SLOT_SIZE = 64 << 10
DEFAULT_N_SLOTS = 8

#: the per-peer stats schema, seeded at construction so
#: ``per_peer_stats()`` always returns the same keys
_PEER_STAT_KEYS = ("sent", "bytes", "delivered", "rejected", "backpressure",
                   "inflight_polls", "slim_sent", "nacks", "resent",
                   "replies", "coalesced", "agg_sent", "agg_subs",
                   "agg_harvest_lost")


@dataclass
class _TxRec:
    """Source-side record of one in-flight frame.  ``subs`` non-None marks
    an aggregate container: the :class:`_PendingSub` records it carries."""

    name: str
    digest: bytes
    handle: object          # IfuncHandle (None for raw-frame sends)
    slim: bool
    corr_id: int = 0
    sent_at: float = field(default_factory=time.monotonic)
    subs: list | None = None


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
    cont: bytes | None      # always None: device lanes carry no continuation
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
    corr_by_coords: dict = field(default_factory=dict)  # slot_coords ->
    #                                    corr_id of a singleton awaiting
    #                                    its sweep result
    agg_by_coords: dict = field(default_factory=dict)   # slot_coords ->
    #                                    _TxRec of a staged aggregate

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
    resend: deque = field(default_factory=deque)   # FULL msgs queued post-NACK
    coalesce: dict = field(default_factory=dict)   # ring key -> _CoalesceQ
    stats: dict = field(
        default_factory=lambda: dict.fromkeys(_PEER_STAT_KEYS, 0))

    @property
    def credits(self) -> int:
        return sum(r.credits for r in self.rings)

    def summary(self) -> str:
        s = self.stats
        agg = (f" agg={s['agg_sent']}x{s['agg_subs'] / s['agg_sent']:.1f}"
               if s["agg_sent"] else "")
        return (f"{self.name:<12s} fabric={self.fabric.kind:<9s} "
                f"sent={s['sent']:<4d} slim={s['slim_sent']:<4d} "
                f"delivered={s['delivered']:<4d} "
                f"rejected={s['rejected']:<3d} nacks={s['nacks']:<3d} "
                f"backpressure={s['backpressure']:<3d} "
                f"credits={self.credits}{agg}")


def _args_size(source_args, source_args_size):
    if source_args_size is not None:
        return source_args_size
    try:
        return len(source_args)
    except TypeError:
        return 0


class Dispatcher:
    """One source fanning ifunc frames out to device-mesh targets."""

    def __init__(self, src_ctx=None, engine: ProgressEngine | None = None):
        self.src_ctx = src_ctx
        self.engine = engine if engine is not None else ProgressEngine()
        self.peers: dict[str, Peer] = {}
        self._rr = 0             # fairness cursor over (peer, ring) lanes
        self.stats = {"sent": 0, "polled": 0, "poll_rounds": 0, "nacks": 0,
                      "replies": 0, "reply_dropped": 0, "agg_sent": 0}
        # the router receives (corr_id, name, value, is_err, decoded) for
        # every corr-carrying send once its result (or error) is known
        self.reply_router = None
        self._coalesce = False
        self._agg_max_subs = 16
        self._agg_max_age = 5e-4
        self._agg_max_sub_bytes = 16 << 10

    def set_coalescing(self, enabled: bool = True, *, max_subs: int = 16,
                       max_age: float = 5e-4,
                       max_sub_bytes: int = 16 << 10) -> None:
        """Turn coalesced dispatch on/off.  ``max_subs`` caps sub-records
        per aggregate (also capped by each lane's ``agg_k``); ``max_age``
        (seconds) bounds how long the oldest queued record may wait before
        a poll flushes its queue; a record above ``max_sub_bytes`` bypasses
        the queue as a plain SLIM singleton.  A device lane's payloads are
        whole tiles (64 KiB each), so to coalesce them ``max_sub_bytes``
        must be raised past the default."""
        if max_subs < 1:
            raise TransportError(f"max_subs must be >= 1, got {max_subs}")
        self._coalesce = enabled
        self._agg_max_subs = max_subs
        self._agg_max_age = max_age
        self._agg_max_sub_bytes = max_sub_bytes

    # -- topology -----------------------------------------------------------

    def add_peer(self, name: str, fabric: Fabric, target_ctx, *,
                 n_slots: int = DEFAULT_N_SLOTS,
                 slot_size: int = DEFAULT_SLOT_SIZE,
                 rings: int = 1, target_args: dict | None = None,
                 **mailbox_kw) -> Peer:
        """``mailbox_kw`` passes backend-specific binds through to
        ``fabric.open_mailbox`` (``prog=``/``externals=``/``n_tiles=``/
        ``agg_k=``/``prog_name=`` on the device-mesh fabric)."""
        if name in self.peers:
            raise TransportError(f"peer {name!r} already attached")
        if fabric.kind != "device":
            raise TransportError(
                f"{fabric.kind!r} lanes are not ported yet (device only)")
        peer = Peer(name, fabric, target_ctx,
                    target_args if target_args is not None else {})
        for _ in range(rings):
            mb = fabric.open_mailbox(target_ctx, n_slots, slot_size,
                                     **mailbox_kw)
            ch = fabric.connect(self.src_ctx, mb)
            peer.rings.append(RingState(mb, ch))
        self.peers[name] = peer
        return peer

    # -- source side --------------------------------------------------------

    @staticmethod
    def _slim_ok(peer: Peer, lib) -> bool:
        """SLIM-eligible: device lanes link at mailbox-open time, so code
        never travels."""
        return peer.fabric.kind == "device"

    @staticmethod
    def _agg_eligible(peer: Peer) -> bool:
        """Aggregate-eligible: every mailbox of the peer was opened
        agg-bound (``agg_k=``)."""
        return all(r.mailbox.supports_agg for r in peer.rings)

    @staticmethod
    def _pick_lane(peer: Peer, ring: int | None) -> RingState | None:
        lanes = peer.rings if ring is None else [peer.rings[ring]]
        lane = max(lanes, key=lambda r: r.credits)
        return lane if lane.credits > 0 else None

    @staticmethod
    def _bp(peer: Peer) -> None:
        peer.stats["backpressure"] += 1

    def _post_view(self, peer: Peer, lane: RingState, view, rec,
                   on_complete) -> None:
        self.engine.post(lane.channel, view, lane.tail, peer=peer.name,
                         on_complete=on_complete)
        if rec is not None:
            # device results come back by the coordinates this send
            # stages into (the Mailbox.slot_coords contract)
            coords = lane.mailbox.slot_coords(lane.tail)
            if rec.subs is not None:
                lane.agg_by_coords[coords] = rec
            elif rec.corr_id:
                lane.corr_by_coords[coords] = rec.corr_id
        lane.tail += 1
        peer.stats["sent"] += 1
        peer.stats["bytes"] += len(view)
        if rec is not None and rec.slim:
            peer.stats["slim_sent"] += 1
        self.stats["sent"] += 1

    def _slab_post(self, peer: Peer, lane: RingState, frame, rec,
                   on_complete=None) -> None:
        """Stage a ready frame into the lane's slab cell and post it."""
        slab = self.engine.slab_slot(lane.channel, lane.tail)
        n = len(frame)
        if n > len(slab):
            raise TransportError(
                f"frame {n}B exceeds slot {lane.mailbox.slot_size}B")
        slab[:n] = frame
        self._post_view(peer, lane, slab[:n], rec, on_complete)

    def _flush_resends(self, peer: Peer) -> bool:
        """Post queued FULL rebuilds (a NACKed sub-record's fallback) ahead
        of any new traffic; False while the queue cannot drain.  They wait
        until the peer's rings are quiescent (every frame in flight
        resolved), so the resend queue replays ring order."""
        if not peer.resend:
            return True
        if any(r.tail != r.mailbox.consumed for r in peer.rings):
            return False
        while peer.resend:
            lane = self._pick_lane(peer, None)
            if lane is None:
                return False
            msg = peer.resend.popleft()
            lib = msg.handle.lib
            self._slab_post(peer, lane, msg.frame,
                            _TxRec(lib.name, lib.code_digest, msg.handle,
                                   slim=False, corr_id=msg.corr_id))
            peer.stats["resent"] += 1
        return True

    def send(self, peer_name: str, msg, *, ring: int | None = None,
             on_complete=None) -> bool:
        """Post one ifunc message to a peer.  Returns False (and counts a
        backpressure event) when every eligible ring is out of credits, or
        resends or coalesced records queued ahead of it cannot post yet.

        The frame is staged into the engine's slab cell for the chosen ring
        slot, with the code section elided on the fly when the peer links
        at open time (SLIM framing)."""
        peer = self.peers[peer_name]
        if not (self._flush_resends(peer)
                and self._flush_coalesce_peer(peer)):
            self._bp(peer)               # FIFO: what is queued goes first
            return False
        lane = self._pick_lane(peer, ring)
        if lane is None:
            self._bp(peer)
            return False
        frame = msg.frame if hasattr(msg, "frame") else msg
        handle = getattr(msg, "handle", None)
        if handle is None:                       # raw frame: no slim protocol
            self._slab_post(peer, lane, frame, None, on_complete)
            return True
        lib = handle.lib
        corr_id = getattr(msg, "corr_id", 0)
        if getattr(msg, "cont", None) is not None:
            raise TransportError(
                "continuation frames are host-tier only (the device sweep "
                "has no forwarding hook)")
        already_slim = bool(getattr(msg, "slim", False))
        want_slim = self._slim_ok(peer, lib)
        rec = _TxRec(lib.name, lib.code_digest, handle,
                     already_slim or want_slim, corr_id=corr_id)
        if want_slim and not already_slim:
            # elide the code section while staging — the slab cell is the
            # only buffer the SLIM frame ever occupies
            slab = self.engine.slab_slot(lane.channel, lane.tail)
            n = F.pack_frame_into(slab, lib.name, b"", msg.payload_view,
                                  lib.kind, digest=lib.code_digest, slim=True,
                                  corr_id=corr_id)
            self._post_view(peer, lane, slab[:n], rec, on_complete)
        else:
            self._slab_post(peer, lane, frame, rec, on_complete)
        return True

    def send_ifunc(self, peer_name: str, handle, source_args,
                   source_args_size: int | None = None, *,
                   ring: int | None = None, on_complete=None,
                   corr_id: int = 0) -> bool:
        """Zero-copy send: the payload codec writes straight into the
        peer's slab cell and the header is sealed around it in place.  With
        coalescing on and an agg-bound peer, the record queues for an
        aggregate instead.  ``corr_id`` nonzero routes the result to
        ``reply_router``."""
        peer = self.peers[peer_name]
        if (self._coalesce and on_complete is None
                and self._agg_eligible(peer)):
            return self._enqueue_sub(peer, handle, source_args,
                                     source_args_size, ring, corr_id)
        if not (self._flush_resends(peer)
                and self._flush_coalesce_peer(peer)):
            self._bp(peer)               # FIFO: what is queued goes first
            return False
        lane = self._pick_lane(peer, ring)
        if lane is None:
            self._bp(peer)
            return False
        lib = handle.lib
        source_args_size = _args_size(source_args, source_args_size)
        max_size = int(lib.payload_get_max_size(source_args, source_args_size))
        slim = self._slim_ok(peer, lib)
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
                               corr_id=corr_id), on_complete)
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
                     ring, corr_id) -> bool:
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
        sub = _PendingSub(handle, lib.name, lib.kind, lib.code_digest,
                          payload, corr_id, None, time.monotonic())
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
                        ring: int | None = None, corr_ids=None) -> int:
        """Bulk coalescing send: K invocations of one handle in one call.
        ``corr_ids`` (a parallel list) routes results to ``reply_router``.
        Returns the number of records accepted, stopping early at one it
        cannot accept (backpressure).  Falls back to per-record
        :meth:`send_ifunc` when coalescing is off or the peer is not
        aggregate-eligible."""
        peer = self.peers[peer_name]
        if not (self._coalesce and self._agg_eligible(peer)):
            n = 0
            for i, args in enumerate(payloads):
                if not self.send_ifunc(peer_name, handle, args, ring=ring,
                                       corr_id=corr_ids[i] if corr_ids
                                       else 0):
                    break
                n += 1
            return n
        lib = handle.lib
        lane0 = peer.rings[ring if ring is not None else 0]
        gms, init = lib.payload_get_max_size, lib.payload_init
        name, kind, digest = lib.name, lib.kind, lib.code_digest
        kind_int = int(kind)
        max_subs = min(self._agg_max_subs, lane0.mailbox.agg_k)
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
                                           corr_id=cid), None)
                    n += 1
                    i += 1
                    continue
                off = prologue_end = F.begin_agg(view, [name])
                budget = len(view) - 4
                hdrs: list[tuple] = []
                subs: list[_PendingSub] = []
                while i < N and len(subs) < max_subs:
                    args = payloads[i]
                    sz = _args_size(args, None)
                    mx = int(gms(args, sz))
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
                        cid, None, now))
                    off += used
                    i += 1
                if not subs:
                    break                # one record overflows the slot:
                    #                      the queue path reports it
                plen = F.finish_agg(view, prologue_end, off, hdrs)
                fl = F.seal_frame(slab, F.AGG_NAME, b"", kind, plen,
                                  digest=F.NO_DIGEST, flags=F.FLAG_AGG)
                self._post_view(peer, lane, slab[:fl],
                                _TxRec(F.AGG_NAME, F.NO_DIGEST, None,
                                       slim=True, subs=subs), None)
                peer.stats["agg_sent"] += 1
                peer.stats["agg_subs"] += len(subs)
                peer.stats["coalesced"] += len(subs)
                self.stats["agg_sent"] += 1
                n += len(subs)

        # -- the queue path: records behind an existing queue, and the
        # -- leftovers of backpressure — ONE implementation of the policy
        while i < N:
            if not self._enqueue_sub(peer, handle, payloads[i], None, ring,
                                     corr_ids[i] if corr_ids else 0):
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
                                   slim=True, corr_id=sub.corr_id), None)
            return
        # the container header carries the records' code kind: the device
        # put rejects non-UVM frames at the header
        n = F.seal_agg_frame(slab, subs, kind=subs[0].kind)
        self._post_view(peer, lane, slab[:n],
                        _TxRec(F.AGG_NAME, F.NO_DIGEST, None, slim=True,
                               subs=list(subs)), None)
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
            max_subs = min(self._agg_max_subs, mb0.agg_k)
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

    def flush_coalesced(self, peer_name: str | None = None) -> bool:
        """Explicit coalescing-queue flush (all peers by default); False
        when a queue could not fully drain."""
        if peer_name is not None:
            return self._flush_coalesce_peer(self.peers[peer_name])
        ok = True
        for p in self.peers.values():
            ok = self._flush_coalesce_peer(p) and ok
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

    def _route_reply(self, corr: int, name: str, value, is_err: bool,
                     decoded: bool) -> None:
        if self.reply_router is None:
            self.stats["reply_dropped"] += 1
            return
        self.reply_router(corr, name, value, is_err, decoded)

    def _complete_agg(self, peer: Peer, lane: RingState, rec: _TxRec,
                      coords) -> int:
        """Source-side completion of one delivered aggregate: walk the
        per-sub outcomes the sweep left in ``Mailbox.last_agg`` under
        ``coords``, queue a FULL-singleton rebuild for each NACKed record
        (its executed siblings are never replayed), and route each
        corr-carrying record's value or error to ``reply_router``.
        Returns the consumed (OK or rejected) sub-records: the container's
        share of the poll budget."""
        results = lane.mailbox.last_agg.pop(coords, None)
        if results is not None and len(results) != len(rec.subs):
            # a harvest that does not match the container sent: per-index
            # outcomes would be misattributed — delivered, without detail
            peer.stats["agg_harvest_lost"] += 1
            results = None
        consumed = n_ok = n_rej = n_nack = 0
        replies = []
        for i, sub in enumerate(rec.subs):
            res = results[i] if results is not None else None
            st = Status.OK if res is None else res.status
            if st == Status.NACK_UNCACHED:
                n_nack += 1
                lib = sub.handle.lib
                frame = F.pack_frame(lib.name, lib.code, sub.payload,
                                     lib.kind, digest=lib.code_digest,
                                     corr_id=sub.corr_id)
                peer.resend.append(IfuncMsg(sub.handle, frame, slim=False,
                                            corr_id=sub.corr_id))
                continue
            consumed += 1
            if st == Status.REJECTED:
                n_rej += 1
                if sub.corr_id:
                    replies.append((sub.corr_id, res.error, True))
                continue
            n_ok += 1
            if sub.corr_id:
                replies.append((sub.corr_id,
                                None if res is None else res.value, False))
        s = peer.stats
        s["delivered"] += n_ok
        s["rejected"] += n_rej
        s["nacks"] += n_nack
        self.stats["nacks"] += n_nack
        for corr, value, is_err in replies:
            self._route_reply(corr, peer.name, value, is_err, decoded=True)
        s["replies"] += len(replies)
        self.stats["replies"] += len(replies)
        return consumed

    def poll(self, budget: int | None = None) -> int:
        """Drain up to ``budget`` messages total across all peers' rings,
        round-robin, starting one lane past last round's first server.  A
        device-mesh lane sweeps whole-ring (its sweep is one pass over every
        slot) and an aggregate container yields all its sub-records at
        once, so a poll can overshoot ``budget`` by one sweep.  Results of
        corr-carrying sends go to ``reply_router``; they do not count
        against ``budget``.  Returns the messages delivered or rejected."""
        if self._coalesce:
            self._age_flush()            # no record waits past max_age
        lanes = self._lanes()
        if not lanes:
            return 0
        done = 0
        self.stats["poll_rounds"] += 1
        progressed = True
        while progressed and (budget is None or done < budget):
            progressed = False
            start = self._rr % len(lanes)
            for k in range(len(lanes)):
                peer, lane = lanes[(start + k) % len(lanes)]
                if budget is not None and done >= budget:
                    break
                mb = lane.mailbox
                res_before = len(mb.results)
                sts = mb.sweep(peer.target_ctx, peer.target_args, budget=1)
                # one results entry per consumed OK container or frame: a
                # cursor over them keeps later statuses aligned
                res_new = iter(mb.results[res_before:])
                for st, coord in zip(sts, mb.last_coords):
                    if st == Status.OK:
                        progressed = True
                        val = next(res_new, None)
                        rec = lane.agg_by_coords.pop(coord, None)
                        if rec is not None:
                            done += self._complete_agg(peer, lane, rec, coord)
                            continue
                        peer.stats["delivered"] += 1
                        done += 1
                        corr = lane.corr_by_coords.pop(coord, 0)
                        if corr:         # device reply: the result IS it
                            self._route_reply(corr, peer.name, val, False,
                                              decoded=True)
                    elif st == Status.REJECTED:
                        peer.stats["rejected"] += 1
                        done += 1
                        progressed = True
                        rec = lane.agg_by_coords.pop(coord, None)
                        if rec is not None:
                            # whole container rejected: every corr-carrying
                            # record resolves with the error, none ran
                            for sub in rec.subs:
                                if sub.corr_id:
                                    self._route_reply(
                                        sub.corr_id, peer.name,
                                        TransportError(
                                            "aggregate container rejected"),
                                        True, decoded=True)
                        corr = lane.corr_by_coords.pop(coord, 0)
                        if corr:
                            self._route_reply(
                                corr, peer.name,
                                "frame rejected on device sweep", True,
                                decoded=True)
                    elif st == Status.IN_PROGRESS:
                        peer.stats["inflight_polls"] += 1
            self._rr += 1
        self.stats["polled"] += done
        return done

    def drain(self, max_rounds: int = 64) -> int:
        """flush + poll until quiescent: no outstanding puts, no consumable
        frames, no queued resends or coalesced records (or ``max_rounds``).
        Returns total messages delivered/rejected (a NACKed sub-record
        counts once, when its FULL rebuild lands)."""
        total = 0
        for _ in range(max_rounds):
            for p in self.peers.values():
                self._flush_resends(p)
                self._flush_coalesce_peer(p)   # drain = explicit flush
            self.engine.progress()
            n = self.poll()
            total += n
            if (n == 0 and self.engine.outstanding() == 0
                    and not any(p.resend or p.coalesce
                                for p in self.peers.values())):
                break
        return total

    # -- reporting ----------------------------------------------------------

    def per_peer_stats(self) -> dict[str, dict]:
        return {name: dict(p.stats, credits=p.credits)
                for name, p in self.peers.items()}

    def print_stats(self) -> None:
        for p in self.peers.values():
            print(" ", p.summary())


__all__ = ["DEFAULT_N_SLOTS", "DEFAULT_SLOT_SIZE", "Dispatcher", "Peer",
           "RingState"]
