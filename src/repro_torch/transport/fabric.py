"""Pluggable fabric layer: the transport contract every ifunc backend sits
on.

Three roles, mirroring a thin UCX:

* :class:`Mailbox`  — a target-owned ring of fixed-size frame slots.  The
  host fabrics expose byte slots polled by ``poll_ifunc``; the device
  fabric exposes word-frame slots swept by one fused sweep kernel.
* :class:`Channel`  — a source-side one-sided path into one mailbox.  A
  ``put`` is non-blocking: bytes may be partially visible until
  ``flush`` (the in-flight window the frame trailer exists for).
* :class:`Fabric`   — the factory tying the two together for one backend.

Backends: :class:`RdmaFabric` (wraps ``core/rdma.py``) and
:class:`LoopbackFabric` (zero-copy in-process, the stand-in for
bus-attached targets) here, ``DeviceMeshFabric`` in ``device_fabric.py``.
Nothing outside ``repro_torch.transport`` calls ``Endpoint.put_nbi``:
higher layers speak Channel/Mailbox only.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from repro_torch.core import frame as F
from repro_torch.core import rdma as R


class TransportError(Exception):
    pass


_API = None      # repro_torch.core.api, imported lazily (api imports the
#                  transport at call time) and memoized off the sweep loop


def _api():
    global _API
    if _API is None:
        from repro_torch.core import api
        _API = api
    return _API


# ---------------------------------------------------------------------------
# contracts


class Mailbox:
    """A target-owned ring of ``n_slots`` frame slots of ``slot_size`` bytes.

    ``head`` is the consume index (advanced by the poller); the produce index
    lives with the source-side Channel.  ``consumed`` is the monotone count
    of drained slots — the source reads it to compute returned credits.
    """

    fabric: "Fabric"
    n_slots: int
    slot_size: int

    def __init__(self):
        self.head = 0
        self.consumed = 0
        #: coordinates of each status the most recent :meth:`sweep`
        #: returned, in order (see :meth:`slot_coords`)
        self.last_coords: list = []
        #: per-sub-record outcomes of each aggregate container a sweep
        #: consumed, keyed by its coordinate; popped by the dispatcher's
        #: aggregate completion, bounded by the mailbox that fills it
        self.last_agg: dict = {}
        #: an ifunc exception raised by a slot *behind* frames this sweep
        #: already consumed: the batch stops, the consumed frames' statuses
        #: are returned, and the caller re-raises this after processing
        #: them.  The poisoned slot itself is NOT consumed.
        self.pending_raise: BaseException | None = None

    def slot_coords(self, i: int):
        """Stable coordinate a produce index maps to (what ``last_coords``
        entries are keyed by).  Identity for in-order rings."""
        return i

    def slot_view(self, i: int) -> memoryview:
        raise NotImplementedError

    def peek(self):
        """Best-effort parsed header of the frame at ``head``, or None when
        the slot is empty/unparsable or the backend exposes no byte view
        (the device mesh)."""
        try:
            return F.peek_header(self.slot_view(self.head))
        except (F.FrameError, TransportError, NotImplementedError):
            return None

    def sweep(self, ctx, target_args, budget: int | None = None) -> list:
        """Drain up to ``budget`` slots through ``poll_ifunc``; returns the
        per-slot Status values observed.  OK/REJECTED/NACK_UNCACHED all
        consume the slot and advance head (a NACKed SLIM frame is cleared —
        the retransmit arrives as a fresh FULL frame).  A caller sweeping a
        mailbox directly must send FULL frames or handle NACK_UNCACHED in
        the returned statuses itself."""
        A = _api()

        out = []
        self.last_coords = []
        budget = self.n_slots if budget is None else budget
        obs = getattr(ctx, "obs", None)
        t0 = (time.perf_counter() if obs is not None and obs.enabled
              else None)
        consumed0 = self.consumed
        for _ in range(budget):
            try:
                st = A.poll_ifunc(ctx, self.slot_view(self.head), None,
                                  target_args)
            except Exception as e:       # raised *inside* an ifunc
                if not out:
                    raise                # first slot: surfaces at once
                self.pending_raise = e   # mid-batch: don't discard the
                break                    # consumed frames' statuses
            out.append(st)
            coords = self.slot_coords(self.head)
            self.last_coords.append(coords)
            agg = getattr(ctx, "last_agg_results", None)
            if agg is not None:
                # a FLAG_AGG container was consumed at this slot: stash its
                # per-sub-record outcomes under the slot's coordinate
                self.last_agg[coords] = agg
                ctx.last_agg_results = None
                while len(self.last_agg) > 2 * self.n_slots:
                    self.last_agg.pop(next(iter(self.last_agg)))
            if st in (A.Status.OK, A.Status.REJECTED, A.Status.NACK_UNCACHED):
                self.head += 1
                self.consumed += 1
            else:
                break
        if t0 is not None and self.consumed != consumed0:
            # only sweeps that consumed something observe: idle polls would
            # flood the distribution with empty-peek latencies
            obs.sweep_hist.observe((time.perf_counter() - t0) * 1e6)
        return out


class Channel:
    """Source-side one-sided path into one remote Mailbox."""

    mailbox: Mailbox

    def __init__(self):
        self.stats = {"puts": 0, "bytes": 0, "flushes": 0, "partial": 0}

    def put(self, data, slot: int, *, deliver_bytes: int | None = None) -> None:
        """Non-blocking write of ``data`` into ring slot ``slot``.  With
        ``deliver_bytes`` only a prefix is visible until :meth:`flush`."""
        raise NotImplementedError

    def put_at(self, data, slot: int, offset: int, *,
               deliver_bytes: int | None = None) -> None:
        """Non-blocking write of ``data`` at byte ``offset`` *within* ring
        slot ``slot``; same delivery semantics as :meth:`put`
        (``deliver_bytes=0`` withholds the whole write until
        :meth:`flush`).  Backends without sub-slot addressing (the device
        mesh) don't implement it."""
        raise NotImplementedError

    def putv_at(self, segs, slot: int, *, withhold_tail: int = 0) -> None:
        """Scatter-gather write into ring slot ``slot``: ``segs`` is a
        sequence of ``(offset, data)`` pairs posted as ONE work request.
        ``withhold_tail`` keeps the last N bytes of the final segment
        invisible until :meth:`flush`.  RDMA-class backends post it as
        one multi-SGE work request; the device mesh doesn't implement it."""
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError


class Fabric:
    """One transport backend: makes mailboxes on targets, channels to them."""

    kind: str = "abstract"

    def open_mailbox(self, target_ctx, n_slots: int, slot_size: int) -> Mailbox:
        raise NotImplementedError

    def connect(self, src_ctx, mailbox: Mailbox) -> Channel:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# RDMA fabric (wraps core/rdma.py)


class RdmaMailbox(Mailbox):
    """Composes rdma.RingBuffer for all slot math."""

    def __init__(self, fabric: "RdmaFabric", region: R.MemRegion,
                 slot_size: int):
        super().__init__()
        self.fabric = fabric
        self.region = region
        self.ring = R.RingBuffer(region, slot_size)
        self.slot_size = slot_size
        self.n_slots = self.ring.n_slots

    def slot_addr(self, i: int) -> int:
        return self.ring.slot_addr(i)

    def slot_view(self, i: int) -> memoryview:
        return self.ring.slot_view(i)


class RdmaChannel(Channel):
    def __init__(self, ep: R.Endpoint, mailbox: RdmaMailbox):
        super().__init__()
        self.ep = ep
        self.mailbox = mailbox

    def put(self, data, slot: int, *, deliver_bytes: int | None = None) -> None:
        if len(data) > self.mailbox.slot_size:
            raise TransportError(
                f"frame {len(data)}B exceeds slot {self.mailbox.slot_size}B")
        self.ep.put_nbi(data, self.mailbox.slot_addr(slot),
                        self.mailbox.region.rkey, deliver_bytes=deliver_bytes)
        self.stats["puts"] += 1
        self.stats["bytes"] += len(data)
        if deliver_bytes is not None and deliver_bytes < len(data):
            self.stats["partial"] += 1

    def put_at(self, data, slot: int, offset: int, *,
               deliver_bytes: int | None = None) -> None:
        if offset + len(data) > self.mailbox.slot_size:
            raise TransportError(
                f"put_at [{offset}, {offset + len(data)}) exceeds slot "
                f"{self.mailbox.slot_size}B")
        self.ep.put_nbi(data, self.mailbox.slot_addr(slot) + offset,
                        self.mailbox.region.rkey, deliver_bytes=deliver_bytes)
        self.stats["puts"] += 1
        self.stats["bytes"] += len(data)
        if deliver_bytes is not None and deliver_bytes < len(data):
            self.stats["partial"] += 1

    def putv_at(self, segs, slot: int, *, withhold_tail: int = 0) -> None:
        extent = 0
        nbytes = 0
        for off, d in segs:
            nbytes += len(d)
            end = off + len(d)
            extent = end if end > extent else extent
        if extent > self.mailbox.slot_size:
            raise TransportError(
                f"putv extent {extent}B exceeds slot "
                f"{self.mailbox.slot_size}B")
        self.ep.putv_nbi(segs, self.mailbox.slot_addr(slot),
                         self.mailbox.region.rkey,
                         withhold_tail=withhold_tail)
        self.stats["puts"] += 1
        self.stats["bytes"] += nbytes
        if withhold_tail:
            self.stats["partial"] += 1

    def put_raw(self, data, remote_addr: int, rkey: int, *,
                deliver_bytes: int | None = None) -> None:
        """Address-directed put for legacy callers (``ifunc_msg_send_nbix``
        with an explicit remote_addr/rkey, the AM baseline's eager slots)."""
        self.ep.put_nbi(data, remote_addr, rkey, deliver_bytes=deliver_bytes)
        self.stats["puts"] += 1
        self.stats["bytes"] += len(data)

    def flush(self) -> None:
        self.ep.flush()
        self.stats["flushes"] += 1


class RdmaFabric(Fabric):
    """Emulated-RDMA backend: mailboxes are ``mem_map``-ed regions, channels
    are NIC endpoints; every inbound put is rkey/bounds-checked by the
    'HCA' before any byte moves."""

    kind = "rdma"

    def open_mailbox(self, target_ctx, n_slots: int,
                     slot_size: int) -> RdmaMailbox:
        nic = target_ctx.nic if hasattr(target_ctx, "nic") else target_ctx
        region = nic.mem_map(n_slots * slot_size)
        return RdmaMailbox(self, region, slot_size)

    def connect(self, src_ctx, mailbox: RdmaMailbox) -> RdmaChannel:
        nic = src_ctx.nic if hasattr(src_ctx, "nic") else src_ctx
        return RdmaChannel(nic.connect(mailbox.region.nic), mailbox)

    @staticmethod
    def channel_for_endpoint(ep: R.Endpoint) -> "RdmaChannel":
        """Wrap a bare Endpoint for address-directed legacy sends (no ring)."""
        ch = RdmaChannel.__new__(RdmaChannel)
        Channel.__init__(ch)
        ch.ep = ep
        ch.mailbox = None
        return ch


# ---------------------------------------------------------------------------
# Loopback fabric (zero-copy in-process; the bus-attached target backend)


@dataclass
class _PendingLoopPut:
    buf: bytearray
    off: int            # where the withheld tail lands at flush
    tail: bytes


class LoopbackMailbox(Mailbox):
    def __init__(self, fabric: "LoopbackFabric", n_slots: int,
                 slot_size: int):
        super().__init__()
        self.fabric = fabric
        self.n_slots, self.slot_size = n_slots, slot_size
        self.buf = bytearray(n_slots * slot_size)

    def slot_view(self, i: int) -> memoryview:
        off = (i % self.n_slots) * self.slot_size
        return memoryview(self.buf)[off:off + self.slot_size]


class LoopbackChannel(Channel):
    """Writes straight into the mailbox's buffer; a withheld tail waits in
    ``_pending`` until :meth:`flush`."""

    def __init__(self, mailbox: LoopbackMailbox):
        super().__init__()
        self.mailbox = mailbox
        self._pending: list[_PendingLoopPut] = []

    def _write(self, mv, at: int, n: int) -> None:
        """Land the first ``n`` bytes of ``mv`` at buffer offset ``at`` and
        withhold the rest until flush."""
        buf = self.mailbox.buf
        if n:
            buf[at:at + n] = mv[:n]
        if n < len(mv):
            self._pending.append(_PendingLoopPut(buf, at + n, bytes(mv[n:])))
            self.stats["partial"] += 1

    def put(self, data, slot: int, *, deliver_bytes: int | None = None) -> None:
        mb = self.mailbox
        nd = len(data)
        if nd > mb.slot_size:
            raise TransportError(
                f"frame {nd}B exceeds slot {mb.slot_size}B")
        mv = data if isinstance(data, memoryview) else memoryview(data)
        self._write(mv, (slot % mb.n_slots) * mb.slot_size,
                    nd if deliver_bytes is None else min(deliver_bytes, nd))
        self.stats["puts"] += 1
        self.stats["bytes"] += nd

    def put_at(self, data, slot: int, offset: int, *,
               deliver_bytes: int | None = None) -> None:
        mb = self.mailbox
        nd = len(data)
        if offset + nd > mb.slot_size:
            raise TransportError(
                f"put_at [{offset}, {offset + nd}) exceeds slot "
                f"{mb.slot_size}B")
        mv = data if isinstance(data, memoryview) else memoryview(data)
        self._write(mv, (slot % mb.n_slots) * mb.slot_size + offset,
                    nd if deliver_bytes is None else min(deliver_bytes, nd))
        self.stats["puts"] += 1
        self.stats["bytes"] += nd

    def putv_at(self, segs, slot: int, *, withhold_tail: int = 0) -> None:
        mb = self.mailbox
        base = (slot % mb.n_slots) * mb.slot_size
        last = len(segs) - 1
        nbytes = 0
        for i, (off, d) in enumerate(segs):
            mv = d if isinstance(d, memoryview) else memoryview(d)
            nd = len(mv)
            nbytes += nd
            if off + nd > mb.slot_size:
                raise TransportError(
                    f"putv [{off}, {off + nd}) exceeds slot {mb.slot_size}B")
            self._write(mv, base + off,
                        max(nd - withhold_tail, 0)
                        if withhold_tail and i == last else nd)
        self.stats["puts"] += 1
        self.stats["bytes"] += nbytes

    def flush(self) -> None:
        for p in self._pending:
            p.buf[p.off:p.off + len(p.tail)] = p.tail
        self._pending.clear()
        self.stats["flushes"] += 1


class LoopbackFabric(Fabric):
    """In-process zero-copy backend: no NIC, no rkeys — the floor every
    latency number compares against, and the stand-in for bus-attached
    targets (CSDs) whose 'network' is a memory bus."""

    kind = "loopback"

    def open_mailbox(self, target_ctx, n_slots: int,
                     slot_size: int) -> LoopbackMailbox:
        return LoopbackMailbox(self, n_slots, slot_size)

    def connect(self, src_ctx, mailbox: LoopbackMailbox) -> LoopbackChannel:
        return LoopbackChannel(mailbox)


class LegacyRingMailbox(Mailbox):
    """Adapter: an ``rdma.RingBuffer`` viewed as a transport Mailbox, so
    ``poll_ring`` drains through the same sweep path as everything else.
    Head state stays on the RingBuffer."""

    def __init__(self, ring: R.RingBuffer):
        Mailbox.__init__(self)
        self.ring = ring
        self.n_slots = ring.n_slots
        self.slot_size = ring.slot_size

    @property
    def head(self) -> int:
        return self.ring.head

    @head.setter
    def head(self, v: int) -> None:
        # Mailbox.__init__ assigns head=0 before self.ring exists; swallow it.
        if hasattr(self, "ring"):
            self.ring.head = v

    def slot_view(self, i: int) -> memoryview:
        return self.ring.slot_view(i)


def ring_mailbox(ring: R.RingBuffer) -> LegacyRingMailbox:
    """Cached LegacyRingMailbox for a RingBuffer (keeps ``consumed`` stable
    across calls so credit math works)."""
    mb = getattr(ring, "_transport_mailbox", None)
    if mb is None:
        mb = LegacyRingMailbox(ring)
        ring._transport_mailbox = mb
    return mb


def endpoint_channel(ep: R.Endpoint) -> RdmaChannel:
    """Cached raw channel for a bare Endpoint (legacy address-directed
    sends route through the transport layer via this)."""
    ch = getattr(ep, "_transport_channel", None)
    if ch is None:
        ch = RdmaFabric.channel_for_endpoint(ep)
        ep._transport_channel = ch
    return ch


def frame_fits(frame, mailbox: Mailbox) -> bool:
    return len(frame) <= mailbox.slot_size


__all__ = ["Channel", "Fabric", "LegacyRingMailbox", "LoopbackChannel",
           "LoopbackFabric", "LoopbackMailbox", "Mailbox", "RdmaChannel",
           "RdmaFabric", "RdmaMailbox", "TransportError", "endpoint_channel",
           "frame_fits", "ring_mailbox"]
