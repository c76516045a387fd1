"""RDMA fabric emulation: mapped memory regions, rkeys, one-sided puts.

Models the IBTA semantics the paper relies on (§3.5): memory must be
registered (``mem_map``) to be remotely accessible; the NIC generates a
32-bit RKEY from the registration; every inbound one-sided access is
checked against rkey + permissions + bounds *before any byte moves* and
rejected "at the hardware level" otherwise.

Delivery semantics match what the frame protocol needs: bytes of a put
land in order, but a put may be observed *partially complete* until the
endpoint is flushed — this is why the trailer signal exists, and the tests
exercise exactly that window (``deliver_bytes`` knob).

A copy of ``repro.core.rdma`` (the port imports nothing of the JAX
package): the same checks, in the same order, on the same bytes.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from enum import Flag, auto


class RdmaError(Exception):
    pass


class AccessDenied(RdmaError):
    """Invalid rkey / permission / bounds — request rejected by the 'HCA'."""


class Access(Flag):
    READ = auto()
    WRITE = auto()
    ATOMIC = auto()
    RW = READ | WRITE


@dataclass
class MemRegion:
    nic: "Nic"
    base: int
    buf: bytearray
    rkey: int
    access: Access

    @property
    def size(self) -> int:
        return len(self.buf)

    def view(self, off: int = 0, ln: int | None = None) -> memoryview:
        ln = self.size - off if ln is None else ln
        return memoryview(self.buf)[off:off + ln]


@dataclass
class _PendingPut:
    """The withheld tail of a partially-delivered put.  Only the undelivered
    suffix is retained (for the frame protocol that is the 4-byte trailer),
    so staging a put never copies the frame body."""

    region: MemRegion
    offset: int         # region offset where the tail lands at flush
    tail: bytes


class PreparedPutv:
    """A pre-validated scatter-gather work request (see
    :meth:`Endpoint.prepare_putv`).  ``head`` holds fully-delivered
    segments as ``(dst, end, data)`` with absolute region offsets;
    ``tail`` (or ``None``) is the withheld-suffix segment as
    ``(dst, end, head_view_or_None, pending)``."""

    __slots__ = ("ep", "region", "rkey", "head", "tail", "total")

    def __init__(self, ep, region, rkey, head, tail, total):
        self.ep, self.region, self.rkey = ep, region, rkey
        self.head, self.tail, self.total = head, tail, total

    def post(self) -> None:
        """Re-post the work request: the per-WQE hardware re-check (the
        mapping is still live under the prepared rkey), then the gathers.
        The withheld tail re-enters the endpoint's pending list each
        post, so flush semantics match :meth:`Endpoint.putv_nbi`."""
        ep = self.ep
        region = self.region
        if ep.remote.regions.get(region.base) is not region \
                or region.rkey != self.rkey:
            ep.stats["rejected"] += 1
            raise AccessDenied(
                f"{ep.remote.name}: prepared WR posted against a stale "
                f"mapping (rkey {self.rkey:#x})")
        buf = region.buf
        for dst, end, d in self.head:
            buf[dst:end] = d
        t = self.tail
        if t is not None:
            dst, end, hv, pend = t
            if hv is not None:
                buf[dst:end] = hv
            ep._pending.append(pend)
        st = ep.stats
        st["puts"] += 1
        st["bytes"] += self.total


class Endpoint:
    """One-sided channel from a local NIC to a remote NIC."""

    def __init__(self, nic: "Nic", remote: "Nic"):
        self.nic, self.remote = nic, remote
        self._pending: list[_PendingPut] = []
        self.stats = {"puts": 0, "bytes": 0, "flushes": 0, "rejected": 0}

    # -- the ucp_put_nbi analogue ------------------------------------------
    def put_nbi(self, data: bytes | bytearray | memoryview, remote_addr: int,
                rkey: int, *, deliver_bytes: int | None = None) -> None:
        """Non-blocking one-sided write.  ``deliver_bytes`` makes just a
        prefix visible until flush — modelling in-flight puts.

        Zero-copy contract: ``data`` is copied straight into the target
        region (that copy IS the emulated wire transfer); no intermediate
        ``bytes(data)`` is materialized.  A partially-delivered put retains
        only its withheld tail, so callers may pass views into reusable
        slab buffers as long as the slot is not rewritten before flush
        (the transport layer's credit accounting guarantees that)."""
        nd = len(data)
        region, off = self.remote.check_access(remote_addr, nd, rkey, Access.WRITE,
                                               ep=self)
        mv = data if isinstance(data, memoryview) else memoryview(data)
        n = nd if deliver_bytes is None else min(deliver_bytes, nd)
        region.buf[off:off + n] = mv[:n]
        if n < nd:
            self._pending.append(_PendingPut(region, off + n, bytes(mv[n:])))
        self.stats["puts"] += 1
        self.stats["bytes"] += nd

    def putv_nbi(self, segs, remote_addr: int, rkey: int, *,
                 withhold_tail: int = 0) -> None:
        """Scatter-gather non-blocking write — the multi-SGE work request.

        ``segs`` is a sequence of ``(rel_off, data)`` pairs, each landing
        at ``remote_addr + rel_off``.  The rkey/permission/bounds check
        covers the segments' full extent ONCE; the segments then copy in
        post order.  This is what makes a framed message one work request
        instead of one per section: header, payload pieces, and barrier
        bytes ride a single posting.

        ``withhold_tail`` keeps the last N bytes of the *final* segment
        invisible until flush — the delivery-barrier knob, exactly
        ``deliver_bytes`` for :meth:`put_nbi` restricted to the tail.
        Callers put the bytes whose arrival signals completion (a frame
        trailer, a chunk seal) last in ``segs`` for this reason."""
        if not segs:
            return
        lo = hi = None
        total = 0
        for off, d in segs:
            nd = len(d)
            total += nd
            lo = off if lo is None or off < lo else lo
            end = off + nd
            hi = end if hi is None or end > hi else hi
        region, base = self.remote.check_access(
            remote_addr + lo, hi - lo, rkey, Access.WRITE, ep=self)
        base -= lo
        buf = region.buf
        if withhold_tail:
            tail_off, tail_d = segs[-1]
            for off, d in segs[:-1]:
                dst = base + off
                buf[dst:dst + len(d)] = d      # whole segment, no subview
            mv = tail_d if isinstance(tail_d, memoryview) \
                else memoryview(tail_d)
            n = max(len(mv) - withhold_tail, 0)
            dst = base + tail_off
            if n > 0:
                buf[dst:dst + n] = mv[:n]
            self._pending.append(
                _PendingPut(region, dst + n, bytes(mv[n:])))
        else:
            for off, d in segs:
                dst = base + off
                buf[dst:dst + len(d)] = d
        self.stats["puts"] += 1
        self.stats["bytes"] += total

    def prepare_putv(self, segs, remote_addr: int, rkey: int, *,
                     withhold_tail: int = 0) -> "PreparedPutv":
        """Build a reusable scatter-gather work request — the verbs idiom
        of constructing a WQE once and re-posting it.  Validation,
        extent/rkey resolution, and absolute-offset computation happen
        HERE, once; each :meth:`PreparedPutv.post` re-checks only what
        hardware re-checks per WQE (the mapping is still live under the
        same rkey) and then moves bytes.  Segments holding memoryviews
        are gathered zero-copy at every post, so a caller may mutate the
        underlying buffers between posts and the next post ships the new
        bytes — exactly a persistent WR over registered memory."""
        if not segs:
            raise AccessDenied("prepare_putv of an empty segment list")
        lo = hi = None
        total = 0
        for off, d in segs:
            nd = len(d)
            total += nd
            lo = off if lo is None or off < lo else lo
            end = off + nd
            hi = end if hi is None or end > hi else hi
        region, base = self.remote.check_access(
            remote_addr + lo, hi - lo, rkey, Access.WRITE, ep=self)
        base -= lo
        head = []
        tail = None
        if withhold_tail:
            for off, d in segs[:-1]:
                dst = base + off
                head.append((dst, dst + len(d), d))
            off, d = segs[-1]
            mv = d if isinstance(d, memoryview) else memoryview(d)
            n = max(len(mv) - withhold_tail, 0)
            dst = base + off
            tail = (dst, dst + n, mv[:n] if n else None,
                    _PendingPut(region, dst + n, bytes(mv[n:])))
        else:
            for off, d in segs:
                dst = base + off
                head.append((dst, dst + len(d), d))
        return PreparedPutv(self, region, rkey, head, tail, total)

    def get(self, remote_addr: int, ln: int, rkey: int) -> bytes:
        region, off = self.remote.check_access(remote_addr, ln, rkey, Access.READ, ep=self)
        return bytes(region.buf[off:off + ln])

    def flush(self) -> None:
        """Complete all in-flight puts (ucp_ep_flush)."""
        for p in self._pending:
            p.region.buf[p.offset:p.offset + len(p.tail)] = p.tail
        self._pending.clear()
        self.stats["flushes"] += 1


class Nic:
    """A simulated host adapter; one per emulated process."""

    _addr_cursor = 0x10_0000

    def __init__(self, name: str):
        self.name = name
        self.regions: dict[int, MemRegion] = {}  # base -> region

    @classmethod
    def _alloc_va(cls, size: int) -> int:
        base = cls._addr_cursor
        cls._addr_cursor += (size + 0xFFFF) & ~0xFFFF  # 64K-aligned, no overlap
        return base

    # -- the ucp_mem_map analogue ------------------------------------------
    def mem_map(self, size: int, access: Access = Access.RW) -> MemRegion:
        base = self._alloc_va(size)
        rkey = secrets.randbits(32) or 1
        region = MemRegion(self, base, bytearray(size), rkey, access)
        self.regions[base] = region
        return region

    def mem_unmap(self, region: MemRegion) -> None:
        self.regions.pop(region.base, None)

    def connect(self, remote: "Nic") -> Endpoint:
        return Endpoint(self, remote)

    def check_access(self, addr: int, ln: int, rkey: int, need: Access,
                     ep: Endpoint | None = None):
        nv = need.value
        for base, region in self.regions.items():
            if base <= addr and addr + ln <= base + region.size:
                if region.rkey != rkey:
                    break
                if region.access.value & nv != nv:   # Flag subset, sans the
                    break                            # slow enum __contains__
                return region, addr - base
        if ep is not None:
            ep.stats["rejected"] += 1
        raise AccessDenied(
            f"{self.name}: {need} x{ln} @ {addr:#x} rejected (rkey {rkey:#x})")


# ---------------------------------------------------------------------------
# Ring buffer over a region (the paper's throughput-bench message layout)


@dataclass
class RingBuffer:
    """Fixed-slot ring over a mapped region.  The source computes slot
    addresses locally (one-sided!); the target polls slot by slot."""

    region: MemRegion
    slot_size: int
    head: int = 0  # target-side consume index
    tail: int = 0  # source-side produce index

    @property
    def n_slots(self) -> int:
        return self.region.size // self.slot_size

    def slot_addr(self, i: int) -> int:
        return self.region.base + (i % self.n_slots) * self.slot_size

    def slot_view(self, i: int) -> memoryview:
        off = (i % self.n_slots) * self.slot_size
        return self.region.view(off, self.slot_size)
