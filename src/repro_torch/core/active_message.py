"""UCX Active Message baseline (paper §3.3 comparison).

Classical AM semantics, contrasted with ifuncs on every axis the paper
names: the handler is registered at the *target* under a numeric ID fixed
at "compile time"; the message carries only ``(id, payload)``; receive
buffers are runtime-internal (the user never mem_maps anything); and the
runtime switches protocol by size — eager (copy through the internal ring)
below ``rndv_threshold``, rendezvous (descriptor + remote get) above it,
which is what produces the throughput 'steps' discussed in §4.3.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from repro_torch.core import rdma as R

_EAGER_SLOT = 8 << 10      # UCX-ish eager buffer slot
_HDR = 16                  # id(4) len(8) proto(4)


class AmError(Exception):
    pass


@dataclass
class AmContext:
    """Per-process AM state: handler table + internal eager ring."""

    name: str
    nic: R.Nic = None
    n_slots: int = 1024
    rndv_threshold: int = _EAGER_SLOT - _HDR
    handlers: dict[int, object] = field(default_factory=dict)
    stats: dict = field(default_factory=lambda: {"executed": 0, "bytes_in": 0})

    def __post_init__(self):
        if self.nic is None:
            self.nic = R.Nic(self.name)
        # UCX-internal receive buffers: allocated by the runtime, not the user.
        self._region = self.nic.mem_map(self.n_slots * _EAGER_SLOT)
        self._ring = R.RingBuffer(self._region, _EAGER_SLOT)
        self._rndv_src: dict[int, tuple] = {}
        self._rndv_seq = 0

    # -- target side -------------------------------------------------------
    def register(self, am_id: int, handler) -> None:
        """AM handlers are target-registered, ID-keyed (vs ifunc: source-
        registered, name-keyed, code shipped)."""
        self.handlers[am_id] = handler

    def progress(self, target_args=None) -> int:
        """ucp_worker_progress analogue: drain + dispatch pending AMs."""
        n = 0
        while True:
            view = self._ring.slot_view(self._ring.head)
            am_id, ln, proto = struct.unpack_from("<IQI", view, 0)
            if ln == 0:
                break
            if proto == 0:  # eager: payload inline
                payload = bytes(view[_HDR:_HDR + ln])
            else:  # rendezvous: fetch from source exposure, then release it
                seq = struct.unpack_from("<Q", view, _HDR)[0]
                src_ep, region = self._rndv_src.pop(seq)
                payload = src_ep.get(region.base, region.size, region.rkey)
                region.nic.mem_unmap(region)
            h = self.handlers.get(am_id)
            if h is None:
                raise AmError(f"no AM handler registered for id {am_id}")
            h(payload, len(payload), target_args)
            view[:_EAGER_SLOT] = b"\0" * _EAGER_SLOT
            self._ring.head += 1
            self.stats["executed"] += 1
            self.stats["bytes_in"] += ln
            n += 1
        return n


class AmEndpoint:
    """Source-side endpoint to a remote AmContext."""

    def __init__(self, src: AmContext, dst: AmContext):
        from repro_torch.transport.fabric import endpoint_channel

        self.src, self.dst = src, dst
        self.ep = src.nic.connect(dst.nic)
        self._chan = endpoint_channel(self.ep)   # transport raw channel

    def send(self, am_id: int, payload: bytes) -> None:
        ring = self.dst._ring
        addr = ring.slot_addr(ring.tail)
        rkey = ring.region.rkey
        if len(payload) <= self.dst.rndv_threshold:
            msg = struct.pack("<IQI", am_id, len(payload), 0) + payload
            self._chan.put_raw(msg, addr, rkey)
        else:
            # rendezvous: expose payload at source; send a descriptor
            seq = self.dst._rndv_seq = self.dst._rndv_seq + 1
            region = self.src.nic.mem_map(len(payload))
            region.buf[:] = payload
            back_ep = self.dst.nic.connect(self.src.nic)
            self.dst._rndv_src[seq] = (back_ep, region)
            msg = struct.pack("<IQIQ", am_id, len(payload), 1, seq)
            self._chan.put_raw(msg, addr, rkey)
        ring.tail += 1

    def flush(self) -> None:
        self._chan.flush()
