"""Device-mesh fabric: the on-device mailbox ifunc path behind the
Fabric/Channel/Mailbox contract.

The backend wraps ``core/device_mailbox.py``: a mailbox is a ring of word
frames per shard in device memory (one card holds every shard, the shard
axis the mailbox tensor's leading dimension); a put *transcodes* the wire
byte frame (header + μVM code + f32 payload + trailer) into the device word
frame layout — the NIC-offload moment — and stages it on the host; flush
deposits the staged generation one-sidedly into the ring ``shift`` shards
along; the sweep validates all slots and runs the μVM program bound at
mailbox-open time (the device-side link cache) in one ``ring_poll`` + one
``ifunc_vm`` launch.

Visibility is generation-batched: frames become consumable only after the
depositing flush, which is exactly the in-flight window the ProgressEngine
models.  Deposits are slot-masked (only written slots land), so flushing a
new generation never clobbers frames a sweep has not consumed yet.  A put
posted with its trailer withheld whose generation was deposited before the
flush (:meth:`DeviceMeshMailbox.publish`) sits INFLIGHT in the ring until
the flush writes the trailer word in place.

Sweep results stay on the device: one ``[n_tiles, T, T]`` tensor per READY
slot.  Only the ``[n_shards, n_slots]`` status array comes to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import frame as F
from repro_torch.core.api import Status
from repro_torch.core.device_mailbox import (empty_mailbox, make_deposit,
                                             make_sweep, pack_word_frame)
from repro_torch.device import resolve_device
from repro_torch.kernels.ring_poll import (BAD, HDR_WORDS, INFLIGHT, READY,
                                           TRAILER)
from repro_torch.transport.fabric import Channel, Fabric, Mailbox, TransportError

_TRAILER_I32 = int(np.uint32(TRAILER).view(np.int32))


class DeviceMeshMailbox(Mailbox):
    """Ring of word-frame slots on every shard, in one device tensor."""

    def __init__(self, fabric: "DeviceMeshFabric", prog, externals,
                 n_slots: int, n_tiles: int, tile: int = 128):
        super().__init__()
        self.fabric = fabric
        self.device = fabric.device
        self.shift = fabric.shift
        self.n_shards = fabric.n_shards
        self.n_slots_per_shard = n_slots
        self.n_slots = n_slots * self.n_shards       # dispatcher-visible ring
        self.n_tiles, self.tile = n_tiles, tile
        self.body_words = n_tiles * tile * tile
        self.slot_words = HDR_WORDS + self.body_words + 1
        self.slot_size = self.slot_words * 4         # byte-equivalent capacity
        self.prog = prog
        self.externals = externals                   # [n_shards, n_ext, T, T]
        self._mb = empty_mailbox(self.n_shards, n_slots, self.slot_words,
                                 device=self.device)
        self._deposit = make_deposit(self.n_shards)
        self._sweep = make_sweep(prog, n_tiles, tile)
        self._staged: np.ndarray | None = None
        self._staged_count = 0
        self._deposited = 0                          # frames awaiting sweep
        self.results: list = []                      # READY outputs, in sweep
        #                                 order: one [n_tiles, T, T] tensor
        #                                 on the device per consumed frame
        self.last_coords: list[tuple[int, int]] = []  # (shard, slot) per
        #                                 status of the most recent sweep

    # source-side staging (called by DeviceMeshChannel)

    def slot_coords(self, slot: int) -> tuple[int, int]:
        """Dispatcher ring index -> (shard, per-shard slot) interleaving."""
        return (slot % self.n_shards,
                (slot // self.n_shards) % self.n_slots_per_shard)

    def _stage(self, word_frame: np.ndarray, slot: int) -> None:
        if self._staged is None:
            self._staged = np.zeros(
                (self.n_shards, self.n_slots_per_shard, self.slot_words),
                np.uint32)
        shard, idx = self.slot_coords(slot)
        self._staged[shard, idx] = word_frame
        self._staged_count += 1

    def publish(self) -> None:
        """Deposit the staged generation (the one-sided put lands)."""
        if self._staged is None:
            return
        out = torch.from_numpy(self._staged.view(np.int32)).to(self.device)
        self._mb = self._deposit(self._mb, out, shift=self.shift)
        self._deposited += self._staged_count
        self._staged = None
        self._staged_count = 0

    def complete_trailer(self, slot: int, word_idx: int) -> None:
        """Make a withheld trailer visible: in the staged generation if the
        frame is still staged, else in place in the deposited ring."""
        shard, idx = self.slot_coords(slot)
        if self._staged is not None and self._staged[shard, idx, 0] != 0:
            self._staged[shard, idx, word_idx] = TRAILER
            return
        self._mb[(shard + self.shift) % self.n_shards, idx,
                 word_idx] = _TRAILER_I32

    # target side

    def slot_view(self, i: int):
        raise TransportError("device mailbox slots live in device memory; "
                             "use sweep()")

    def sweep(self, ctx, target_args, budget: int | None = None) -> list:
        """One validate+execute pass over every deposited slot.  ``budget``
        is ignored: the sweep is one device pass, so a device lane may
        yield more than one message per dispatcher poll round.  READY
        results land in ``self.results`` and ``target_args['results']``."""
        if self._deposited == 0:
            self.last_coords = []
            return []
        status_d, out, cleared = self._sweep(self._mb, self.externals)
        self._mb = cleared
        status = status_d.cpu().numpy()
        statuses: list = []
        self.last_coords = []
        for shard, slot in zip(*np.nonzero(status)):
            shard, slot = int(shard), int(slot)
            st = int(status[shard, slot])
            if st == READY:
                res = out[shard, slot]
                self.results.append(res)
                if isinstance(target_args, dict):
                    target_args.setdefault("results", []).append(res)
                statuses.append(Status.OK)
            elif st == BAD:
                statuses.append(Status.REJECTED)
            elif st == INFLIGHT:
                statuses.append(Status.IN_PROGRESS)
            self.last_coords.append((shard, slot))
        consumed = sum(1 for s in statuses
                       if s in (Status.OK, Status.REJECTED))
        self.head += consumed
        self.consumed += consumed
        self._deposited = max(self._deposited - consumed, 0)
        return statuses


class DeviceMeshChannel(Channel):
    def __init__(self, mailbox: DeviceMeshMailbox):
        super().__init__()
        self.mailbox = mailbox
        self._pending_trailers: list[tuple[int, int]] = []

    def put(self, data, slot: int, *, deliver_bytes: int | None = None) -> None:
        """Transcode a wire byte frame into the device word-frame layout and
        stage it.  ``deliver_bytes`` short of the full frame stages the word
        frame without its trailer word (the device-visible in-flight state);
        flush completes the trailer.

        SLIM-aware: the μVM program is bound at mailbox-open time, so code
        words are never deposited — a SLIM frame transcodes identically to
        a FULL one, and the payload is read through a zero-copy section
        view straight out of the sender's slab."""
        mb = self.mailbox
        try:
            hdr = F.peek_header(data)
        except F.FrameError as e:
            raise TransportError(f"device put of an ill-formed frame: {e}") from e
        if hdr is None:
            raise TransportError("device put of an empty frame")
        if hdr.is_agg:
            raise TransportError("aggregate device lane not ported yet")
        if hdr.code_kind != F.CodeKind.UVM:
            raise TransportError(
                f"device mesh accepts UVM frames only, got "
                f"{hdr.code_kind.name}")
        partial = deliver_bytes is not None and deliver_bytes < len(data)
        _, payload = F.frame_sections(data, hdr)
        tiles = np.frombuffer(payload, np.float32)
        if tiles.size != mb.body_words:
            raise TransportError(
                f"device frame payload {tiles.size} words != bound "
                f"{mb.body_words} ({mb.n_tiles} x {mb.tile}x{mb.tile} tiles)")
        name_hash = F.fletcher32(hdr.name.encode()) & 0xFFFFFFFF
        wf = pack_word_frame(tiles, mb.slot_words, kind=int(hdr.code_kind),
                             name_hash=name_hash, no_trailer=partial)
        mb._stage(wf, slot)
        if partial:
            self._pending_trailers.append((slot, HDR_WORDS + mb.body_words))
            self.stats["partial"] += 1
        self.stats["puts"] += 1
        self.stats["bytes"] += len(data)

    def flush(self) -> None:
        mb = self.mailbox
        for slot, word_idx in self._pending_trailers:
            mb.complete_trailer(slot, word_idx)
        self._pending_trailers = []
        mb.publish()
        self.stats["flushes"] += 1


class DeviceMeshFabric(Fabric):
    """Device-tier backend: ``n_shards`` mailbox rings in one device tensor.
    ``open_mailbox`` binds a μVM program + external table (the device GOT)
    to a deposit/sweep pair.  ``shift`` is how many shards along a deposit
    lands (the reference's ppermute over a mesh axis).  ``device`` is the
    card unless the caller asks for the CPU; without CUDA the default
    raises rather than running on the CPU."""

    kind = "device"

    def __init__(self, n_shards: int, *, shift: int = 0, device="cuda"):
        if n_shards < 1:
            raise TransportError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        self.shift = shift
        self.device = resolve_device(device)

    def open_mailbox(self, target_ctx, n_slots: int, slot_size: int,
                     *, prog=None, externals=None, n_tiles: int = 1,
                     tile: int = 128, agg_k: int = 0) -> DeviceMeshMailbox:
        """``target_ctx`` is unused (the device is the target);
        ``slot_size`` must cover the bound word frame.  ``prog`` (a
        UvmProgram) is required: the device links at mailbox-open time.
        ``externals`` is ``[n_shards, n_ext, T, T]`` (array or tensor),
        zeros when omitted."""
        if agg_k:
            raise TransportError("aggregate device lane not ported yet")
        if prog is None:
            raise TransportError("DeviceMeshFabric.open_mailbox needs prog=")
        if externals is None:
            externals = torch.zeros(self.n_shards, max(prog.n_ext, 1), tile,
                                    tile, device=self.device)
        if not isinstance(externals, torch.Tensor):
            externals = torch.from_numpy(np.array(externals, np.float32))
        externals = externals.to(self.device, torch.float32).contiguous()
        if externals.dim() != 4 or externals.shape[0] != self.n_shards:
            raise TransportError(
                f"externals must be [n_shards={self.n_shards}, n_ext, T, T], "
                f"got {tuple(externals.shape)}")
        mb = DeviceMeshMailbox(self, prog, externals, n_slots, n_tiles, tile)
        if slot_size < mb.slot_size:
            raise TransportError(
                f"slot_size {slot_size} < device word-frame {mb.slot_size}B")
        return mb

    def connect(self, src_ctx, mailbox: DeviceMeshMailbox) -> DeviceMeshChannel:
        return DeviceMeshChannel(mailbox)


__all__ = ["DeviceMeshChannel", "DeviceMeshFabric", "DeviceMeshMailbox"]
