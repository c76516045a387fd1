"""Device-mesh fabric: the on-device mailbox ifunc path behind the
Fabric/Channel/Mailbox contract.

The backend wraps ``core/device_mailbox.py``: a mailbox is a ring of word
frames per shard in device memory (one card holds every shard, the shard
axis the mailbox tensor's leading dimension); a put *transcodes* the wire
byte frame (header + μVM code + f32 payload + trailer) into the device word
frame layout — the NIC-offload moment — and stages it on the host; flush
deposits the staged generation one-sidedly into the ring ``shift`` shards
along; the sweep validates all slots and runs the μVM program bound at
mailbox-open time (the device-side link cache) in one launch that polls,
executes, masks and clears in place (``ring_sweep_*_kernel``).

Visibility is generation-batched: frames become consumable only after the
depositing flush, which is exactly the in-flight window the ProgressEngine
models.  Deposits are slot-masked (only written slots land), so flushing a
new generation never clobbers frames a sweep has not consumed yet.  A put
posted with its trailer withheld whose generation was deposited before the
flush (:meth:`DeviceMeshMailbox.publish`) sits INFLIGHT in the ring until
the flush writes the trailer word in place.

A mailbox opened with ``agg_k=K`` holds aggregate containers: a put of a
``FLAG_AGG`` byte container transcodes into one K-sub word frame, and the
sweep is one launch over every sub-record of every slot
(``agg_sweep_*_kernel``); per-sub outcomes land in ``last_agg`` for the
dispatcher.

Sweep results stay on the device: one ``[n_tiles, T, T]`` tensor per READY
slot or sub-record.  Only the statuses come to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import frame as F
from repro_torch.core.api import AggSubResult, Status
from repro_torch.core.device_mailbox import (empty_mailbox, make_agg_sweep,
                                             make_deposit, make_sweep,
                                             pack_agg_word_frame,
                                             pack_word_frame)
from repro_torch.device import resolve_device
from repro_torch.kernels.agg_poll import (SUB_BAD, SUB_EMPTY, SUB_NACK,
                                          SUB_READY)
from repro_torch.kernels.ring_poll import (BAD, HDR_WORDS, INFLIGHT, READY,
                                           TRAILER)
from repro_torch.transport.fabric import Channel, Fabric, Mailbox, TransportError

_TRAILER_I32 = int(np.uint32(TRAILER).view(np.int32))


class DeviceMeshMailbox(Mailbox):
    """Ring of word-frame slots on every shard, in one device tensor."""

    def __init__(self, fabric: "DeviceMeshFabric", prog, externals,
                 n_slots: int, n_tiles: int, tile: int = 128, *,
                 agg_k: int = 0, prog_name: str | None = None):
        super().__init__()
        self.fabric = fabric
        self.device = fabric.device
        self.shift = fabric.shift
        self.n_shards = fabric.n_shards
        self.n_slots_per_shard = n_slots
        self.n_slots = n_slots * self.n_shards       # dispatcher-visible ring
        self.n_tiles, self.tile = n_tiles, tile
        self.body_words = n_tiles * tile * tile
        self.agg_k = agg_k
        self.prog_name = prog_name
        self.bound_hash = (F.fletcher32(prog_name.encode()) & 0xFFFFFFFF
                           if prog_name else 0)
        if agg_k:
            # container header + K descriptor pairs + K bodies + trailer
            self.slot_words = (HDR_WORDS + 2 * agg_k
                               + agg_k * self.body_words + 1)
            # the byte container the dispatcher budgets against: frame
            # header and trailer, counts, per sub a name-table entry, a
            # table row and the body, and the aggregate signal
            self.slot_size = (F.HEADER_LEN + F.TRAILER_LEN + 8
                              + agg_k * (33 + F.AGG_SUB_OVERHEAD
                                         + self.body_words * 4) + 4)
        else:
            self.slot_words = HDR_WORDS + self.body_words + 1
            self.slot_size = self.slot_words * 4     # byte-equivalent capacity
        self.prog = prog
        self.externals = externals                   # [n_shards, n_ext, T, T]
        self._mb = empty_mailbox(self.n_shards, n_slots, self.slot_words,
                                 device=self.device)
        self._deposit = make_deposit(self.n_shards)
        self._sweep = (make_agg_sweep(prog, agg_k, n_tiles, tile,
                                      bound_hash=self.bound_hash)
                       if agg_k else make_sweep(prog, n_tiles, tile))
        self._staged: np.ndarray | None = None
        self._staged_count = 0
        self._deposited = 0                          # frames awaiting sweep
        self.results: list = []                      # READY outputs, in sweep
        #                                 order, one entry per consumed frame
        #                                 or container (see _sweep_agg)
        self.last_coords: list[tuple[int, int]] = []  # slot_coords of the
        #                                 frame behind each status of the
        #                                 most recent sweep

    @property
    def supports_agg(self) -> bool:
        """Aggregate containers transcode onto this lane (the dispatcher's
        eligibility probe)."""
        return self.agg_k > 0

    # source-side staging (called by DeviceMeshChannel)

    def slot_coords(self, slot: int) -> tuple[int, int]:
        """Dispatcher ring index -> (shard, per-shard slot) interleaving."""
        return (slot % self.n_shards,
                (slot // self.n_shards) % self.n_slots_per_shard)

    def _sender_coords(self, shard: int, slot: int) -> tuple[int, int]:
        """Where the frame that landed at ``(shard, slot)`` was staged: the
        :meth:`slot_coords` it was sent under, ``shift`` shards back.
        ``last_coords`` and ``last_agg`` are keyed by it, so a dispatcher
        finds its record of the frame whatever the shift."""
        return (shard - self.shift) % self.n_shards, slot

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
        if self.agg_k:
            return self._sweep_agg(target_args)
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
            self.last_coords.append(self._sender_coords(shard, slot))
        return self._consume(statuses)

    def _consume(self, statuses: list) -> list:
        """Advance the consume counters past the OK and REJECTED slots of
        a sweep (the credit return); returns ``statuses``."""
        consumed = sum(1 for s in statuses
                       if s in (Status.OK, Status.REJECTED))
        self.head += consumed
        self.consumed += consumed
        self._deposited = max(self._deposited - consumed, 0)
        return statuses

    def _sweep_agg(self, target_args) -> list:
        """Aggregate sweep: one fused launch over every container.  Per-sub outcomes of each READY container (a list
        of :class:`AggSubResult`, up to the first SUB_EMPTY) land in
        ``last_agg`` under its sender's coordinates for the dispatcher to
        complete; the values of SUB_READY records extend
        ``target_args['results']``."""
        status_d, sub_d, out, cleared = self._sweep(self._mb, self.externals)
        self._mb = cleared
        both = torch.cat([status_d[..., None], sub_d], dim=-1).cpu().numpy()
        status, sub_st = both[..., 0], both[..., 1:]
        statuses: list = []
        self.last_coords = []
        for shard, slot in zip(*np.nonzero(status)):
            shard, slot = int(shard), int(slot)
            st = int(status[shard, slot])
            if st == READY:
                subs: list[AggSubResult] = []
                vals: list = []
                for i, s_i in enumerate(sub_st[shard, slot].tolist()):
                    if s_i == SUB_EMPTY:
                        break
                    if s_i == SUB_READY:
                        val = out[shard, slot, i]
                        subs.append(AggSubResult(Status.OK, "", b"", 0,
                                                 value=val))
                        vals.append(val)
                    elif s_i == SUB_BAD:
                        subs.append(AggSubResult(
                            Status.REJECTED, "", b"", 0,
                            error=TransportError("poisoned sub-record "
                                                 "(descriptor check "
                                                 "mismatch)")))
                    elif s_i == SUB_NACK:
                        subs.append(AggSubResult(Status.NACK_UNCACHED, "",
                                                 b"", 0))
                self.last_agg[self._sender_coords(shard, slot)] = subs
                while len(self.last_agg) > 2 * self.n_slots:
                    self.last_agg.pop(next(iter(self.last_agg)))
                # ONE results entry per consumed container keeps the
                # dispatcher's per-status result cursor aligned: a 1-sub
                # container (a transcoded singleton) yields its bare
                # output, a K-sub one the list of its values
                self.results.append(vals[0] if len(subs) == 1 and vals
                                    else vals)
                if isinstance(target_args, dict):
                    target_args.setdefault("results", []).extend(vals)
                statuses.append(Status.OK)
            elif st == BAD:
                statuses.append(Status.REJECTED)
            elif st == INFLIGHT:
                statuses.append(Status.IN_PROGRESS)
            self.last_coords.append(self._sender_coords(shard, slot))
        return self._consume(statuses)


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
        partial = deliver_bytes is not None and deliver_bytes < len(data)
        _, payload = F.frame_sections(data, hdr)
        if hdr.is_agg:
            wf = self._transcode_agg(hdr, payload, partial)
        else:
            if hdr.code_kind != F.CodeKind.UVM:
                raise TransportError(
                    f"device mesh accepts UVM frames only, got "
                    f"{hdr.code_kind.name}")
            tiles = np.frombuffer(payload, np.float32)
            if tiles.size != mb.body_words:
                raise TransportError(
                    f"device frame payload {tiles.size} words != bound "
                    f"{mb.body_words} ({mb.n_tiles} x {mb.tile}x{mb.tile} "
                    f"tiles)")
            if mb.supports_agg:
                # a singleton on an agg-bound lane is a 1-sub container
                # whose descriptor carries the *bound* hash: the singleton
                # path never name-checks (the program is linked at open)
                wf = pack_agg_word_frame(
                    [tiles], [mb.bound_hash], mb.agg_k, mb.body_words,
                    mb.slot_words, kind=int(hdr.code_kind),
                    no_trailer=partial)
            else:
                name_hash = F.fletcher32(hdr.name.encode()) & 0xFFFFFFFF
                wf = pack_word_frame(tiles, mb.slot_words,
                                     kind=int(hdr.code_kind),
                                     name_hash=name_hash, no_trailer=partial)
        mb._stage(wf, slot)
        if partial:
            self._pending_trailers.append(
                (slot, mb.slot_words - 1 if mb.agg_k
                 else HDR_WORDS + mb.body_words))
            self.stats["partial"] += 1
        self.stats["puts"] += 1
        self.stats["bytes"] += len(data)

    def _transcode_agg(self, hdr, payload, partial: bool) -> np.ndarray:
        """A FLAG_AGG byte container as one K-sub word frame: each
        sub-record's name hashed into its descriptor, its payload (read in
        place from the sender's slab) into its body lane."""
        mb = self.mailbox
        if not mb.supports_agg:
            # without agg_k the slot has no descriptor table or body lanes
            raise TransportError(
                "aggregate frame on a device mailbox opened without agg_k= "
                "— bind an aggregate slot layout first")
        try:
            batch = F.parse_agg(payload)
        except F.FrameError as e:
            raise TransportError(f"device agg transcode: {e}") from e
        if batch.n > mb.agg_k:
            raise TransportError(f"container of {batch.n} sub-records on a "
                                 f"lane bound to agg_k={mb.agg_k}")
        pays: list[np.ndarray] = []
        hashes: list[int] = []
        for i in range(batch.n):
            if batch.kind(i) != F.CodeKind.UVM:
                raise TransportError(
                    f"device mesh accepts UVM sub-records only, got "
                    f"{batch.kind(i).name}")
            tiles = np.frombuffer(batch.payload(i), np.float32)
            if tiles.size != mb.body_words:
                raise TransportError(
                    f"device agg sub payload {tiles.size} words != bound "
                    f"{mb.body_words}")
            pays.append(tiles)
            hashes.append(F.fletcher32(batch.name(i).encode()) & 0xFFFFFFFF)
        return pack_agg_word_frame(pays, hashes, mb.agg_k, mb.body_words,
                                   mb.slot_words, kind=int(hdr.code_kind),
                                   no_trailer=partial)

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
                     tile: int = 128, agg_k: int = 0,
                     prog_name: str | None = None) -> DeviceMeshMailbox:
        """``target_ctx`` is unused (the device is the target);
        ``slot_size`` must cover the bound word frame.  ``prog`` (a
        UvmProgram) is required: the device links at mailbox-open time.
        ``externals`` is ``[n_shards, n_ext, T, T]`` (array or tensor),
        zeros when omitted.  ``agg_k > 0`` binds the aggregate container
        layout (K sub-record bodies per slot, one fused ``agg_sweep``
        launch a sweep) and makes the lane coalesce-eligible;
        ``prog_name`` bounds sub-record name hashes (a mismatch NACKs that
        sub-record; None accepts any name)."""
        if agg_k < 0:
            raise TransportError(f"agg_k must be >= 0, got {agg_k}")
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
        mb = DeviceMeshMailbox(self, prog, externals, n_slots, n_tiles, tile,
                               agg_k=agg_k, prog_name=prog_name)
        if slot_size < mb.slot_size:
            raise TransportError(
                f"slot_size {slot_size} < device word-frame {mb.slot_size}B")
        return mb

    def connect(self, src_ctx, mailbox: DeviceMeshMailbox) -> DeviceMeshChannel:
        return DeviceMeshChannel(mailbox)


__all__ = ["DeviceMeshChannel", "DeviceMeshFabric", "DeviceMeshMailbox"]
