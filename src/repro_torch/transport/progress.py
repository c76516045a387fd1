"""Progress engine: completion queues + batched non-blocking puts.

``put`` is non-blocking by contract; the engine makes the in-flight window
a first-class state:

* every posted put gets a :class:`TxHandle`; its completion lands on the
  engine's completion queue only when the owning channel is flushed;
* with ``inflight_window`` set, the engine withholds the frame's trailing
  bytes (``"trailer"``: exactly the 4-byte trailer signal) until flush —
  a target polling mid-put observes ``Status.IN_PROGRESS``, and the flush
  is what publishes the trailer;
* puts batch: channels auto-flush after ``flush_threshold`` outstanding
  puts, or explicitly via :meth:`flush` / :meth:`progress`.

The engine also owns the *send slabs*: one preallocated staging buffer per
channel, one slot-sized cell per ring slot.  The dispatcher packs frames
straight into slab cells and posts the resulting memoryview.  A cell is
stable exactly as long as its ring slot's credit is outstanding.  Stream
chunks are the exception: they post as views of the caller's payload.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from repro_torch.core import frame as F
from repro_torch.transport.fabric import Channel

_TRAILER_BYTES = F.TRAILER.to_bytes(F.TRAILER_LEN, "little")


@dataclass
class TxHandle:
    """One posted put: completes (callback + CQ entry) at flush time.
    ``future`` ties it to a task Future, or for an aggregate container to a
    list of them: the flush that publishes the frame marks each SENT."""

    seq: int
    channel: Channel
    nbytes: int
    slot: int
    peer: str | None = None
    done: bool = False
    on_complete: object = None
    future: object = None


@dataclass
class Completion:
    seq: int
    peer: str | None
    nbytes: int
    slot: int


class ProgressEngine:
    """ucp_worker analogue: owns outstanding puts across all channels.

    ``inflight_window``: None posts puts fully delivered.  An int N
    withholds the last N bytes of every frame until flush; ``"trailer"``
    withholds exactly the frame trailer signal.
    """

    #: extra bytes per slab cell beyond the mailbox slot size — covers
    #: backends (device mesh) whose wire frame is larger than their
    #: on-target slot encoding
    SLAB_HEADROOM = 256

    def __init__(self, flush_threshold: int = 8,
                 inflight_window: int | str | None = "trailer"):
        self.flush_threshold = flush_threshold
        self.inflight_window = inflight_window
        self.completion_queue: deque[Completion] = deque()
        self._outstanding: dict[int, list[TxHandle]] = {}  # id(channel) -> handles
        self._channels: dict[int, Channel] = {}
        self._slabs: dict[int, tuple[bytearray, int, int]] = {}
        self._seq = 0
        self.stats = {"posted": 0, "completed": 0, "flushes": 0,
                      "auto_flushes": 0, "callbacks": 0, "slab_bytes": 0,
                      "futures_sent": 0}
        #: repro_torch.obs.Obs bundle — installed by the owning Dispatcher
        #: so flush spans land in the same trace as its put/poll spans
        self.obs = None

    # -- send slabs ---------------------------------------------------------

    def slab_slot(self, channel: Channel, slot: int) -> memoryview:
        """Writable slot-sized staging cell for ``slot`` of the channel's
        mailbox ring, allocated once per channel (n_slots x cell)."""
        key = id(channel)
        ent = self._slabs.get(key)
        if ent is None:
            mb = channel.mailbox
            cell = mb.slot_size + self.SLAB_HEADROOM
            slab = bytearray(mb.n_slots * cell)
            ent = (slab, mb.n_slots, cell)
            self._slabs[key] = ent
            self.stats["slab_bytes"] += len(slab)
        slab, n_slots, cell = ent
        off = (slot % n_slots) * cell
        return memoryview(slab)[off:off + cell]

    def release_slab(self, channel: Channel) -> None:
        """Drop a removed peer's staging slab."""
        ent = self._slabs.pop(id(channel), None)
        if ent is not None:
            self.stats["slab_bytes"] -= len(ent[0])

    # -- source side --------------------------------------------------------

    def _window(self, nbytes: int) -> int | None:
        w = self.inflight_window
        if w is None:
            return None
        if w == "trailer":
            return max(nbytes - F.TRAILER_LEN, 0)
        return max(nbytes - int(w), 0)

    def post(self, channel: Channel, frame, slot: int, *,
             peer: str | None = None, on_complete=None,
             future=None) -> TxHandle:
        """Non-blocking send of one frame into ``slot`` of the channel's
        mailbox.  The frame is not guaranteed visible at the target until
        the returned handle completes; ``future`` (a task Future, or a list
        of them) is marked SENT by the flush that publishes it."""
        self._seq += 1
        h = TxHandle(self._seq, channel, len(frame), slot, peer=peer,
                     on_complete=on_complete, future=future)
        channel.put(frame, slot, deliver_bytes=self._window(len(frame)))
        self._register(channel, h)
        return h

    def _register(self, channel: Channel, h: TxHandle) -> None:
        key = id(channel)
        self._channels[key] = channel
        self._outstanding.setdefault(key, []).append(h)
        self.stats["posted"] += 1
        if len(self._outstanding[key]) >= self.flush_threshold:
            self.stats["auto_flushes"] += 1
            self.flush(channel)

    # -- streamed large payloads (frame v2.5) -------------------------------

    def post_stream_open(self, channel: Channel, prefix, frame_len: int,
                         slot: int, *, peer: str | None = None,
                         on_complete=None, future=None) -> TxHandle:
        """Open a FLAG_STREAM frame: put the small prefix (header + code +
        descriptor) and the frame trailer, the trailer withheld until flush
        (the descriptor barrier).  The ``window x cell`` gap between them
        is never written: ring slots arrive zeroed (the previous frame's
        clear) and chunk tags tell the cells' chunks apart."""
        self._seq += 1
        h = TxHandle(self._seq, channel, len(prefix) + F.TRAILER_LEN, slot,
                     peer=peer, on_complete=on_complete, future=future)
        channel.putv_at(
            [(0, prefix), (frame_len - F.TRAILER_LEN, _TRAILER_BYTES)],
            slot,
            withhold_tail=0 if self.inflight_window is None
            else F.TRAILER_LEN)
        self._register(channel, h)
        return h

    def post_stream_frame(self, channel: Channel, slot: int, segs,
                          frame_len: int, *, peer: str | None = None,
                          on_complete=None, future=None) -> TxHandle:
        """Eager stream open: when every chunk fits the frame's cell window,
        the whole frame — prefix, each cell's header|data|seal, and the
        frame trailer — posts as ONE scatter-gather put instead of
        ``2 + 3 x n_chunks``.  The data segments are views of the caller's
        payload, and the trailer rides last with its tail withheld until
        flush, so the descriptor barrier is unchanged."""
        self._seq += 1
        segs = list(segs)
        segs.append((frame_len - F.TRAILER_LEN, _TRAILER_BYTES))
        nbytes = 0
        for _, d in segs:
            nbytes += len(d)
        h = TxHandle(self._seq, channel, nbytes, slot, peer=peer,
                     on_complete=on_complete, future=future)
        channel.putv_at(segs, slot,
                        withhold_tail=0 if self.inflight_window is None
                        else F.TRAILER_LEN)
        self._register(channel, h)
        return h

    def post_chunk(self, channel: Channel, slot: int, cell_off: int,
                   hdr, data, seal, *, peer: str | None = None,
                   on_complete=None, future=None) -> TxHandle:
        """Post one stream chunk: header, data and the 4-byte seal as ONE
        scatter-gather put, the seal withheld until flush, so the flush
        that publishes the seal is the chunk's delivery barrier.  ``data``
        may be a view of the caller's payload: the engine never stages
        chunk bytes."""
        self._seq += 1
        h = TxHandle(self._seq, channel, len(hdr) + len(data) + len(seal),
                     slot, peer=peer, on_complete=on_complete, future=future)
        channel.putv_at(
            [(cell_off, hdr), (cell_off + len(hdr), data),
             (cell_off + len(hdr) + len(data), seal)],
            slot,
            withhold_tail=0 if self.inflight_window is None else len(seal))
        self._register(channel, h)
        return h

    def flush(self, channel: Channel | None = None) -> int:
        """Complete outstanding puts (all channels when ``channel`` is None).
        Publishes withheld bytes, fires callbacks in post order, pushes CQ
        entries.  Returns the number of completions."""
        keys = [id(channel)] if channel is not None else list(self._outstanding)
        n = 0
        o = self.obs
        sp = None
        if (o is not None and o.enabled and o.tracer.enabled
                and any(self._outstanding.get(k) for k in keys)):
            sp = o.tracer.begin("flush", cat="engine", actor="engine",
                                channels=sum(1 for k in keys
                                             if self._outstanding.get(k)))
        for key in keys:
            handles = self._outstanding.pop(key, [])
            if not handles:
                continue
            ch = self._channels.pop(key)
            ch.flush()
            for h in handles:
                h.done = True
                self.completion_queue.append(
                    Completion(h.seq, h.peer, h.nbytes, h.slot))
                if h.future is not None:
                    futs = (h.future if isinstance(h.future, (list, tuple))
                            else (h.future,))
                    for f in futs:
                        f._mark_sent(h.seq)
                    self.stats["futures_sent"] += len(futs)
                if h.on_complete is not None:
                    h.on_complete(h)
                    self.stats["callbacks"] += 1
                n += 1
        self.stats["completed"] += n
        self.stats["flushes"] += 1
        if sp is not None:
            o.tracer.end(sp, completions=n)
        return n

    def progress(self) -> int:
        """Flush every channel with outstanding puts.  Returns completions."""
        return self.flush(None) if self._outstanding else 0

    # -- completion queue ---------------------------------------------------

    def outstanding(self, channel: Channel | None = None) -> int:
        if channel is not None:
            return len(self._outstanding.get(id(channel), []))
        return sum(len(v) for v in self._outstanding.values())

    def poll_cq(self, max_n: int | None = None) -> list[Completion]:
        out = []
        while self.completion_queue and (max_n is None or len(out) < max_n):
            out.append(self.completion_queue.popleft())
        return out


__all__ = ["Completion", "ProgressEngine", "TxHandle"]
