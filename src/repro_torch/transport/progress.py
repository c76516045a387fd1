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
stable exactly as long as its ring slot's credit is outstanding.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from repro_torch.core import frame as F
from repro_torch.transport.fabric import Channel


@dataclass
class TxHandle:
    """One posted put: completes (callback + CQ entry) at flush time."""

    seq: int
    channel: Channel
    nbytes: int
    slot: int
    peer: str | None = None
    done: bool = False
    on_complete: object = None


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
                      "auto_flushes": 0, "callbacks": 0, "slab_bytes": 0}

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

    # -- source side --------------------------------------------------------

    def _window(self, nbytes: int) -> int | None:
        w = self.inflight_window
        if w is None:
            return None
        if w == "trailer":
            return max(nbytes - F.TRAILER_LEN, 0)
        return max(nbytes - int(w), 0)

    def post(self, channel: Channel, frame, slot: int, *,
             peer: str | None = None, on_complete=None) -> TxHandle:
        """Non-blocking send of one frame into ``slot`` of the channel's
        mailbox.  The frame is not guaranteed visible at the target until
        the returned handle completes."""
        self._seq += 1
        h = TxHandle(self._seq, channel, len(frame), slot, peer=peer,
                     on_complete=on_complete)
        channel.put(frame, slot, deliver_bytes=self._window(len(frame)))
        key = id(channel)
        self._channels[key] = channel
        self._outstanding.setdefault(key, []).append(h)
        self.stats["posted"] += 1
        if len(self._outstanding[key]) >= self.flush_threshold:
            self.stats["auto_flushes"] += 1
            self.flush(channel)
        return h

    def flush(self, channel: Channel | None = None) -> int:
        """Complete outstanding puts (all channels when ``channel`` is None).
        Publishes withheld bytes, fires callbacks in post order, pushes CQ
        entries.  Returns the number of completions."""
        keys = [id(channel)] if channel is not None else list(self._outstanding)
        n = 0
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
                if h.on_complete is not None:
                    h.on_complete(h)
                    self.stats["callbacks"] += 1
                n += 1
        self.stats["completed"] += n
        self.stats["flushes"] += 1
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
