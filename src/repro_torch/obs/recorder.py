"""Flight recorder: a fixed-size ring of recent transport events.

The postmortem half of observability — always on, never exported unless
something goes wrong.  Every put/NACK/resend/backpressure/reject drops
one tuple into a preallocated ring (one index op + one tuple build); when
a run wedges, ``dump`` writes the last N events as a readable table,
turning "the run hung" into "peer rdma_b stopped returning credits after
the 3rd NACK".

Deliberately not a log: bounded memory, no formatting until dump time,
no levels.  The trace (``trace.py``) answers "how long"; the recorder
answers "what happened right before it died".
"""

from __future__ import annotations

import sys
import time


class FlightRecorder:
    def __init__(self, capacity: int = 256, clock=time.monotonic):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._clock = clock
        self._buf: list = [None] * capacity
        self._n = 0                       # monotone event count
        self._t0 = clock()

    def add(self, kind: str, peer: str = "", info: str = "") -> None:
        """Record one event; O(1), overwrites the oldest past capacity."""
        self._buf[self._n % self.capacity] = (
            self._clock() - self._t0, kind, peer, info)
        self._n += 1

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def total(self) -> int:
        """Events ever recorded (>= len() once the ring has wrapped)."""
        return self._n

    def events(self) -> list:
        """Retained events, oldest first."""
        if self._n <= self.capacity:
            return [e for e in self._buf[:self._n]]
        i = self._n % self.capacity
        return self._buf[i:] + self._buf[:i]

    def last(self, n: int) -> list:
        return self.events()[-n:]

    def clear(self) -> None:
        self._buf = [None] * self.capacity
        self._n = 0
        self._t0 = self._clock()

    def format(self, reason: str = "") -> str:
        evs = self.events()
        dropped = self._n - len(evs)
        head = (f"=== flight recorder dump ({reason or 'manual'}): "
                f"last {len(evs)} of {self._n} events"
                + (f", {dropped} older dropped" if dropped else "") + " ===")
        lines = [head]
        for t, kind, peer, info in evs:
            lines.append(f"  t+{t:9.4f}s {kind:<14} {peer:<10} {info}")
        lines.append("=== end flight recorder dump ===")
        return "\n".join(lines)

    def dump(self, reason: str = "", stream=None) -> str:
        """Format and write the ring (default: stderr); returns the text."""
        text = self.format(reason)
        print(text, file=stream if stream is not None else sys.stderr)
        return text


__all__ = ["FlightRecorder"]
