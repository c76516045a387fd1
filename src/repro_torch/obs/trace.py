"""Cross-peer span tracing, exportable as Chrome ``trace_event`` JSON.

One :class:`Tracer` is shared by every peer of a run (the in-process
emulation's analogue of a per-node trace buffer plus offline merge): each
span carries an *actor* — the peer/context name — which becomes the
trace's thread lane, so a Perfetto render shows ``source``, ``csd``,
``dpu_a`` ... as parallel swimlanes with the frame's life (submit →
flush → put → poll → execute → reply) strung across them, correlated by
the transport's existing ``corr_id``.

Disabled is the default (counters-only observability): ``begin`` returns
None and every other entry point is a single attribute test, so the
transport hot paths pay nothing until a run opts in.

Export is the ``trace_event`` JSON array format: ``ph:"X"`` complete
events (ts/dur in microseconds), ``ph:"i"`` instants, and ``ph:"M"``
thread-name metadata mapping the integer tids back to actor names.
chrome://tracing and https://ui.perfetto.dev both open the file as-is.
"""

from __future__ import annotations

import json
import time


class Span:
    """One open or completed interval.  ``corr`` ties spans of the same
    logical frame together across actors; ``parent`` marks retransmit /
    child relationships in the args (trace_event has no first-class
    hierarchy for "X" events — nesting is per-lane by time)."""

    __slots__ = ("name", "cat", "actor", "corr", "ts", "dur", "args")

    def __init__(self, name, cat, actor, corr, ts, args):
        self.name = name
        self.cat = cat
        self.actor = actor
        self.corr = corr
        self.ts = ts          # microseconds since tracer epoch
        self.dur = None       # None while open
        self.args = args


class Tracer:
    def __init__(self, enabled: bool = False, max_events: int = 100_000):
        self.enabled = enabled
        self.max_events = max_events
        self.events: list[Span] = []      # completed spans + instants
        self._open: set = set()           # id(span) of open spans
        self._open_spans: dict = {}       # id(span) -> span (orphan report)
        self.dropped = 0
        self._epoch = time.perf_counter()

    # -- clock --------------------------------------------------------------

    def now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    # -- recording ----------------------------------------------------------

    def begin(self, name: str, cat: str = "", actor: str = "",
              corr=None, **args):
        """Open a span; returns None when disabled (callers pass the
        handle straight back to :meth:`end`, which no-ops on None)."""
        if not self.enabled:
            return None
        sp = Span(name, cat, actor, corr, self.now_us(), args or None)
        self._open.add(id(sp))
        self._open_spans[id(sp)] = sp
        return sp

    def end(self, span, **args) -> None:
        if span is None:
            return
        span.dur = self.now_us() - span.ts
        if args:
            span.args = {**(span.args or {}), **args}
        self._open.discard(id(span))
        self._open_spans.pop(id(span), None)
        if len(self.events) < self.max_events:
            self.events.append(span)
        else:
            self.dropped += 1

    def instant(self, name: str, cat: str = "", actor: str = "",
                corr=None, **args) -> None:
        if not self.enabled:
            return
        sp = Span(name, cat, actor, corr, self.now_us(), args or None)
        sp.dur = -1.0                     # marker: instant, not interval
        if len(self.events) < self.max_events:
            self.events.append(sp)
        else:
            self.dropped += 1

    # -- introspection (the OBS_OK gates) ------------------------------------

    def open_count(self) -> int:
        return len(self._open)

    def open_spans(self) -> list:
        return list(self._open_spans.values())

    def spans(self, cat: str | None = None, corr=None) -> list:
        """Completed interval spans, optionally filtered."""
        return [e for e in self.events
                if e.dur is not None and e.dur >= 0
                and (cat is None or e.cat == cat)
                and (corr is None or e.corr == corr)]

    # -- export --------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The run as a ``trace_event`` document: one pid, one tid per
        actor, spans as complete ("X") events."""
        tids: dict[str, int] = {}
        out = []
        for e in self.events:
            tid = tids.setdefault(e.actor or "-", len(tids) + 1)
            args = dict(e.args) if e.args else {}
            if e.corr is not None:
                args["corr"] = e.corr
            ev = {"name": e.name, "cat": e.cat or "span", "pid": 1,
                  "tid": tid, "ts": round(e.ts, 3)}
            if e.dur is not None and e.dur >= 0:
                ev["ph"] = "X"
                ev["dur"] = round(e.dur, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            if args:
                ev["args"] = args
            out.append(ev)
        meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": t,
                 "args": {"name": actor}} for actor, t in tids.items()]
        return {"traceEvents": meta + out, "displayTimeUnit": "ms"}

    def export_chrome(self, path) -> dict:
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


__all__ = ["Span", "Tracer"]
