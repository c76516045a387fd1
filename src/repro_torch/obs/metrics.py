"""Typed metrics: counters, gauges, power-of-two latency histograms, and
the registry that unifies them with the transport's legacy stats dicts.

Design constraints, in order:

* **Hot-path cost.**  The dispatcher moves small messages through
  coalesced containers; a metric observation must be a couple of
  dict/list ops, no locks, no allocation.  ``Histogram.observe`` is one ``bit_length`` and
  two list index ops.
* **Legacy aliasing.**  The transport's ``peer.stats`` / ``self.stats``
  plain dicts ARE the counters for the existing hot paths — re-routing
  every ``stats["sent"] += 1`` through a method call would tax exactly
  the hot paths the counters describe.  ``Registry.register_dict``
  aliases a live dict into the registry (by reference, not copy), so a
  snapshot sees the transport counters without the transport paying
  anything for it.
* **Zero dependencies.**  stdlib only; renders to text or plain JSON.

Snapshots are plain nested dicts (``{"counters": .., "gauges": ..,
"histograms": ..}``) so they pickle/JSON trivially; :func:`delta` and
:func:`merge_snapshots` operate on snapshots, which is what a multi-peer
run aggregates (one registry per process would be the real-RDMA shape;
the in-process emulation shares one).
"""

from __future__ import annotations

import json

#: histogram bucket i counts values v with ``int(v).bit_length() == i``,
#: i.e. v in [2^(i-1), 2^i); bucket 0 is v < 1.  64 buckets cover the
#: full u64-microsecond range — power-of-two, like UCX's own profiling.
N_BUCKETS = 64


class Counter:
    """Monotone counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Power-of-two-bucketed distribution (latencies in microseconds).

    ``observe`` is the hot operation: bucket index is ``bit_length`` of
    the integer part, clamped to the table.  Quantiles walk the
    cumulative counts and report the bucket's upper bound — a <=2x
    over-estimate by construction, which is the resolution the buckets
    buy their speed with.
    """

    __slots__ = ("name", "buckets", "count", "total", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.buckets = [0] * N_BUCKETS
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None

    @staticmethod
    def bucket_of(v) -> int:
        i = int(v).bit_length() if v >= 1 else 0
        return i if i < N_BUCKETS else N_BUCKETS - 1

    def observe(self, v) -> None:
        i = int(v).bit_length() if v >= 1 else 0
        self.buckets[i if i < N_BUCKETS else N_BUCKETS - 1] += 1
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v

    def quantile(self, q: float):
        """Upper bound of the bucket holding the q-quantile observation
        (None when empty).  q in [0, 1]."""
        if self.count == 0:
            return None
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.buckets):
            seen += c
            if seen >= rank and c:
                return 1 << i if i else 1
        return 1 << (N_BUCKETS - 1)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def merge(self, other: "Histogram") -> None:
        """Element-wise fold of ``other`` into self (multi-peer rollup)."""
        for i, c in enumerate(other.buckets):
            if c:
                self.buckets[i] += c
        self.count += other.count
        self.total += other.total
        if other.min is not None and (self.min is None or other.min < self.min):
            self.min = other.min
        if other.max is not None and (self.max is None or other.max > self.max):
            self.max = other.max

    def snapshot(self) -> dict:
        return {
            "count": self.count, "total": self.total,
            "min": self.min, "max": self.max,
            # sparse: only populated buckets, keyed by exponent
            "buckets": {i: c for i, c in enumerate(self.buckets) if c},
        }

    @classmethod
    def from_snapshot(cls, name: str, snap: dict) -> "Histogram":
        h = cls(name)
        for i, c in snap.get("buckets", {}).items():
            h.buckets[int(i)] = c
        h.count = snap.get("count", 0)
        h.total = snap.get("total", 0.0)
        h.min, h.max = snap.get("min"), snap.get("max")
        return h


class Registry:
    """One namespace of metrics + aliased legacy stats dicts.

    ``register_dict`` holds a *reference* to a live ``{str: int}`` dict —
    the transport keeps mutating it in place, the registry reads it only
    at snapshot time.  Registered names are flattened into the counter
    namespace as ``{prefix}.{key}``.
    """

    def __init__(self, name: str = "repro_torch"):
        self.name = name
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._dicts: dict[str, dict] = {}

    # -- construction (idempotent by name) ----------------------------------

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name)
        return h

    def register_dict(self, prefix: str, stats: dict) -> str:
        """Alias a live legacy stats dict (by reference) under ``prefix``.
        A prefix already bound to a *different* dict is uniquified with a
        numeric suffix (several flow-node dispatchers share one registry);
        re-registering the same dict is idempotent.  Returns the prefix
        actually used."""
        cur = self._dicts.get(prefix)
        if cur is not None and cur is not stats:
            i = 2
            while self._dicts.get(f"{prefix}.{i}", stats) is not stats:
                i += 1
            prefix = f"{prefix}.{i}"
        self._dicts[prefix] = stats
        return prefix

    def unregister_dict(self, prefix: str, stats: dict | None = None) -> None:
        """Drop a dict alias (peer retirement): removes ``prefix`` and any
        suffix-uniquified aliases of the same dict.  ``stats`` (when given)
        guards against unbinding a *different* dict that later claimed the
        prefix.  Missing prefixes are ignored — retirement paths may race."""
        victims = [p for p, d in self._dicts.items()
                   if (p == prefix or p.startswith(prefix + "."))
                   and (stats is None or d is stats)]
        for p in victims:
            del self._dicts[p]

    # -- read side ----------------------------------------------------------

    def snapshot(self) -> dict:
        counters = {n: c.value for n, c in self._counters.items()}
        for prefix, d in self._dicts.items():
            for k, v in d.items():
                if isinstance(v, (int, float)):
                    counters[f"{prefix}.{k}"] = v
        return {
            "counters": counters,
            "gauges": {n: g.value for n, g in self._gauges.items()},
            "histograms": {n: h.snapshot() for n, h in self._histograms.items()},
        }

    def to_json(self) -> dict:
        return self.snapshot()

    def to_text(self) -> str:
        """Human/text-exposition rendering: one line per metric, histograms
        as count/mean/p50/p99."""
        snap = self.snapshot()
        lines = []
        for n in sorted(snap["counters"]):
            lines.append(f"{n} {snap['counters'][n]}")
        for n in sorted(snap["gauges"]):
            lines.append(f"{n} {snap['gauges'][n]}")
        for n in sorted(snap["histograms"]):
            h = self._histograms[n]
            lines.append(
                f"{n} count={h.count} mean={h.mean:.1f} "
                f"p50={h.quantile(0.5)} p99={h.quantile(0.99)}")
        return "\n".join(lines)

    def dump_json(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)


def delta(curr: dict, prev: dict) -> dict:
    """``curr - prev`` for two snapshots (counters and histogram counts
    subtract; gauges take the current value) — the per-wave / per-round
    reporting primitive."""
    out = {"counters": {}, "gauges": dict(curr.get("gauges", {})),
           "histograms": {}}
    pc = prev.get("counters", {})
    for n, v in curr.get("counters", {}).items():
        out["counters"][n] = v - pc.get(n, 0)
    ph = prev.get("histograms", {})
    for n, h in curr.get("histograms", {}).items():
        p = ph.get(n, {})
        pb = p.get("buckets", {})
        out["histograms"][n] = {
            "count": h["count"] - p.get("count", 0),
            "total": h["total"] - p.get("total", 0.0),
            "min": h["min"], "max": h["max"],
            "buckets": {i: c - pb.get(i, 0)
                        for i, c in h.get("buckets", {}).items()
                        if c - pb.get(i, 0)},
        }
    return out


def merge_snapshots(snaps) -> dict:
    """Fold N snapshots (e.g. one per peer process) into one rollup:
    counters and histogram buckets sum, gauges last-write-wins."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for s in snaps:
        for n, v in s.get("counters", {}).items():
            out["counters"][n] = out["counters"].get(n, 0) + v
        out["gauges"].update(s.get("gauges", {}))
        for n, h in s.get("histograms", {}).items():
            acc = out["histograms"].get(n)
            if acc is None:
                merged = Histogram(n)
            else:
                merged = Histogram.from_snapshot(n, acc)
            merged.merge(Histogram.from_snapshot(n, h))
            out["histograms"][n] = merged.snapshot()
    return out


__all__ = ["Counter", "Gauge", "Histogram", "Registry", "N_BUCKETS",
           "delta", "merge_snapshots"]
