"""repro_torch.obs — zero-dependency telemetry for the ifunc fabric.

Three pillars, one bundle:

* :class:`~repro_torch.obs.metrics.Registry` — typed Counter/Gauge/Histogram
  metrics with power-of-two latency buckets, plus ``register_dict``
  aliasing of the transport's legacy ``peer.stats`` dicts (snapshots see
  them; the hot paths keep their plain ``+= 1``).
* :class:`~repro_torch.obs.trace.Tracer` — cross-peer span tracing keyed on
  the transport's ``corr_id``, exportable as Chrome ``trace_event`` JSON
  (Perfetto-renderable).  Off by default.
* :class:`~repro_torch.obs.recorder.FlightRecorder` — a bounded ring of
  recent transport events, for a postmortem dump (``Obs.dump``).

:class:`Obs` ties them together and is what the transport layers carry:
``Dispatcher(ctx, engine, obs=Obs(trace=True))``.  The default
(``Obs()``) is counters-only observability — metrics + recorder on,
tracing off — priced for the hot path (an enabled-flag test and a ring
append per *container*, not per message).  ``Obs(enabled=False)`` is the
true off switch benchmarks use as the uninstrumented baseline arm.
"""

from __future__ import annotations

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Registry,
                                     delta, merge_snapshots)
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import Span, Tracer


class Obs:
    """The observability bundle one fabric (dispatcher/engine/runtime
    cluster) shares.  All hooks test :attr:`enabled` / :attr:`tracing`
    before doing work, so a disabled bundle costs attribute reads only.
    """

    def __init__(self, name: str = "repro_torch", *, enabled: bool = True,
                 trace: bool = False, recorder_capacity: int = 256,
                 dump_on_fail: bool = True):
        self.name = name
        self.enabled = enabled
        self.metrics = Registry(name)
        self.tracer = Tracer(enabled=enabled and trace)
        self.recorder = FlightRecorder(recorder_capacity)
        #: auto-dump the flight recorder to stderr when a liveness failure
        #: resolves frames (read by the liveness path that declares a
        #: peer dead)
        self.dump_on_fail = dump_on_fail
        # the cross-layer latency distributions, pre-created so hook
        # sites hold direct references (no registry lookup per event)
        self.rtt_hist = self.metrics.histogram("transport.deliver_us")
        self.sweep_hist = self.metrics.histogram("target.sweep_us")
        self.exec_hist = self.metrics.histogram("target.exec_us")
        self.reply_hist = self.metrics.histogram("task.reply_us")

    @property
    def tracing(self) -> bool:
        return self.tracer.enabled

    def set_tracing(self, on: bool) -> None:
        self.tracer.enabled = bool(on) and self.enabled

    def record(self, kind: str, peer: str = "", info: str = "") -> None:
        """Flight-recorder append (no-op when the bundle is disabled)."""
        if self.enabled:
            self.recorder.add(kind, peer, info)

    def dump(self, reason: str = "", stream=None) -> str:
        return self.recorder.dump(reason, stream=stream)

    def snapshot(self) -> dict:
        return self.metrics.snapshot()

    def to_text(self) -> str:
        return self.metrics.to_text()


__all__ = ["Counter", "FlightRecorder", "Gauge", "Histogram", "Obs",
           "Registry", "Span", "Tracer", "delta", "merge_snapshots"]
