"""Result futures for dispatched ifunc tasks.

A :class:`Future` is the source-side end of one corr_id: created by
``TaskRuntime.submit``, marked SENT when the progress engine's flush
publishes the request frame, resolved when the dispatcher's reply demux
routes the matching reply (or device sweep result) back.

Single-threaded by design, like the rest of the emulation: ``result()``
does not block a thread, it *drives the runtime's progress loop* until the
reply lands or the deadline passes — the moral equivalent of
``ucp_worker_progress`` inside ``ucp_request_wait``.
"""

from __future__ import annotations

import enum
import time


class TaskTimeout(Exception):
    """No reply within the deadline (reply frame lost, target wedged)."""


class TaskState(enum.Enum):
    PENDING = 0          # created, request not yet flushed to the wire
    SENT = 1             # request published at the target; awaiting reply
    DONE = 2             # value available
    ERROR = 3            # remote exception (or local cancellation)


class Future:
    """One in-flight task's result slot."""

    def __init__(self, runtime, corr_id: int, peer: str, name: str):
        self._runtime = runtime
        self.corr_id = corr_id
        self.peer = peer
        self.name = name
        self.state = TaskState.PENDING
        self._value = None
        self._exc = None
        self._callbacks: list = []
        self.submitted_at = time.monotonic()
        self.resolved_at: float | None = None

    # -- state transitions (runtime/transport side) -------------------------

    def _mark_sent(self, seq: int | None = None) -> None:
        if self.state is TaskState.PENDING:
            self.state = TaskState.SENT

    def set_result(self, value) -> bool:
        """Resolve with a value.  Returns False (and changes nothing) if the
        future is already resolved — the duplicate-reply guard."""
        if self.done():
            return False
        self._value = value
        self.state = TaskState.DONE
        self._fire()
        return True

    def set_exception(self, exc: BaseException) -> bool:
        if self.done():
            return False
        self._exc = exc
        self.state = TaskState.ERROR
        self._fire()
        return True

    def _fire(self) -> None:
        self.resolved_at = time.monotonic()
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    # -- caller side --------------------------------------------------------

    def done(self) -> bool:
        return self.state in (TaskState.DONE, TaskState.ERROR)

    def exception(self, timeout: float | None = None):
        self._wait(timeout)
        return self._exc

    def result(self, timeout: float | None = None):
        """Value of the task, driving runtime progress while waiting.
        Raises the remote exception for error replies and
        :class:`TaskTimeout` when no reply arrives in time."""
        self._wait(timeout)
        if self.state is TaskState.ERROR:
            raise self._exc
        return self._value

    def add_done_callback(self, cb) -> None:
        if self.done():
            cb(self)
        else:
            self._callbacks.append(cb)

    def _wait(self, timeout: float | None) -> None:
        if self.done():
            return
        if timeout is None:
            timeout = self._runtime.default_timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.done():
            self._runtime.progress()
            if self.done():
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise TaskTimeout(
                    f"task {self.name}#{self.corr_id} to {self.peer}: no "
                    f"reply within {timeout:.3g}s (state={self.state.name})")

    def __repr__(self) -> str:
        return (f"<Future {self.name}#{self.corr_id} -> {self.peer} "
                f"{self.state.name}>")


def wait_all(futures, timeout: float | None = None) -> list:
    """Resolve every future (driving progress through the first one's
    runtime); returns their values, raising on the first error."""
    return [f.result(timeout) for f in futures]


__all__ = ["Future", "TaskState", "TaskTimeout", "wait_all"]
