"""Pluggable fabric layer: the transport contract every ifunc backend sits
on.

Three roles, mirroring a thin UCX:

* :class:`Mailbox`  — a target-owned ring of fixed-size frame slots.  The
  device fabric exposes word-frame slots swept by one fused sweep kernel.
* :class:`Channel`  — a source-side one-sided path into one mailbox.  A
  ``put`` is non-blocking: bytes may be partially visible until
  ``flush`` (the in-flight window the frame trailer exists for).
* :class:`Fabric`   — the factory tying the two together for one backend.

Only the device-mesh backend (``device_fabric.py``) is ported so far; the
host RDMA and loopback backends, whose sweeps run ``poll_ifunc``, follow.
"""

from __future__ import annotations


class TransportError(Exception):
    pass


class Mailbox:
    """A target-owned ring of ``n_slots`` frame slots of ``slot_size`` bytes.

    ``head`` is the consume index (advanced by the poller); the produce index
    lives with the source-side Channel.  ``consumed`` is the monotone count
    of drained slots — the source reads it to compute returned credits.
    """

    fabric: "Fabric"
    n_slots: int
    slot_size: int

    def __init__(self):
        self.head = 0
        self.consumed = 0
        #: coordinates of each status the most recent :meth:`sweep`
        #: returned, in order (see :meth:`slot_coords`)
        self.last_coords: list = []
        #: per-sub-record outcomes of each aggregate container a sweep
        #: consumed, keyed by its coordinate; popped by the dispatcher's
        #: aggregate completion, bounded by the mailbox that fills it
        self.last_agg: dict = {}

    def slot_coords(self, i: int):
        """Stable coordinate a produce index maps to (what ``last_coords``
        entries are keyed by).  Identity for in-order rings."""
        return i

    def slot_view(self, i: int) -> memoryview:
        raise NotImplementedError

    def sweep(self, ctx, target_args, budget: int | None = None) -> list:
        """Consume up to ``budget`` ready slots; returns the per-slot
        Status values observed.  OK and REJECTED consume the slot."""
        raise NotImplementedError


class Channel:
    """Source-side one-sided path into one remote Mailbox."""

    mailbox: Mailbox

    def __init__(self):
        self.stats = {"puts": 0, "bytes": 0, "flushes": 0, "partial": 0}

    def put(self, data, slot: int, *, deliver_bytes: int | None = None) -> None:
        """Non-blocking write of ``data`` into ring slot ``slot``.  With
        ``deliver_bytes`` only a prefix is visible until :meth:`flush`."""
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError


class Fabric:
    """One transport backend: makes mailboxes on targets, channels to them."""

    kind: str = "abstract"

    def open_mailbox(self, target_ctx, n_slots: int, slot_size: int) -> Mailbox:
        raise NotImplementedError

    def connect(self, src_ctx, mailbox: Mailbox) -> Channel:
        raise NotImplementedError


__all__ = ["Channel", "Fabric", "Mailbox", "TransportError"]
