"""Multi-peer ifunc dispatcher: N peers x M rings, credit-based flow
control, per-peer backpressure, and a fairness-aware poll loop.

A :class:`Dispatcher` owns any number of :class:`Peer` s — each a
(fabric, channel(s), mailbox(s), target context) bundle — and

* ``send`` consumes a credit (one free ring slot) or reports backpressure
  instead of silently overwriting unconsumed frames;
* credits return as the target's sweep advances its mailbox ``consumed``
  counter (the credit-return counter a real target writes back);
* ``poll`` drains mailboxes round-robin, starting one past the lane served
  first last time, so a chatty peer cannot starve the rest;
* all sends go through a shared :class:`ProgressEngine`, so batching,
  in-flight windows, and completions are uniform across fabrics.

Every frame is packed straight into the engine's slab cell for its ring
slot.  Device-mesh lanes are always SLIM-eligible: the μVM program is
bound at mailbox-open time, so code words never travel — ``send`` elides
the code section while staging.

This package carries the device lanes only.  Host lanes (with their
digest confirmation and NACK retransmits), coalesced aggregates, streams,
the reply path and liveness failure come with the modules they need.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.core import frame as F
from repro_torch.core.api import Status
from repro_torch.transport.fabric import Fabric, TransportError
from repro_torch.transport.progress import ProgressEngine

DEFAULT_SLOT_SIZE = 64 << 10
DEFAULT_N_SLOTS = 8

#: the per-peer stats schema, seeded at construction so
#: ``per_peer_stats()`` always returns the same keys
_PEER_STAT_KEYS = ("sent", "bytes", "delivered", "rejected", "backpressure",
                   "inflight_polls", "slim_sent")


@dataclass
class _TxRec:
    """Source-side record of one in-flight frame."""

    name: str
    digest: bytes
    handle: object          # IfuncHandle (None for raw-frame sends)
    slim: bool
    corr_id: int = 0
    sent_at: float = field(default_factory=time.monotonic)


@dataclass
class RingState:
    """One (mailbox, channel) lane of a peer."""

    mailbox: object
    channel: object
    tail: int = 0            # source-side produce index

    @property
    def credits(self) -> int:
        return self.mailbox.n_slots - (self.tail - self.mailbox.consumed)


@dataclass
class Peer:
    name: str
    fabric: Fabric
    target_ctx: object
    target_args: dict
    rings: list[RingState] = field(default_factory=list)
    stats: dict = field(
        default_factory=lambda: dict.fromkeys(_PEER_STAT_KEYS, 0))

    @property
    def credits(self) -> int:
        return sum(r.credits for r in self.rings)

    def summary(self) -> str:
        s = self.stats
        return (f"{self.name:<12s} fabric={self.fabric.kind:<9s} "
                f"sent={s['sent']:<4d} slim={s['slim_sent']:<4d} "
                f"delivered={s['delivered']:<4d} "
                f"rejected={s['rejected']:<3d} "
                f"backpressure={s['backpressure']:<3d} "
                f"credits={self.credits}")


class Dispatcher:
    """One source fanning ifunc frames out to device-mesh targets."""

    def __init__(self, src_ctx=None, engine: ProgressEngine | None = None):
        self.src_ctx = src_ctx
        self.engine = engine if engine is not None else ProgressEngine()
        self.peers: dict[str, Peer] = {}
        self._rr = 0             # fairness cursor over (peer, ring) lanes
        self.stats = {"sent": 0, "polled": 0, "poll_rounds": 0}

    # -- topology -----------------------------------------------------------

    def add_peer(self, name: str, fabric: Fabric, target_ctx, *,
                 n_slots: int = DEFAULT_N_SLOTS,
                 slot_size: int = DEFAULT_SLOT_SIZE,
                 rings: int = 1, target_args: dict | None = None,
                 **mailbox_kw) -> Peer:
        """``mailbox_kw`` passes backend-specific binds through to
        ``fabric.open_mailbox`` (``prog=``/``externals=``/``n_tiles=`` on
        the device-mesh fabric)."""
        if name in self.peers:
            raise TransportError(f"peer {name!r} already attached")
        if fabric.kind != "device":
            raise TransportError(
                f"{fabric.kind!r} lanes are not ported yet (device only)")
        peer = Peer(name, fabric, target_ctx,
                    target_args if target_args is not None else {})
        for _ in range(rings):
            mb = fabric.open_mailbox(target_ctx, n_slots, slot_size,
                                     **mailbox_kw)
            ch = fabric.connect(self.src_ctx, mb)
            peer.rings.append(RingState(mb, ch))
        self.peers[name] = peer
        return peer

    # -- source side --------------------------------------------------------

    @staticmethod
    def _slim_ok(peer: Peer, lib) -> bool:
        """SLIM-eligible: device lanes link at mailbox-open time, so code
        never travels."""
        return peer.fabric.kind == "device"

    @staticmethod
    def _pick_lane(peer: Peer, ring: int | None) -> RingState | None:
        lanes = peer.rings if ring is None else [peer.rings[ring]]
        lane = max(lanes, key=lambda r: r.credits)
        return lane if lane.credits > 0 else None

    def _post_view(self, peer: Peer, lane: RingState, view, rec,
                   on_complete) -> None:
        self.engine.post(lane.channel, view, lane.tail, peer=peer.name,
                         on_complete=on_complete)
        lane.tail += 1
        peer.stats["sent"] += 1
        peer.stats["bytes"] += len(view)
        if rec is not None and rec.slim:
            peer.stats["slim_sent"] += 1
        self.stats["sent"] += 1

    def _slab_post(self, peer: Peer, lane: RingState, frame, rec,
                   on_complete=None) -> None:
        """Stage a ready frame into the lane's slab cell and post it."""
        slab = self.engine.slab_slot(lane.channel, lane.tail)
        n = len(frame)
        if n > len(slab):
            raise TransportError(
                f"frame {n}B exceeds slot {lane.mailbox.slot_size}B")
        slab[:n] = frame
        self._post_view(peer, lane, slab[:n], rec, on_complete)

    def send(self, peer_name: str, msg, *, ring: int | None = None,
             on_complete=None) -> bool:
        """Post one ifunc message to a peer.  Returns False (and counts a
        backpressure event) when every eligible ring is out of credits.

        The frame is staged into the engine's slab cell for the chosen ring
        slot, with the code section elided on the fly when the peer links
        at open time (SLIM framing)."""
        peer = self.peers[peer_name]
        lane = self._pick_lane(peer, ring)
        if lane is None:
            peer.stats["backpressure"] += 1
            return False
        frame = msg.frame if hasattr(msg, "frame") else msg
        handle = getattr(msg, "handle", None)
        if handle is None:                       # raw frame: no slim protocol
            self._slab_post(peer, lane, frame, None, on_complete)
            return True
        lib = handle.lib
        corr_id = getattr(msg, "corr_id", 0)
        if getattr(msg, "cont", None) is not None:
            raise TransportError(
                "continuation frames are host-tier only (the device sweep "
                "has no forwarding hook)")
        already_slim = bool(getattr(msg, "slim", False))
        want_slim = self._slim_ok(peer, lib)
        rec = _TxRec(lib.name, lib.code_digest, handle,
                     already_slim or want_slim, corr_id=corr_id)
        if want_slim and not already_slim:
            # elide the code section while staging — the slab cell is the
            # only buffer the SLIM frame ever occupies
            slab = self.engine.slab_slot(lane.channel, lane.tail)
            n = F.pack_frame_into(slab, lib.name, b"", msg.payload_view,
                                  lib.kind, digest=lib.code_digest, slim=True,
                                  corr_id=corr_id)
            self._post_view(peer, lane, slab[:n], rec, on_complete)
        else:
            self._slab_post(peer, lane, frame, rec, on_complete)
        return True

    def flush(self) -> int:
        """Publish all in-flight puts (completes trailers -> frames become
        consumable at the targets)."""
        return self.engine.flush()

    # -- target side: fairness-aware poll loop ------------------------------

    def _lanes(self) -> list[tuple[Peer, RingState]]:
        return [(p, r) for p in self.peers.values() for r in p.rings]

    def poll(self, budget: int | None = None) -> int:
        """Drain up to ``budget`` messages total across all peers' rings,
        round-robin, starting one lane past last round's first server.  A
        device-mesh lane sweeps whole-ring (its sweep is one pass over every
        slot), so a poll can overshoot ``budget`` by one sweep.  Returns
        the messages delivered or rejected."""
        lanes = self._lanes()
        if not lanes:
            return 0
        done = 0
        self.stats["poll_rounds"] += 1
        progressed = True
        while progressed and (budget is None or done < budget):
            progressed = False
            start = self._rr % len(lanes)
            for k in range(len(lanes)):
                peer, lane = lanes[(start + k) % len(lanes)]
                if budget is not None and done >= budget:
                    break
                sts = lane.mailbox.sweep(peer.target_ctx, peer.target_args,
                                         budget=1)
                for st in sts:
                    if st == Status.OK:
                        peer.stats["delivered"] += 1
                        done += 1
                        progressed = True
                    elif st == Status.REJECTED:
                        peer.stats["rejected"] += 1
                        done += 1
                        progressed = True
                    elif st == Status.IN_PROGRESS:
                        peer.stats["inflight_polls"] += 1
            self._rr += 1
        self.stats["polled"] += done
        return done

    def drain(self, max_rounds: int = 64) -> int:
        """flush + poll until quiescent: no outstanding puts and no
        consumable frames (or ``max_rounds``).  Returns total messages
        delivered/rejected."""
        total = 0
        for _ in range(max_rounds):
            self.engine.progress()
            n = self.poll()
            total += n
            if n == 0 and self.engine.outstanding() == 0:
                break
        return total

    # -- reporting ----------------------------------------------------------

    def per_peer_stats(self) -> dict[str, dict]:
        return {name: dict(p.stats, credits=p.credits)
                for name, p in self.peers.items()}

    def print_stats(self) -> None:
        for p in self.peers.values():
            print(" ", p.summary())


__all__ = ["DEFAULT_N_SLOTS", "DEFAULT_SLOT_SIZE", "Dispatcher", "Peer",
           "RingState"]
