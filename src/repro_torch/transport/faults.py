"""Deterministic fault injection for the transport layer.

Recovery code that can only be exercised by racing a real death against a
real poll loop is untestable; the :class:`FaultInjector` makes peer death,
heartbeat loss, and put loss *deterministic* so `tests/test_elastic.py`
and the ``fig_elastic`` bench can replay the exact same failure on every
run.  It is pure bookkeeping — the transport consults it at three choke
points and the injector never touches a buffer itself:

* ``kill_peer(name, after_delivered=N)`` — the peer is considered down
  once its dispatcher has seen N delivered frames for it (N=0: down now).
  ``Dispatcher.poll`` stops sweeping a down peer's mailboxes (frames
  already posted sit undelivered, exactly like a crashed process whose
  progress thread died), and ``ElasticController`` stops executing its
  beats, so death is observed the same way a real one would be: the
  heartbeat deadline lapses.
* ``delay_heartbeats(name, beats=k)`` — swallow the next k beats from a
  live peer (a GC pause / link flap, not a death); lets tests pin the
  deadline boundary.
* ``drop_put(name, kth)`` — the k-th subsequent ``_post_view`` for the
  peer vanishes on the wire: the tx record and tail advance stay (the
  source believes it posted), the bytes never land.  Exercises the
  liveness timeout -> ``fail_inflight`` path for a *lost* frame rather
  than a dead peer.

All counters are per-peer and monotone; a tripped kill stays tripped
until ``revive(name)`` (re-admission) clears it.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class _PeerFaults:
    kill_after: int | None = None   # delivered-frame threshold, None = never
    delivered: int = 0              # frames delivered so far (dispatcher-fed)
    down: bool = False              # latched once the threshold is crossed
    delay_beats: int = 0            # beats left to swallow
    drop_kth: int | None = None     # 1-based index of the put to drop
    puts_seen: int = 0              # puts observed since drop_put() was armed


class FaultInjector:
    """Deterministic per-peer fault schedule consulted by the transport."""

    def __init__(self) -> None:
        self._peers: dict[str, _PeerFaults] = {}
        self.stats = {"kills": 0, "dropped_puts": 0, "delayed_beats": 0}

    def _p(self, name: str) -> _PeerFaults:
        p = self._peers.get(name)
        if p is None:
            p = self._peers[name] = _PeerFaults()
        return p

    # -- schedule side ------------------------------------------------------

    def kill_peer(self, name: str, after_delivered: int = 0) -> None:
        """Peer ``name`` dies once ``after_delivered`` frames have been
        delivered to it (0 = immediately)."""
        p = self._p(name)
        p.kill_after = after_delivered
        if p.delivered >= after_delivered:
            self._trip(p)

    def delay_heartbeats(self, name: str, beats: int = 1) -> None:
        """Swallow the next ``beats`` heartbeats from ``name``."""
        self._p(name).delay_beats += beats

    def drop_put(self, name: str, kth: int = 1) -> None:
        """Drop the ``kth`` put posted to ``name`` from now (1-based)."""
        p = self._p(name)
        p.drop_kth = kth
        p.puts_seen = 0

    def revive(self, name: str) -> None:
        """Clear a latched kill (the peer restarted and is re-admitted)."""
        p = self._peers.get(name)
        if p is not None:
            p.down = False
            p.kill_after = None

    # -- transport side -----------------------------------------------------

    def _trip(self, p: _PeerFaults) -> None:
        if not p.down:
            p.down = True
            self.stats["kills"] += 1

    def is_down(self, name: str, delivered: int | None = None) -> bool:
        """True once the peer's kill threshold has been crossed.  The
        dispatcher feeds its running delivered-frame count; the latch keeps
        the answer stable for callers (controller, tests) that don't."""
        p = self._peers.get(name)
        if p is None:
            return False
        if delivered is not None:
            p.delivered = max(p.delivered, delivered)
        if (not p.down and p.kill_after is not None
                and p.delivered >= p.kill_after):
            self._trip(p)
        return p.down

    def should_drop_beat(self, name: str) -> bool:
        """Consume one scheduled heartbeat delay, if any."""
        p = self._peers.get(name)
        if p is not None and p.delay_beats > 0:
            p.delay_beats -= 1
            self.stats["delayed_beats"] += 1
            return True
        return False

    def should_drop_put(self, name: str) -> bool:
        """Consume the armed k-th-put drop when this put is the k-th."""
        p = self._peers.get(name)
        if p is None or p.drop_kth is None:
            return False
        p.puts_seen += 1
        if p.puts_seen == p.drop_kth:
            p.drop_kth = None
            self.stats["dropped_puts"] += 1
            return True
        return False
