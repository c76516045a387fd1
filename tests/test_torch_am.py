"""UCX Active Message baseline semantics (the paper's comparison system):
``tests/test_am.py`` ported to ``repro_torch``."""

import pytest

from repro_torch.core import AmContext, AmEndpoint
from repro_torch.core.active_message import AmError


def test_eager_and_rndv_paths():
    a, b = AmContext("a"), AmContext("b")
    seen = []
    b.register(3, lambda p, n, t: seen.append(n))
    ep = AmEndpoint(a, b)
    ep.send(3, b"small")
    ep.send(3, b"L" * 100_000)        # > rndv threshold
    ep.flush()
    assert b.progress() == 2
    assert seen == [5, 100_000]
    assert b.stats == {"executed": 2, "bytes_in": 100_005}


def test_unregistered_handler_raises():
    """AM handlers are fixed at the target 'at compile time' — an unknown ID
    is an application error (vs ifunc: code arrives with the message)."""
    a, b = AmContext("a"), AmContext("b")
    ep = AmEndpoint(a, b)
    ep.send(9, b"x")
    with pytest.raises(AmError):
        b.progress()


def test_target_side_registration_contrast():
    """The paper's key asymmetry: AM registers at the TARGET, ifunc at the
    SOURCE.  A brand-new target can execute a never-seen ifunc, but not a
    never-registered AM."""
    from repro_torch.core import (Context, Status, ifunc_msg_create,
                                  ifunc_msg_send_nbix, poll_ifunc,
                                  register_ifunc)

    src = Context("src", device="cpu")
    fresh_target = Context("fresh", link_mode="remote", device="cpu")
    region = fresh_target.nic.mem_map(1 << 20)
    ep = src.nic.connect(fresh_target.nic)
    h = register_ifunc(src, "counter_bump")     # source-side only
    m = ifunc_msg_create(h, b"x")
    ifunc_msg_send_nbix(ep, m, region.base, region.rkey)
    t = {}
    assert poll_ifunc(fresh_target, region.view(), None, t) == Status.OK
    assert t["count"] == 1


def test_ordering_preserved():
    a, b = AmContext("a"), AmContext("b")
    got = []
    b.register(1, lambda p, n, t: got.append(bytes(p)))
    ep = AmEndpoint(a, b)
    for i in range(20):
        ep.send(1, bytes([i]))
    ep.flush()
    b.progress()
    assert got == [bytes([i]) for i in range(20)]
