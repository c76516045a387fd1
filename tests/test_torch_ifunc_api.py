"""End-to-end ifunc API semantics on a host target (paper Listing 1.1/1.2
behaviours): ``tests/test_ifunc_api.py`` ported to ``repro_torch``, with
the port's own copies of the libraries, on the CPU."""

import pytest

from repro_torch.core import (AccessDenied, CodeKind, Context, RingBuffer,
                              SecurityPolicy, Status, ifunc_msg_create,
                              ifunc_msg_send_nbix, poll_ifunc, poll_ring,
                              register_ifunc)
from repro_torch.core.registry import lib_dir as port_lib_dir


@pytest.fixture()
def libs():
    return port_lib_dir()


@pytest.fixture()
def pair(libs):
    src = Context("src", lib_dir=libs, device="cpu")
    dst = Context("dst", lib_dir=libs, link_mode="remote", device="cpu")
    ep = src.nic.connect(dst.nic)
    region = dst.nic.mem_map(1 << 20)
    return src, dst, ep, region


def _send(src, ep, region, name="counter_bump", payload=b"x"):
    h = src.handles.get(name) or register_ifunc(src, name)
    m = ifunc_msg_create(h, payload)
    ifunc_msg_send_nbix(ep, m, region.base, region.rkey)
    return m


def test_execute_and_cache(pair):
    src, dst, ep, region = pair
    targs = {}
    for _ in range(3):
        _send(src, ep, region, payload=b"abc")
        assert poll_ifunc(dst, region.view(), None, targs) == Status.OK
    assert targs["count"] == 3
    assert dst.stats["links"] == 1          # first arrival linked, rest cached


def test_code_change_relinks(pair, libs, tmp_path):
    """Paper: 'the code can be modified anytime under the same ifunc name'."""
    _, dst, _, region = pair
    base = (libs / "counter_bump.py").read_text()
    (tmp_path / "counter_bump.py").write_text(base)
    targs = {}
    src1 = Context("s1", lib_dir=tmp_path, device="cpu")
    _send(src1, src1.nic.connect(dst.nic), region)
    assert poll_ifunc(dst, region.view(), None, targs) == Status.OK
    (tmp_path / "counter_bump.py").write_text(base.replace("+ 1", "+ 100"))
    src2 = Context("s2", lib_dir=tmp_path, device="cpu")
    _send(src2, src2.nic.connect(dst.nic), region)
    assert poll_ifunc(dst, region.view(), None, targs) == Status.OK
    assert targs["count"] == 101            # new semantics took effect
    assert dst.stats["links"] == 2          # re-linked under the same name


def test_local_lib_mode(libs):
    """Paper-prototype mode: target loads the library from its own fs."""
    src = Context("src", lib_dir=libs, device="cpu")
    dst = Context("dst", lib_dir=libs, link_mode="local", device="cpu")
    ep = src.nic.connect(dst.nic)
    region = dst.nic.mem_map(1 << 20)
    targs = {}
    _send(src, ep, region)
    assert poll_ifunc(dst, region.view(), None, targs) == Status.OK
    assert targs["count"] == 1


def test_no_message(pair):
    _, dst, _, region = pair
    assert poll_ifunc(dst, region.view(), None, {}) == Status.NO_MESSAGE


def test_trailer_inflight_then_flush(pair):
    src, dst, ep, region = pair
    dst.max_trailer_spins = 50
    h = register_ifunc(src, "counter_bump")
    m = ifunc_msg_create(h, b"payload")
    ep.put_nbi(m.frame, region.base, region.rkey, deliver_bytes=m.nbytes - 3)
    assert poll_ifunc(dst, region.view(), None, {}) == Status.IN_PROGRESS
    ep.flush()
    assert poll_ifunc(dst, region.view(), None, {}) == Status.OK


def test_bad_rkey_rejected_at_hca(pair):
    src, _, ep, region = pair
    h = register_ifunc(src, "counter_bump")
    m = ifunc_msg_create(h, b"x")
    with pytest.raises(AccessDenied):
        ep.put_nbi(m.frame, region.base, region.rkey ^ 0xDEAD)
    assert ep.stats["rejected"] == 1
    assert not any(region.buf)              # no byte moved


def test_kind_allowlist(pair, libs):
    src, _, _, _ = pair
    dst = Context("dst2", lib_dir=libs, device="cpu", policy=SecurityPolicy(
        allowed_kinds=frozenset({CodeKind.UVM})))
    region = dst.nic.mem_map(1 << 20)
    _send(src, src.nic.connect(dst.nic), region)   # PYBC
    assert poll_ifunc(dst, region.view(), None, {}) == Status.REJECTED
    assert "not allowed" in dst.stats["last_reject"]


def test_hmac_required(libs):
    dst = Context("d", lib_dir=libs, device="cpu",
                  policy=SecurityPolicy(hmac_key=b"k1"))
    region = dst.nic.mem_map(1 << 20)
    signed = Context("s", lib_dir=libs, device="cpu",
                     policy=SecurityPolicy(hmac_key=b"k1"))
    targs = {}
    _send(signed, signed.nic.connect(dst.nic), region)
    assert poll_ifunc(dst, region.view(), None, targs) == Status.OK

    unsigned = Context("s2", lib_dir=libs, device="cpu")  # no key, no hmac
    _send(unsigned, unsigned.nic.connect(dst.nic), region)
    assert poll_ifunc(dst, region.view(), None, targs) == Status.REJECTED
    assert "HMAC" in dst.stats["last_reject"]


def test_ring_buffer_n_messages(pair):
    src, dst, ep, _ = pair
    rb_region = dst.nic.mem_map(32 << 10)
    ring = RingBuffer(rb_region, 2 << 10)
    h = register_ifunc(src, "counter_bump")
    for i in range(10):
        m = ifunc_msg_create(h, bytes([i]) * 16)
        ifunc_msg_send_nbix(ep, m, ring.slot_addr(ring.tail), rb_region.rkey)
        ring.tail += 1
        if (i + 1) % ring.n_slots == 0:      # drain when full
            targs = {}
            while poll_ring(dst, ring, targs) == Status.OK:
                pass
    targs = {}
    while poll_ring(dst, ring, targs) == Status.OK:
        pass
    assert dst.stats["executed"] == 10
    assert ring.head == 10


def test_paper_usage_example(pair):
    """§3.2: ship codec+insert to a target that doesn't know the format."""
    src, dst, ep, region = pair
    h = register_ifunc(src, "rle_insert")
    record = b"zzzzzyyyyy" * 32
    m = ifunc_msg_create(h, record)
    assert m.nbytes < len(record) + 1200     # payload travelled compressed
    ifunc_msg_send_nbix(ep, m, region.base, region.rkey)
    db = {"db": []}
    assert poll_ifunc(dst, region.view(), None, db) == Status.OK
    assert db["db"] == [record]
