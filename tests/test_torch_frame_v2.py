"""Frame v2's cached fast path on the port, held against the reference:
``tests/test_frame_v2.py`` case by case — SLIM frames, digest keying, the
NACK fallback and the slab send path through the ``Dispatcher``'s host
lanes.

Every case runs through both packages on the same inputs (PYBC libraries
loaded from ``ifunc_libs/`` into both registries, so frames are equal bit
for bit) and the two must agree on frame bytes, statuses, target and
dispatcher stats, target_args and slot bytes.  The fletcher32 equivalence
case is a parametrisation of ``tests/test_torch_frame.py::
test_fletcher32_equal``.
"""

import hashlib

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - optional dep (see requirements.txt)
    from _hypothesis_stub import given, settings, st

from repro.core import frame as RF
from repro_torch.core import frame as F
from test_torch_transport import PKGS, PORT, both, ctx, same_run

FRAMES = (RF, F)


# ---------------------------------------------------------------------------
# frame layer


def test_full_slim_roundtrip():
    code, payload = b"\x07" * 4096, b"payload-bytes"
    out = []
    for M in FRAMES:
        digest = M.compute_digest(code)
        full = M.pack_frame("f", code, payload, M.CodeKind.PYBC,
                            digest=digest)
        slim = M.pack_frame("f", code, payload, M.CodeKind.PYBC,
                            digest=digest, slim=True)
        hf, hs = M.peek_header(full), M.peek_header(slim)
        assert not hf.is_slim and hs.is_slim
        assert hf.digest == hs.digest == digest
        assert hs.code_offset == hs.payload_offset == M.HEADER_LEN
        assert len(slim) == len(full) - len(code)
        cf, pf = M.frame_sections(full, hf)
        cs, ps = M.frame_sections(slim, hs)
        assert cf == code and len(cs) == 0
        assert pf == payload and ps == payload
        assert M.trailer_arrived(slim, hs)
        out.append((bytes(full), bytes(slim)))
    assert out[1] == out[0]


def test_frame_sections_are_views():
    out = []
    for M in FRAMES:
        buf = M.pack_frame("v", b"c" * 64, b"p" * 64, M.CodeKind.PYBC)
        hdr = M.peek_header(buf)
        code, payload = M.frame_sections(buf, hdr)
        assert isinstance(code, memoryview) and isinstance(payload,
                                                           memoryview)
        assert code.obj is buf and payload.obj is buf      # zero-copy
        out.append(bytes(buf))
    assert out[1] == out[0]


def test_pack_into_slab_reuse():
    out = []
    for M in FRAMES:
        slab = bytearray(8 << 10)
        n1 = M.pack_frame_into(slab, "a", b"code1", b"payload1",
                               M.CodeKind.PYBC)
        h1 = M.peek_header(slab)
        assert h1.frame_len == n1 and h1.name == "a"
        n2 = M.pack_frame_into(slab, "b", b"xx", b"yy", M.CodeKind.HLO)
        h2 = M.peek_header(slab)
        assert (h2.frame_len, h2.name, h2.code_kind) == (n2, "b",
                                                         M.CodeKind.HLO)
        c, p = M.frame_sections(slab, h2)
        assert c == b"xx" and p == b"yy"
        out.append(bytes(slab))
    assert out[1] == out[0]


def test_seal_frame_two_phase():
    """payload_init-style flow: payload first, header sealed around it."""
    out = []
    for M in FRAMES:
        slab = memoryview(bytearray(4 << 10))
        code = b"C" * 100
        pv = M.frame_payload_view(slab, len(code), 64)
        pv[:5] = b"hello"
        n = M.seal_frame(slab, "tp", code, M.CodeKind.PYBC, 5)
        hdr = M.peek_header(slab)
        assert hdr.frame_len == n == M.HEADER_LEN + 100 + 5 + M.TRAILER_LEN
        c, p = M.frame_sections(slab, hdr)
        assert c == code and p == b"hello"
        out.append(bytes(slab))
    assert out[1] == out[0]


def test_oversized_frame_rejected_by_slab():
    for M in FRAMES:
        with pytest.raises(M.FrameError):
            M.pack_frame_into(bytearray(64), "x", b"c" * 100, b"",
                              M.CodeKind.PYBC)


def test_clear_frame_allocation_free_large():
    """A frame larger than the reference's 64 KiB zeros slab clears whole
    in both (the reference clears it chunk-wise)."""
    out = []
    for M in FRAMES:
        big = M.pack_frame("big", b"", b"\xff" * (150 << 10),
                           M.CodeKind.PYBC)
        hdr = M.peek_header(big)
        assert hdr.frame_len > len(RF._ZEROS)
        M.clear_frame(big, hdr)
        assert not any(big)
        assert M.peek_header(big) is None
        out.append(len(big))
    assert out[1] == out[0]


@given(data=st.binary(min_size=0, max_size=5000))
@settings(max_examples=80, deadline=None)
def test_fletcher32_numpy_matches_pure(data):
    """Property: the port's fletcher32 equals the reference's byte loop for
    every input, odd lengths included."""
    assert F.fletcher32(data) == RF.fletcher32_py(data) == RF.fletcher32(data)


# ---------------------------------------------------------------------------
# api layer


class Pair:
    """One package's source and remote-linking target over its RDMA
    emulation, with a 1 MiB mapped region."""

    def __init__(self, pkg, lib_dir):
        self.pkg, self.core = pkg, pkg.core
        self.src = ctx(pkg, "src", lib_dir)
        self.dst = ctx(pkg, "dst", lib_dir, link_mode="remote")
        self.ep = self.src.nic.connect(self.dst.nic)
        self.region = self.dst.nic.mem_map(1 << 20)
        self.lib_dir = lib_dir

    def handle(self, name):
        return self.core.register_ifunc(self.src, name, self.lib_dir)

    def send(self, msg):
        self.core.ifunc_msg_send_nbix(self.ep, msg, self.region.base,
                                      self.region.rkey)

    def poll(self, targs):
        return self.core.poll_ifunc(self.dst, self.region.view(), None,
                                    targs).name

    def state(self, targs):
        return dict(self.dst.stats), dict(targs), bytes(self.region.buf)


@pytest.fixture()
def pairs(lib_dir):
    return [Pair(pkg, lib_dir) for pkg in PKGS]


def test_msg_create_no_double_pack(pairs):
    """Shrinking payloads truncate in place: the frame is exactly sized and
    the code section written once (rle compresses 320 -> ~4 bytes)."""
    out = []
    for p in pairs:
        h = p.handle("rle_insert")
        m = p.core.ifunc_msg_create(h, b"z" * 320)
        M = FRAMES[p.pkg is PORT]
        hdr = M.peek_header(m.frame)
        used = hdr.frame_len - hdr.payload_offset - M.TRAILER_LEN
        assert used < 320
        assert m.nbytes == hdr.frame_len
        code, _ = M.frame_sections(m.frame, hdr)
        assert bytes(code) == h.lib.code
        out.append(bytes(m.frame))
    assert out[1] == out[0]


def test_slim_msg_and_to_full(pairs):
    out = []
    for p in pairs:
        M = FRAMES[p.pkg is PORT]
        h = p.handle("counter_bump")
        slim = p.core.ifunc_msg_create(h, b"abc", slim=True)
        assert slim.slim and M.peek_header(slim.frame).is_slim
        full = p.core.ifunc_msg_to_full(slim)
        assert not full.slim
        hdr = M.peek_header(full.frame)
        code, payload = M.frame_sections(full.frame, hdr)
        assert bytes(code) == h.lib.code and payload == b"abc"
        out.append((bytes(slim.frame), bytes(full.frame)))
    assert out[1] == out[0]


def test_slim_to_cold_target_nacks(pairs):
    """SLIM frame, nothing cached: consumed as NACK_UNCACHED, slot cleared,
    nothing executed."""
    out = []
    for p in pairs:
        h = p.handle("counter_bump")
        p.send(p.core.ifunc_msg_create(h, b"x", slim=True))
        targs = {}
        sts = [p.poll(targs)]
        assert targs.get("count") is None
        assert p.dst.stats["nacks"] == 1
        assert p.dst.stats["last_nack"] == (h.name, h.digest)
        sts.append(p.poll(targs))
        assert sts == ["NACK_UNCACHED", "NO_MESSAGE"]
        out.append(p.state(targs))
    assert out[1] == out[0]


def test_slim_hit_after_full_warmup(pairs):
    out = []
    for p in pairs:
        h = p.handle("counter_bump")
        targs = {}
        p.send(p.core.ifunc_msg_create(h, b"w"))          # FULL warms
        sts = [p.poll(targs)]
        p.send(p.core.ifunc_msg_create(h, b"x", slim=True))
        sts.append(p.poll(targs))
        assert sts == ["OK", "OK"] and targs["count"] == 2
        assert p.dst.stats["links"] == 1                  # no relink
        out.append(p.state(targs))
    assert out[1] == out[0]


def _hit_path_never_hashes(pairs, monkeypatch, slim):
    out = []
    for p in pairs:
        h = p.handle("counter_bump")
        targs = {}
        p.send(p.core.ifunc_msg_create(h, b"w"))
        assert p.poll(targs) == "OK"
        with monkeypatch.context() as m:
            def boom(*a, **kw):
                raise AssertionError("sha256 called on the cached hit path")
            m.setattr(hashlib, "sha256", boom)
            for _ in range(3):
                # the digest was precomputed at register time
                p.send(p.core.ifunc_msg_create(h, b"x", slim=slim))
                assert p.poll(targs) == "OK"
        assert targs["count"] == 4
        out.append(p.state(targs))
    assert out[1] == out[0]


def test_slim_hit_path_never_hashes(pairs, monkeypatch):
    """No sha256 call anywhere on the SLIM hit path."""
    _hit_path_never_hashes(pairs, monkeypatch, slim=True)


def test_full_hit_path_never_hashes(pairs, monkeypatch):
    """FULL frames on a warm cache also dispatch by header digest alone."""
    _hit_path_never_hashes(pairs, monkeypatch, slim=False)


def test_digest_mismatch_rejected(pairs):
    """A FULL frame whose header digest does not match its code section is
    rejected at link time (corrupt code or forged header)."""
    out = []
    for p in pairs:
        M = FRAMES[p.pkg is PORT]
        h = p.handle("counter_bump")
        frame = M.pack_frame(h.name, h.lib.code, b"x", h.lib.kind,
                             digest=b"\xde\xad" * 8)
        p.ep.put_nbi(frame, p.region.base, p.region.rkey)
        targs = {}
        assert p.poll(targs) == "REJECTED"
        assert "digest mismatch" in p.dst.stats["last_reject"]
        assert targs.get("count") is None
        out.append(p.state(targs))
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# transport layer: negotiation, NACK fallback, slab send path


def _mk(pkg, lib_dir, n_slots=4, slot_size=8 << 10):
    T = pkg.transport
    d = T.Dispatcher(ctx(pkg, "src", lib_dir),
                     T.ProgressEngine(flush_threshold=64))
    tgt = ctx(pkg, "p", lib_dir, link_mode="remote")
    d.add_peer("p", T.RdmaFabric(), tgt, n_slots=n_slots,
               slot_size=slot_size, target_args={"db": []})
    return d, tgt


def _reg(pkg, d, lib_dir, name="rle_insert"):
    return pkg.core.register_ifunc(d.src_ctx, name, lib_dir)


def _negotiates(pkg, lib_dir):
    d, tgt = _mk(pkg, lib_dir)
    h = _reg(pkg, d, lib_dir)
    peer = d.peers["p"]
    assert d.send("p", pkg.core.ifunc_msg_create(h, b"a"))
    assert peer.stats["slim_sent"] == 0
    d.drain()
    assert h.digest in peer.cached                     # confirmed
    assert d.send("p", pkg.core.ifunc_msg_create(h, b"b"))   # auto-SLIM
    assert d.send_ifunc("p", h, b"c")                  # packed SLIM
    d.drain()
    assert peer.stats["slim_sent"] == 2 and peer.stats["nacks"] == 0
    assert peer.target_args["db"] == [b"a", b"b", b"c"]
    assert tgt.stats["links"] == 1
    return d


def test_dispatcher_negotiates_slim(lib_dir):
    """FULL until the delivery confirms the target cache, SLIM after — for
    both send(msg) and the zero-copy send_ifunc."""
    same_run(*both(_negotiates, lib_dir))


def _nack_retransmit(pkg, lib_dir):
    d, tgt = _mk(pkg, lib_dir)
    h = _reg(pkg, d, lib_dir)
    peer = d.peers["p"]
    assert d.send_ifunc("p", h, b"first")
    d.drain()
    assert h.digest in peer.cached
    tgt.link_cache.invalidate(h.name)                  # eviction / restart
    assert d.send_ifunc("p", h, b"second")             # goes out SLIM
    assert d.drain() == 1                              # the resend lands
    assert peer.stats["nacks"] == 1 and peer.stats["resent"] == 1
    assert tgt.stats["nacks"] == 1
    assert peer.target_args["db"] == [b"first", b"second"]
    assert h.digest in peer.cached                     # re-confirmed
    assert not peer.resend
    assert d.send_ifunc("p", h, b"third")              # SLIM again
    d.drain()
    assert peer.target_args["db"][-1] == b"third"
    assert peer.stats["nacks"] == 1
    return d


def test_nack_triggers_full_retransmit(lib_dir):
    """A target cache eviction: the SLIM frame NACKs, the dispatcher
    rebuilds the FULL frame from the slab payload and redelivers it."""
    same_run(*both(_nack_retransmit, lib_dir))


def _backlog(pkg, lib_dir):
    d, tgt = _mk(pkg, lib_dir, n_slots=8)
    h = _reg(pkg, d, lib_dir)
    peer = d.peers["p"]
    assert d.send_ifunc("p", h, b"w")
    d.drain()
    tgt.link_cache.invalidate(h.name)
    recs = [bytes([65 + i]) * 4 for i in range(4)]
    for r in recs:
        assert d.send_ifunc("p", h, r)                 # all SLIM, all doomed
    d.drain()
    assert peer.stats["nacks"] == 4 and peer.stats["resent"] == 4
    assert peer.target_args["db"] == [b"w"] + recs
    assert peer.credits == 8
    return d


def test_eviction_under_backlog_preserves_order(lib_dir):
    """Several SLIM frames in flight when the cache evicts: all NACK, all
    resend FULL — in ring order, after the storm is fully observed."""
    same_run(*both(_backlog, lib_dir))


def _retransmittable(pkg, lib_dir):
    d, _ = _mk(pkg, lib_dir, slot_size=8 << 10)
    h = _reg(pkg, d, lib_dir, "bench_hot")             # ~256 KiB of code
    d.peers["p"].cached.add(h.digest)                  # pretend confirmed
    errs = []
    for call in (lambda: d.send_ifunc("p", h, b"tiny"),
                 lambda: d.send("p", pkg.core.ifunc_msg_create(
                     h, b"tiny", slim=True))):
        with pytest.raises(pkg.transport.TransportError,
                           match="FULL fallback") as e:
            call()
        errs.append(str(e.value))
    return d, errs


def test_slim_send_requires_retransmittable_full(lib_dir):
    """A SLIM frame whose FULL fallback could not fit the ring slot is
    refused at send time."""
    (rd, re_), (pd, pe) = both(_retransmittable, lib_dir)
    assert pe == re_
    same_run(rd, pd)


def _slab_backed(pkg, lib_dir):
    d, _ = _mk(pkg, lib_dir)
    h = _reg(pkg, d, lib_dir)
    lane = d.peers["p"].rings[0]
    seen = []
    orig_put = lane.channel.put

    def spy(data, slot, **kw):
        seen.append(type(data))
        return orig_put(data, slot, **kw)

    lane.channel.put = spy
    d.send("p", pkg.core.ifunc_msg_create(h, b"via-send"))
    d.send_ifunc("p", h, b"via-send-ifunc")
    d.drain()
    assert seen == [memoryview, memoryview]
    assert d.engine.stats["slab_bytes"] > 0
    assert d.peers["p"].target_args["db"] == [b"via-send",
                                              b"via-send-ifunc"]
    return d


def test_send_path_is_slab_backed(lib_dir):
    """Frames reach the channel as memoryviews into the engine-owned slab —
    no per-message bytearray on the send path."""
    same_run(*both(_slab_backed, lib_dir))
