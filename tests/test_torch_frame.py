"""The port's host framing against the JAX package's, bit for bit: ifunc
frames (FULL and SLIM), μVM code sections and digests, device word frames,
and header parsing."""

import numpy as np
import pytest

from repro.core import Context as RefContext
from repro.core import frame as RF
from repro.core import ifunc_msg_create as ref_msg_create
from repro.core import register_ifunc as ref_register
from repro.core import codegen as RCG
from repro.core.device_mailbox import pack_word_frame as ref_pack_word_frame
from repro_torch.core import Context, ifunc_msg_create, register_ifunc
from repro_torch.core import codegen as CG
from repro_torch.core import frame as F
from repro_torch.core.device_mailbox import pack_word_frame

T = 128

PROGRAMS = {
    "affine_relu": (
        [("loadp", 0), ("loade", 1, 0), ("matmul", 2, 0, 1), ("loade", 3, 1),
         ("add", 2, 2, 3), ("relu", 2, 2), ("store", 0, 2)], ("W", "b")),
    "gelu_scale": (
        [("loadp", 0), ("gelu", 1, 0), ("scale", 1, 1, 0, 0.25),
         ("store", 0, 1)], ()),
    "double_matmul": (
        [("loadp", 0), ("loade", 1, 0), ("matmul", 2, 0, 1),
         ("matmul", 3, 2, 1), ("sub", 3, 3, 0), ("store", 0, 3)], ("W",)),
    "fma_chain": (
        [("loadp", 0), ("copy", 1, 0), ("fma", 1, 0, 0), ("tanh", 1, 1),
         ("addi", 1, 1, 0, 0.5), ("store", 0, 1)], ()),
}


@pytest.fixture(scope="module")
def handles(lib_dir):
    return (ref_register(RefContext("ref", lib_dir=lib_dir), "uvm_affine"),
            register_ifunc(Context("port"), "uvm_affine"))


def test_uvm_affine_code_section_and_digest_equal(handles):
    ref, port = handles
    assert port.lib.code == ref.lib.code
    assert port.lib.code_digest == ref.lib.code_digest
    assert int(port.lib.kind) == int(ref.lib.kind) == 3


@pytest.mark.parametrize("slim", [False, True])
@pytest.mark.parametrize("corr_id", [0, 7])
@pytest.mark.parametrize("n_tiles", [1, 2])
def test_ifunc_msg_create_bytes_equal(handles, slim, corr_id, n_tiles):
    ref, port = handles
    x = np.random.default_rng(n_tiles).standard_normal(
        (n_tiles, T, T)).astype(np.float32)
    a = ref_msg_create(ref, x, slim=slim, corr_id=corr_id)
    b = ifunc_msg_create(port, x, slim=slim, corr_id=corr_id)
    assert bytes(b.frame) == bytes(a.frame)
    assert bytes(b.payload_view) == x.tobytes()


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_serialize_uvm_equal_and_cross_deserialize(name):
    instrs, symbols = PROGRAMS[name]
    rp, pp = RCG.assemble(instrs, symbols), CG.assemble(instrs, symbols)
    assert CG.serialize_uvm(pp) == RCG.serialize_uvm(rp)
    assert F.compute_digest(CG.serialize_uvm(pp)) == RF.compute_digest(
        RCG.serialize_uvm(rp))
    back = CG.deserialize_uvm(RCG.serialize_uvm(rp))
    for f in ("opcode", "dst", "a", "b", "imm"):
        np.testing.assert_array_equal(getattr(back, f), getattr(rp, f))
    assert (back.n_ext, back.symbols) == (rp.n_ext, rp.symbols)


def test_deserialize_uvm_rejects_bad_sections():
    code = CG.serialize_uvm(CG.assemble([("loadp", 0), ("store", 0, 0)]))
    with pytest.raises(CG.CodeVerifyError):
        CG.deserialize_uvm(b"\0" + code[1:])
    with pytest.raises(CG.CodeVerifyError):
        CG.deserialize_uvm(code[:-4])


@pytest.mark.parametrize("corrupt,no_trailer", [(False, False), (True, False),
                                                (False, True), (True, True)])
def test_pack_word_frame_equal(corrupt, no_trailer):
    x = np.random.default_rng(3).standard_normal((2, T, T)).astype(np.float32)
    slot_words = 5 + 2 * T * T + 1 + 7
    a = ref_pack_word_frame(x, slot_words, kind=3, name_hash=0x12345678,
                            corrupt=corrupt, no_trailer=no_trailer)
    b = pack_word_frame(x, slot_words, kind=3, name_hash=0x12345678,
                        corrupt=corrupt, no_trailer=no_trailer)
    assert b.dtype == np.uint32
    np.testing.assert_array_equal(b, a)


def test_pack_word_frame_too_long_raises():
    with pytest.raises(ValueError):
        pack_word_frame(np.zeros(10, np.float32), 15)


@pytest.mark.parametrize("n", [0, 1, 95, 96, 127, 128, 129, 4097])
def test_fletcher32_equal(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert F.fletcher32(data) == RF.fletcher32(data)


def test_peek_header_and_sections_round_trip(handles):
    ref, port = handles
    x = np.random.default_rng(5).standard_normal((1, T, T)).astype(np.float32)
    for slim in (False, True):
        frame = ifunc_msg_create(port, x, slim=slim, corr_id=99).frame
        hp, hr = F.peek_header(frame), RF.peek_header(frame)
        assert (hp.frame_len, hp.code_offset, hp.payload_offset, hp.name,
                hp.flags, hp.digest, hp.corr_id, hp.cont_offset) == (
            hr.frame_len, hr.code_offset, hr.payload_offset, hr.name,
            hr.flags, hr.digest, hr.corr_id, hr.cont_offset)
        assert int(hp.code_kind) == int(hr.code_kind)
        assert hp.is_slim is slim
        code, payload = F.frame_sections(frame, hp)
        assert bytes(code) == (b"" if slim else port.lib.code)
        assert bytes(payload) == x.tobytes()
        assert F.trailer_arrived(frame, hp)
        frame[-1] ^= 0xFF
        assert not F.trailer_arrived(frame, hp)
        F.clear_frame(frame, hp)
        assert F.peek_header(frame) is None
        assert not any(frame)


def _resigned(frame, off, value):
    """``frame`` with a 32-bit header field replaced and the signal redone."""
    buf = bytearray(frame)
    buf[off:off + 4] = int(value).to_bytes(4, "little")
    buf[F.SIGNAL_OFF:F.SIGNAL_OFF + 4] = F._header_fletcher(buf).to_bytes(
        4, "little")
    return buf


@pytest.mark.parametrize("case", ["clean", "byte0", "byte30", "byte61",
                                  "byte97",
                                  "stream_flag", "cont_flag", "agg_slim",
                                  "kind9", "short"])
def test_peek_header_accepts_and_rejects_like_reference(handles, case):
    _, port = handles
    x = np.ones((1, T, T), np.float32)
    frame = bytearray(ifunc_msg_create(port, x, slim=True).frame)
    if case == "clean":
        pass
    elif case.startswith("byte"):
        frame[int(case[4:])] ^= 0x40
    elif case == "stream_flag":
        frame = _resigned(frame, 60, F.FLAG_STREAM | F.FLAG_SLIM)
    elif case == "cont_flag":
        frame = _resigned(frame, 60, F.FLAG_CONT | F.FLAG_SLIM)
    elif case == "agg_slim":
        frame = _resigned(frame, 60, F.FLAG_AGG | F.FLAG_SLIM)
    elif case == "kind9":
        frame = _resigned(frame, 24, 9)
    else:
        frame = frame[:F.HEADER_LEN - 1]

    def outcome(peek, err):
        try:
            h = peek(frame)
        except err:
            return "rejected"
        return "none" if h is None else "accepted"

    want = outcome(RF.peek_header, RF.FrameError)
    assert outcome(F.peek_header, F.FrameError) == want
    assert (want == "accepted") == (case in ("clean", "stream_flag"))
