"""Code serialization and linking (the GOT analogue), the μVM assembler
round-trip and the HLO kind as a ``torch.export`` program:
``tests/test_codegen.py`` ported to ``repro_torch``, plus the sections
held against the reference's."""

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - optional dep (see requirements.txt)
    from _hypothesis_stub import given, settings, st

from repro_torch.core import codegen as CG


# --- PYBC ------------------------------------------------------------------

def _helper(x):
    return x * 2


_CONST = 7


def _main_with_deps(payload, payload_size, target_args):
    target_args["out"] = _helper(payload_size) + _CONST + external_fn(1)  # noqa: F821


def test_pybc_bundles_locals_and_links_symbols():
    code = CG.serialize_pybc(_main_with_deps)
    space = CG.SymbolSpace({"external_fn": lambda v: v + 10})
    fn = CG.link_pybc(code, space)
    t = {}
    fn(b"1234", 4, t)
    assert t["out"] == 8 + 7 + 11


def test_pybc_unresolved_symbol():
    code = CG.serialize_pybc(_main_with_deps)
    with pytest.raises(CG.LinkError):
        CG.link_pybc(code, CG.SymbolSpace({}))


def test_pybc_magic_mismatch():
    code = bytearray(CG.serialize_pybc(_helper))
    # corrupt the interpreter magic inside the json meta
    idx = code.find(b'"magic"')
    code[idx + 12] ^= 0x01
    with pytest.raises(CG.CodeVerifyError):
        CG.link_pybc(bytes(code), CG.SymbolSpace())


def test_pybc_hmac():
    code = CG.serialize_pybc(_helper, hmac_key=b"secret")
    CG.link_pybc(code, CG.SymbolSpace(), hmac_key=b"secret")
    with pytest.raises(CG.CodeVerifyError):
        CG.link_pybc(code, CG.SymbolSpace(), hmac_key=b"other")
    unsigned = CG.serialize_pybc(_helper)
    with pytest.raises(CG.CodeVerifyError):
        CG.link_pybc(unsigned, CG.SymbolSpace(), hmac_key=b"secret")


def test_pybc_closure_rejected():
    y = 3

    def closure_fn(a):
        return a + y

    with pytest.raises(ValueError):
        CG.serialize_pybc(closure_fn)


@pytest.mark.parametrize("key", [None, b"secret"])
def test_pybc_section_equals_reference(key):
    """The same function object gives the same section under both packages
    (meta JSON, bundle and HMAC), and each links the other's."""
    from repro.core import codegen as RCG

    for fn in (_main_with_deps, _helper):
        ours = CG.serialize_pybc(fn, hmac_key=key)
        assert ours == RCG.serialize_pybc(fn, hmac_key=key)
    t = {}
    RCG.link_pybc(ours, RCG.SymbolSpace(), hmac_key=key)
    CG.link_pybc(RCG.serialize_pybc(_main_with_deps, hmac_key=key),
                 CG.SymbolSpace({"external_fn": lambda v: v}),
                 hmac_key=key)(b"", 0, t)
    assert t["out"] == 8


# --- UVM -------------------------------------------------------------------

ops_strategy = st.sampled_from(sorted(CG.OPS))


@given(st.lists(st.tuples(ops_strategy,
                          st.integers(0, CG.UVM_REGS - 1),
                          st.integers(0, CG.UVM_REGS - 1),
                          st.integers(0, CG.UVM_REGS - 1),
                          st.floats(-2, 2, allow_nan=False)),
                min_size=1, max_size=24),
       st.lists(st.sampled_from(["W", "b", "t0", "t1"]), max_size=3,
                unique=True))
@settings(max_examples=40, deadline=None)
def test_uvm_serialize_roundtrip(instrs, symbols):
    prog = CG.assemble(list(instrs), symbols=tuple(symbols))
    blob = CG.serialize_uvm(prog)
    back = CG.deserialize_uvm(blob)
    np.testing.assert_array_equal(prog.opcode, back.opcode)
    np.testing.assert_array_equal(prog.dst, back.dst)
    np.testing.assert_array_equal(prog.a, back.a)
    np.testing.assert_array_equal(prog.b, back.b)
    np.testing.assert_allclose(prog.imm, back.imm)
    assert prog.symbols == back.symbols and prog.n_ext == back.n_ext


def test_uvm_bad_magic():
    with pytest.raises(CG.CodeVerifyError):
        CG.deserialize_uvm(b"\0" * 64)


# --- HLO (torch.export) ----------------------------------------------------

def _hlo_fn(x):
    return (x.to(torch.float32) * 2 + 1).sum()


@pytest.fixture(scope="module")
def hlo_code():
    """One export for the module: each takes seconds on the CPU."""
    return CG.serialize_hlo(_hlo_fn, (torch.zeros(16, dtype=torch.uint8),))


def test_hlo_export_roundtrip(hlo_code):
    call = CG.link_hlo(hlo_code)
    out = call(torch.arange(16, dtype=torch.uint8))
    assert float(out) == float(np.arange(16).sum() * 2 + 16)
    with pytest.raises(CG.LinkError):
        CG.link_hlo(b"not an exported program")


def test_hlo_program_moved_to_the_target_device(hlo_code):
    """A program traced on CPU tensors asserts their device; linked for
    another device, its graph names that device instead and runs there
    (``meta`` stands in for the card)."""
    assert "type='cpu'" in CG.link_hlo(hlo_code).code
    call = CG.link_hlo(hlo_code, torch.device("meta"))
    assert "cpu" not in call.code and "meta" in call.code
    out = call(torch.zeros(16, dtype=torch.uint8, device="meta"))
    assert out.device.type == "meta" and out.dtype == torch.float32


def _hlo_frame_target(code):
    """A port target with one HLO frame of ``code`` (16 payload bytes) in
    its region."""
    from repro_torch.core import CodeKind, Context
    from repro_torch.core import frame as F

    dst = Context("dst", device="cpu")
    region = dst.nic.mem_map(1 << 16)
    frame = F.pack_frame("hlo_sum", code, bytes(range(16)), CodeKind.HLO)
    region.buf[:len(frame)] = frame
    return dst, region


def test_hlo_frame_polled_on_port_target(hlo_code):
    from repro_torch.core import Status, poll_ifunc

    dst, region = _hlo_frame_target(hlo_code)
    targs = {}
    assert poll_ifunc(dst, region.view(), None, targs) == Status.OK
    assert float(targs["result"]) == float(np.arange(16).sum() * 2 + 16)
    assert dst.stats["links"] == 1 and not any(region.buf)


def test_jax_export_frame_rejected_on_port_target():
    """A reference HLO section (a ``jax.export`` artifact) is not a
    torch.export program: the port target REJECTs the frame and scrubs it."""
    import jax
    import jax.numpy as jnp

    from repro.core import codegen as RCG
    from repro_torch.core import Status, poll_ifunc

    code = RCG.serialize_hlo(
        lambda x: (x.astype(jnp.float32) * 2 + 1).sum(),
        (jax.ShapeDtypeStruct((16,), jnp.uint8),))
    dst, region = _hlo_frame_target(code)
    assert poll_ifunc(dst, region.view(), None, {}) == Status.REJECTED
    assert dst.stats["last_reject"].startswith("LinkError")
    assert dst.stats["rejected"] == 1 and dst.stats["links"] == 0
    assert not any(region.buf)
