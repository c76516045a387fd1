"""The port's kernels against the JAX package's: ``ring_poll`` bit for bit
against the Pallas kernel (interpret mode) and its oracle, ``ifunc_vm``
against the oracle ``ifunc_vm_ref`` (the Pallas μVM kernel does not run
under this jax, so ``tests/test_kernels.py`` holds it to the same oracle).

On the CPU the wrappers run their plain PyTorch versions;
``tests/test_torch_cuda.py`` holds each CUDA kernel against its plain
version on a card."""

import numpy as np
import pytest
import torch

from repro.core import codegen as RCG
from repro.kernels import ref as REF
from repro.kernels.ring_poll import ring_poll as ref_ring_poll
from repro_torch.core.codegen import OPS, UVM_REGS, assemble
from repro_torch.kernels import _build
from repro_torch.kernels import ops as K
from repro_torch.kernels.ifunc_vm import ifunc_vm, ifunc_vm_plain
from repro_torch.kernels.ring_poll import (HDR_WORDS, MAGIC, TRAILER,
                                           ring_poll, ring_poll_plain)

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
    "loade_past_the_table": (                  # reads ext[min(5, n_ext-1)]
        [("loadp", 0), ("loade", 1, 5), ("mul", 2, 0, 1), ("store", 0, 2)],
        ("W",)),
}


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _ring(seed: int, n: int = 24, W: int = 32) -> np.ndarray:
    """A uint32 ring mixing EMPTY (zeros and garbage behind magic 0), READY,
    INFLIGHT and each kind of BAD, including fw = 0xFFFFFFF0 (negative as
    int32) with a matching check word."""
    rng = np.random.default_rng(seed)
    ring = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32)
    for i in range(n):
        kind = int(rng.integers(0, 8))
        fw = int(rng.integers(0, W - HDR_WORDS))
        hdr = [MAGIC, fw, 3, int(rng.integers(0, 2 ** 32))]
        if kind == 0:
            ring[i] = 0
            continue
        if kind == 1:
            ring[i, 0] = 0
            continue
        if kind == 6:
            hdr[1] = 0xFFFFFFF0
        elif kind == 7:
            hdr[1] = W - HDR_WORDS
        chk = hdr[0] ^ hdr[1] ^ hdr[2] ^ hdr[3]
        if kind == 4:
            hdr[0] ^= 0x100
        elif kind == 5:
            chk ^= 1
        ring[i, :HDR_WORDS] = hdr + [chk]
        if kind == 2:
            ring[i, HDR_WORDS + fw] = TRAILER
        elif kind == 3:
            ring[i, HDR_WORDS + fw] = TRAILER ^ 1
    return ring


@pytest.mark.parametrize("seed", range(6))
def test_ring_poll_plain_bit_exact_vs_reference(seed):
    ring = _ring(seed)
    want = REF.ring_poll_ref(ring)
    np.testing.assert_array_equal(np.asarray(ref_ring_poll(ring)), want)
    got = ring_poll_plain(_i32(ring))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ring_poll(_i32(ring)).numpy(), want)
    np.testing.assert_array_equal(K.mailbox_poll(ring, device="cpu").numpy(),
                                  want)


def test_ring_poll_unsigned_traps():
    """fw = 0xFFFFFFF0 passes a signed `fw <= W - 6` and must still be BAD;
    the trailer is negative as int32; magic 0 is EMPTY whatever follows."""
    W = 16
    ring = np.zeros((3, W), np.uint32)
    hdr = [MAGIC, 0xFFFFFFF0, 3, 0x55]
    ring[0, :5] = hdr + [hdr[0] ^ hdr[1] ^ hdr[2] ^ hdr[3]]
    hdr = [MAGIC, 4, 3, 0x55]
    ring[1, :5] = hdr + [hdr[0] ^ hdr[1] ^ hdr[2] ^ hdr[3]]
    ring[1, 5 + 4] = TRAILER
    ring[2, 1:] = 0xFFFFFFFF
    got = ring_poll_plain(_i32(ring)).numpy()
    np.testing.assert_array_equal(got, [3, 1, 0])
    np.testing.assert_array_equal(got, REF.ring_poll_ref(ring))
    assert int(_i32(ring)[1, 9]) < 0


def test_ring_poll_rejects_bad_input():
    with pytest.raises(TypeError):
        ring_poll(torch.zeros(2, 8, dtype=torch.int64))
    with pytest.raises(ValueError):
        ring_poll(torch.zeros(2, 5, dtype=torch.int32))
    with pytest.raises(ValueError):          # no fallback off the CPU
        ring_poll(torch.zeros(2, 8, dtype=torch.int32, device="meta"))


def _run_both(prog_p, prog_r, pay, ext):
    out = ifunc_vm_plain(prog_p, torch.from_numpy(pay), torch.from_numpy(ext))
    ref = REF.ifunc_vm_ref(prog_r, pay, ext)
    return out.numpy(), ref


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("n_tiles", [1, 3])
def test_ifunc_vm_plain_programs(name, n_tiles):
    instrs, symbols = PROGRAMS[name]
    rng = np.random.default_rng(n_tiles)
    pay = rng.standard_normal((n_tiles, T, T)).astype(np.float32)
    ext = (rng.standard_normal((len(symbols), T, T)) * 0.1).astype(np.float32)
    out, ref = _run_both(assemble(instrs, symbols),
                         RCG.assemble(instrs, symbols), pay, ext)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    got = K.uvm_execute(assemble(instrs, symbols), pay, list(ext),
                        device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def _random_instrs(seed: int):
    rng = np.random.default_rng(seed)
    names = [o for o in sorted(OPS) if o != "halt"]
    instrs = [("loadp", 0)]
    for _ in range(int(rng.integers(1, 13))):
        d, a, b = (int(x) for x in rng.integers(0, UVM_REGS, 3))
        instrs.append((names[int(rng.integers(len(names)))], d, a, b,
                       float(rng.uniform(-1.5, 1.5))))
    return instrs + [("store", 0, 1)]


@pytest.mark.parametrize("seed", range(12))
def test_ifunc_vm_plain_random_programs(seed):
    instrs = _random_instrs(seed)
    symbols = tuple(f"e{i}" for i in range(8))
    rng = np.random.default_rng(100 + seed)
    pay = (rng.standard_normal((2, T, T)) * 0.5).astype(np.float32)
    ext = (rng.standard_normal((8, T, T)) * 0.1).astype(np.float32)
    out, ref = _run_both(assemble(instrs, symbols),
                         RCG.assemble(instrs, symbols), pay, ext)
    assert np.isfinite(ref).all() == np.isfinite(out).all()
    mask = np.isfinite(ref)
    np.testing.assert_allclose(out[mask], ref[mask], rtol=5e-4, atol=5e-4)


def test_ifunc_vm_plain_halt_is_a_noop_and_last_store_wins():
    instrs = [("loadp", 0), ("store", 0, 0), ("halt",), ("relu", 1, 0),
              ("matmul", 1, 1, 1), ("store", 0, 1)]
    rng = np.random.default_rng(9)
    pay = rng.standard_normal((2, T, T)).astype(np.float32)
    empty = np.zeros((0, T, T), np.float32)
    out, ref = _run_both(assemble(instrs), RCG.assemble(instrs), pay, empty)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    relu = np.maximum(pay, 0)
    np.testing.assert_allclose(out, relu @ relu, rtol=2e-5, atol=2e-4)


def test_ifunc_vm_plain_no_store_gives_zeros_and_empty_table_reads_zero():
    instrs = [("loadp", 0), ("loade", 1, 3), ("add", 2, 0, 1)]
    pay = np.ones((2, T, T), np.float32)
    out, ref = _run_both(assemble(instrs), RCG.assemble(instrs), pay,
                         np.zeros((0, T, T), np.float32))
    assert not out.any() and not ref.any()
    stored = assemble(instrs + [("store", 0, 1)])
    got = ifunc_vm_plain(stored, torch.from_numpy(pay),
                         torch.zeros(0, T, T)).numpy()
    assert not got.any()                      # loade of an empty table: 0


def test_ifunc_vm_plain_per_shard_tables():
    """Tile t reads the table of shard t // tiles_per_shard."""
    instrs, symbols = PROGRAMS["affine_relu"]
    rng = np.random.default_rng(4)
    S, per = 4, 3
    pay = rng.standard_normal((S * per, T, T)).astype(np.float32)
    ext = (rng.standard_normal((S, 2, T, T)) * 0.1).astype(np.float32)
    out = ifunc_vm_plain(assemble(instrs, symbols), torch.from_numpy(pay),
                         torch.from_numpy(ext)).numpy()
    for s in range(S):
        ref = REF.ifunc_vm_ref(RCG.assemble(instrs, symbols),
                               pay[s * per:(s + 1) * per], ext[s])
        np.testing.assert_allclose(out[s * per:(s + 1) * per], ref,
                                   rtol=2e-5, atol=2e-5)


def test_ifunc_vm_rejects_bad_programs_and_operands():
    pay = torch.zeros(2, T, T)
    with pytest.raises(ValueError):
        ifunc_vm(assemble([("loadp", 8)]), pay, torch.zeros(0, T, T))
    bad = assemble([("loadp", 0)])
    bad.opcode[0] = 20
    with pytest.raises(ValueError):
        ifunc_vm(bad, pay, torch.zeros(0, T, T))
    with pytest.raises(ValueError):              # 2 tiles over 3 tables
        ifunc_vm(assemble([("loadp", 0)]), pay, torch.zeros(3, 1, T, T))
    with pytest.raises(TypeError):
        ifunc_vm(assemble([("loadp", 0)]), pay.double(), torch.zeros(1, T, T))
    with pytest.raises(ValueError):              # no fallback off the CPU
        ifunc_vm(assemble([("loadp", 0)]), pay.to("meta"),
                 torch.zeros(1, T, T, device="meta"))


def _fake_nvcc(tmp_path, fail_stem=""):
    """A stand-in for nvcc: writes the library it is asked for and a ptxas
    line, or fails with a message for the source named ``fail_stem``."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"""#!/bin/sh
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
case "$prev" in *"/{fail_stem or '//'}.cu") echo "error: boom in $prev"; exit 2;; esac
echo "ptxas info    : Used 8 registers"; : > "$out"
""")
    nvcc.chmod(0o755)
    return str(nvcc)


def test_build_compiles_every_source_once(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    out, _ = _build.build_all()
    stems = sorted(s.stem for s in _build.sources())
    assert stems == ["agg_poll", "flash_attn", "flash_attn_bwd", "ifunc_vm",
                     "ring_poll", "ssd_scan"]
    for stem in stems:
        assert (out / f"lib{stem}.so").exists()
        assert "registers" in (out / f"{stem}.log").read_text()
    assert _build.build_all() == (out, 0.0)        # nothing left to build


def test_build_dir_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a csrc/*.cuh header, which no source's own bytes show,
    moves the build to a new directory, so the kernels rebuild."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build.build_dir()
    assert _build.build_dir() == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.build_dir() != first


def test_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc",
                        lambda: _fake_nvcc(tmp_path, "ifunc_vm"))
    with pytest.raises(_build.BuildError, match="boom in .*ifunc_vm.cu"):
        _build.build_all()
    out = _build.build_dir()
    assert (out / "libring_poll.so").exists()
    assert not (out / "libifunc_vm.so").exists()


def test_build_without_nvcc_raises_before_writing(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build_all()
    assert not (tmp_path / "build").exists()
