"""The plan that the ``ifunc_vm`` kernel runs (``vm_plan``): registers
renamed onto physical tiles, loads served in place, zeroing only where a
register is read before any write, the variant chosen from the plan, and
the in-place layout of payload tiles in a mailbox's slots.  The plan's
instructions run in plain PyTorch (``ifunc_vm_planned_plain``) and are held
against the plain version on the original program, bit for bit, and
against the JAX package's oracle ``repro.kernels.ref.ifunc_vm_ref``.
"""

import numpy as np
import pytest
import torch

from repro.core import codegen as RCG
from repro.kernels import ref as REF
from repro_torch.core.codegen import OPS, assemble
from repro_torch.core.device_mailbox import pack_agg_word_frame, pack_word_frame
from repro_torch.ifunc_libs.uvm_affine import UVM_PROGRAM
from repro_torch.kernels.ifunc_vm import (PAYLOAD, EXT0, ifunc_vm_plain,
                                          ifunc_vm_planned_plain,
                                          ifunc_vm_slots, slot_tiles, vm_plan)
from repro_torch.kernels.ring_poll import HDR_WORDS

T = 128


def random_program(rng, must, n_ops=12):
    """``loadp``, then the ops in ``must`` and random ones to ``n_ops`` in a
    shuffled order, each reading registers already written (``loade`` a
    random external), then a matmul with dst == a on the last register
    written, which is stored."""
    names = sorted(OPS)
    ops = list(must) + [names[int(i)] for i in
                        rng.integers(0, len(names), n_ops - len(must))]
    live, last = [0], 0
    instrs = [("loadp", 0)]
    for op in (ops[int(i)] for i in rng.permutation(len(ops))):
        a, b = (live[int(i)] for i in rng.integers(0, len(live), 2))
        d = int(rng.integers(0, 8))
        if op == "loade":
            a = int(rng.integers(0, 8))
        instrs.append((op, d, a, b, float(rng.uniform(-1.5, 1.5))))
        if op not in ("halt", "store"):
            live.append(d)
            last = d
    instrs += [("matmul", last, last, live[int(rng.integers(0, len(live)))]),
               ("store", 0, last)]
    return assemble(instrs, symbols=tuple(f"e{i}" for i in range(8)))


def _operands(seed, n_tiles=4, n_shards=2, n_ext=8):
    rng = np.random.default_rng(seed)
    pay = (rng.standard_normal((n_tiles, T, T)) * 0.5).astype(np.float32)
    ext = (rng.standard_normal((n_shards, n_ext, T, T)) * 0.1).astype(
        np.float32)
    return pay, ext


def test_uvm_affine_plan_serves_its_loads_in_shared_memory():
    """uvm_affine: r0 from the payload and r1 from external 0 in place, one
    tile (r2) written, nothing zeroed: the shared-memory variant."""
    plan = vm_plan(UVM_PROGRAM)
    assert plan.variant == "smem"
    assert plan.kernel == "ifunc_vm_smem_kernel"
    assert plan.n_tiles == 1
    assert plan.zeroed == ()
    assert plan.served == ((0, 0, "payload"), (1, 1, "ext 0"))
    names = {v: k for k, v in OPS.items()}
    assert [names[int(o)] for o in plan.code[0]] == ["matmul", "relu",
                                                     "store"]
    assert plan.code[:, 0].tolist()[1:4] == [0, PAYLOAD, EXT0]
    assert vm_plan(UVM_PROGRAM) is plan                  # cached


def test_register_read_before_any_write_is_zeroed():
    """fma r6 += r3 * r4 reads r6 before any write: its tile alone is
    zeroed; the five values live at once take the global-scratch
    variant; the result equals the plain version's."""
    prog = assemble([("loadp", 0), ("tanh", 1, 0), ("muli", 2, 0, 0, 0.5),
                     ("relu", 3, 0), ("gelu", 4, 0), ("fma", 6, 3, 4),
                     ("add", 5, 1, 2), ("mul", 7, 5, 6), ("store", 0, 7)])
    plan = vm_plan(prog)
    assert plan.variant == "global" and plan.n_tiles == 5
    assert len(plan.zeroed) == 1
    fma = plan.code[:, plan.code[0] == OPS["fma"]][:, 0]
    assert fma[4] == plan.zeroed[0]                      # its addend
    pay, ext = _operands(1)
    p, e = torch.from_numpy(pay), torch.from_numpy(ext)
    assert torch.equal(ifunc_vm_planned_plain(plan, p, e),
                       ifunc_vm_plain(prog, p, e))


def test_dead_code_and_early_stores_are_dropped():
    """Only the last store counts: an earlier store, halt and results
    nobody reads leave the plan; a program that never stores plans to
    nothing and yields zeros."""
    prog = assemble([("loadp", 0), ("exp", 1, 0), ("store", 0, 1),
                     ("halt",), ("tanh", 2, 0), ("relu", 3, 0),
                     ("store", 0, 3)])
    plan = vm_plan(prog)
    names = {v: k for k, v in OPS.items()}
    assert [names[int(o)] for o in plan.code[0]] == ["relu", "store"]
    empty = vm_plan(assemble([("loadp", 0), ("exp", 1, 0)]))
    assert empty.code.shape == (5, 0) and empty.n_tiles == 0
    pay, ext = _operands(2)
    out = ifunc_vm_planned_plain(empty, torch.from_numpy(pay),
                                 torch.from_numpy(ext))
    assert not out.any()


def _conditioned(prog, pay, ext, tol):
    """Whether float32 rounding alone keeps ``prog`` within a tenth of
    ``tol`` of its float64 result on these inputs (chip_smoke.py's test):
    only then can a float32 result be held to ``tol``."""
    f32 = ifunc_vm_plain(prog, pay, ext)
    f64 = ifunc_vm_plain(prog, pay.double(), ext.double())
    fin = torch.isfinite(f64) & torch.isfinite(f32)
    err = (f32.double() - f64).abs()[fin]
    return bool((err <= 0.1 * tol * (1 + f64.abs()[fin])).all())


@pytest.mark.parametrize("seed", range(1000, 1024))
def test_random_program_plan_matches_plain_and_oracle(seed):
    """Seeded random programs (every opcode among them): the plan's
    renaming run in plain PyTorch equals the plain version on the original
    program bit for bit, and the oracle where it is finite within 2e-5
    where float32 rounding alone allows it (see _conditioned), else within
    test_torch_kernels.py's 5e-4 for random programs."""
    names = list(np.random.default_rng(1).permutation(sorted(OPS)))
    i = seed % 8
    prog = random_program(np.random.default_rng(seed),
                          names[i * len(names) // 8:(i + 1) * len(names) // 8])
    pay, ext = _operands(seed)
    p, e = torch.from_numpy(pay), torch.from_numpy(ext[:1])
    plan = vm_plan(prog)
    assert plan.n_tiles <= 8
    got = ifunc_vm_planned_plain(plan, p, e)
    want = ifunc_vm_plain(prog, p, e)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    rprog = RCG.UvmProgram(prog.opcode, prog.dst, prog.a, prog.b, prog.imm,
                           prog.n_ext, prog.symbols)
    ref = torch.from_numpy(REF.ifunc_vm_ref(rprog, pay, ext[0]))
    fin = torch.isfinite(ref) & torch.isfinite(got)
    tol = 2e-5 if _conditioned(prog, p, e, 2e-5) else 5e-4
    torch.testing.assert_close(got[fin], ref[fin], rtol=tol, atol=tol)


def test_random_programs_reach_both_variants():
    names = list(np.random.default_rng(1).permutation(sorted(OPS)))
    variants = {vm_plan(random_program(
        np.random.default_rng(seed),
        names[(seed % 8) * 20 // 8:(seed % 8 + 1) * 20 // 8])).variant
        for seed in range(1000, 1060)}
    assert variants == {"smem", "global"}


def _singleton_ring(rng, n_slots, n_tiles):
    W = HDR_WORDS + n_tiles * T * T + 1
    return np.stack([pack_word_frame(
        rng.standard_normal(n_tiles * T * T).astype(np.float32), W)
        for _ in range(n_slots)]).view(np.int32), HDR_WORDS


def _agg_ring(rng, n_slots, k):
    body = T * T
    W = HDR_WORDS + 2 * k + k * body + 1
    return np.stack([pack_agg_word_frame(
        list(rng.standard_normal((k, body)).astype(np.float32)),
        [0xABC] * k, k, body, W) for _ in range(n_slots)]).view(np.int32), \
        HDR_WORDS + 2 * k


@pytest.mark.parametrize("kind", ["singleton", "aggregate"])
def test_in_place_layout_gathers_the_copied_tiles(kind):
    """slot_tiles over [n_shards * n_slots, W] gives exactly the tiles the
    sweeps copied out before (``mailbox[:, :, off:off + body]
    .contiguous()``), for a singleton ring of two tiles a frame and an
    aggregate ring with K = 4; the CPU path of ifunc_vm_slots runs the
    plain version on them."""
    rng = np.random.default_rng(5)
    S, N = 4, 2
    if kind == "singleton":
        words, off = _singleton_ring(rng, S * N, 2)
        per = 2
    else:
        words, off = _agg_ring(rng, S * N, 4)
        per = 4
    mailbox = torch.from_numpy(words).reshape(S, N, -1)
    old = mailbox[:, :, off:off + per * T * T].contiguous() \
        .view(torch.float32).reshape(S * N * per, T, T)
    flat = mailbox.reshape(S * N, -1)
    got = slot_tiles(flat, off, per)
    assert torch.equal(got, old)
    ext = torch.from_numpy(_operands(6, n_shards=S, n_ext=1)[1])
    assert torch.equal(ifunc_vm_slots(UVM_PROGRAM, flat, off, per, ext),
                       ifunc_vm_plain(UVM_PROGRAM, old, ext))
    with pytest.raises(ValueError):
        ifunc_vm_slots(UVM_PROGRAM, flat, flat.shape[1] - T * T, per, ext)
