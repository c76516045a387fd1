"""The port's CUDA kernels and its device lane on a card, each held against
its plain PyTorch version on the same inputs.  Every test here is marked
``cuda`` and skips without a card.  The file imports nothing of the JAX
package, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Context, ifunc_msg_create, register_ifunc
from repro_torch.core.codegen import assemble, deserialize_uvm
from repro_torch.core.device_mailbox import (make_agg_sweep, make_sweep,
                                             pack_agg_word_frame,
                                             pack_word_frame)
from repro_torch.kernels.agg_poll import (AGG_MAGIC, agg_ring_poll,
                                          agg_ring_poll_plain)
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels.flash_attn import (flash_attention, flash_bwd,
                                            flash_bwd_dkv, flash_bwd_dq,
                                            flash_bwd_plain, flash_fwd,
                                            flash_fwd_plain)
from repro_torch.kernels.ifunc_vm import (ifunc_vm, ifunc_vm_agg_sweep,
                                          ifunc_vm_plain, ifunc_vm_slots,
                                          ifunc_vm_sweep,
                                          ifunc_vm_sweep_plain, slot_tiles,
                                          sweep_kernel, vm_plan)
from repro_torch.kernels.ring_poll import (HDR_WORDS, MAGIC, TRAILER,
                                           ring_poll, ring_poll_plain)
from repro_torch.kernels.ssd_scan import (SsdScanGradError, ssd_scan,
                                          ssd_scan_plain)
from repro_torch.models import transformer as MT
from repro_torch.models.config import ModelConfig
from repro_torch.train.optim import OptConfig
from repro_torch.train.serve import pad_cache_to
from repro_torch.train.step import make_train_step
from repro_torch.transport import DeviceMeshFabric, Dispatcher, ProgressEngine

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
    "halt_rsqrt_max_matmul_in_place": (
        [("loadp", 0), ("halt",), ("rsqrt", 1, 0), ("max", 2, 0, 1),
         ("exp", 3, 0), ("muli", 3, 3, 0, 0.5), ("zero", 4),
         ("mul", 5, 2, 3), ("matmul", 5, 5, 0), ("store", 0, 5)], ()),
    # five tiles live at once, r6 read before any write
    "wide_fma_zeroed": (
        [("loadp", 0), ("tanh", 1, 0), ("muli", 2, 0, 0, 0.5), ("relu", 3, 0),
         ("gelu", 4, 0), ("fma", 6, 3, 4), ("add", 5, 1, 2),
         ("mul", 7, 5, 6), ("loade", 1, 0), ("matmul", 7, 7, 1),
         ("store", 0, 7)], ("W",)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ring(n: int, W: int) -> np.ndarray:
    """A uint32 ring cycling through EMPTY (zeros, and garbage behind magic
    0), READY, INFLIGHT and each kind of BAD: bad magic, bad check word,
    fw = 0xFFFFFFF0 (negative as int32) and fw one word too long."""
    rng = np.random.default_rng(0)
    ring = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32)
    for i in range(n):
        kind = i % 8
        fw = int(rng.integers(0, W - HDR_WORDS))
        hdr = [MAGIC, fw, 3, int(rng.integers(0, 2 ** 32))]
        if kind < 2:                     # all zero, or garbage behind magic 0
            ring[i, :W if kind == 0 else 1] = 0
            continue
        hdr[1] = {6: 0xFFFFFFF0, 7: W - HDR_WORDS}.get(kind, fw)
        chk = hdr[0] ^ hdr[1] ^ hdr[2] ^ hdr[3]
        if kind == 4:
            hdr[0] ^= 0x100
        if kind == 5:
            chk ^= 1
        ring[i, :HDR_WORDS] = hdr + [chk]
        ring[i, HDR_WORDS + fw] = TRAILER if kind == 2 else 0
    return ring


def mixed_agg_ring(k, body_words, bound, seed=3):
    """A uint32 ring of 12 aggregate slots mixing every container and sub
    state: empty, a full READY container, a hash-mismatched sub, a
    poisoned sub, a corrupt container, a withheld trailer, and the
    unsigned traps: n_subs = 0xFFFFFFFF and K + 1, hashes with the high
    bit set, garbage behind magic 0, a bad magic, and a READY container
    whose unoccupied descriptors hold garbage.  Its statuses are
    [EMPTY, READY, READY, READY, BAD, INFLIGHT, BAD, BAD, READY, EMPTY,
    BAD, READY]."""
    slot_words = HDR_WORDS + 2 * k + k * body_words + 1
    rng = np.random.default_rng(seed)
    pay = [rng.standard_normal(body_words).astype(np.float32)
           for _ in range(k)]
    other = 0x8000ABCD if bound != 0x8000ABCD else 0x9000ABCD
    b = bound or 0xC0FFEE01             # the hash a "matching" sub carries

    def pack(n, hashes=None, **kw):
        return pack_agg_word_frame(pay[:n], hashes or [b] * n, k, body_words,
                                   slot_words, **kw)

    slots = np.zeros((12, slot_words), np.uint32)
    slots[1] = pack(k)
    slots[2] = pack(2, [b, 0x1234])
    slots[3] = pack(3, corrupt_sub=1)
    slots[4] = pack(1, corrupt=True)
    slots[5] = pack(2, no_trailer=True)
    for i, n in ((6, 0xFFFFFFFF), (7, k + 1)):
        slots[i] = pack(1)
        slots[i, 1] = n
        slots[i, 4] = AGG_MAGIC ^ n ^ 3
    slots[8] = pack(3, [other, b, 0xFFFFFFFF])
    slots[9] = rng.integers(0, 2 ** 32, slot_words, dtype=np.uint32)
    slots[9, 0] = 0
    slots[10] = pack(1)
    slots[10, 0] ^= 0x100
    slots[11] = pack(1)
    slots[11, HDR_WORDS + 2:HDR_WORDS + 2 * k] = rng.integers(
        0, 2 ** 32, 2 * k - 2, dtype=np.uint32)
    return slots


def mixed_sweep_ring(n, n_tiles, seed=5):
    """A uint32 singleton ring of ``n`` slots of ``n_tiles`` body tiles
    whose bodies are finite floats, cycling through EMPTY (zeros, and
    garbage behind magic 0), READY, READY with a short frame (its trailer
    inside the first body tile), INFLIGHT and each kind of BAD (check
    word, fw = 0xFFFFFFF0, bad magic).  Its statuses cycle through
    [0, 0, 1, 1, 2, 3, 3, 3]."""
    body = n_tiles * T * T
    W = HDR_WORDS + body + 1
    rng = np.random.default_rng(seed)
    ring = np.zeros((n, W), np.uint32)
    for i in range(n):
        kind = i % 8
        pay = rng.standard_normal(body).astype(np.float32)
        if kind == 1:
            ring[i] = rng.integers(0, 2 ** 32, W, dtype=np.uint32)
            ring[i, 0] = 0
        elif kind == 3:
            ring[i] = pack_word_frame(pay[:T * T // 2 + 3], W)
        elif kind >= 2:
            ring[i] = pack_word_frame(pay, W, corrupt=kind == 5,
                                      no_trailer=kind == 4)
        if kind == 6:
            ring[i, 1] = 0xFFFFFFF0
            ring[i, 4] = ring[i, 0] ^ ring[i, 1] ^ ring[i, 2] ^ ring[i, 3]
        if kind == 7:
            ring[i, 0] ^= 0x100
    return ring


@pytest.mark.cuda
def test_ring_poll_kernel_matches_plain(cuda):
    ring = torch.from_numpy(_ring(512, 4 * T + 6).view(np.int32)).to(cuda)
    before = ring_poll.launches
    got = ring_poll(ring)
    torch.cuda.synchronize()
    assert ring_poll.launches == before + 1
    want = ring_poll_plain(ring)
    assert torch.equal(got, want)
    assert torch.bincount(want.cpu(), minlength=4).tolist() == [128, 64, 64,
                                                                256]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_ifunc_vm_kernel_matches_plain(cuda, name):
    instrs, symbols = PROGRAMS[name]
    rng = np.random.default_rng(0)
    pay = torch.from_numpy(rng.standard_normal((16, T, T)).astype(
        np.float32)).to(cuda)
    ext = torch.from_numpy((rng.standard_normal(
        (4, max(len(symbols), 1), T, T)) * 0.1).astype(np.float32)).to(cuda)
    prog = assemble(instrs, symbols)
    before = ifunc_vm.launches
    out = ifunc_vm(prog, pay, ext)
    torch.cuda.synchronize()
    assert ifunc_vm.launches == before + 1
    torch.testing.assert_close(out, ifunc_vm_plain(prog, pay, ext),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,name", [("smem", "affine_relu"),
                                          ("global", "wide_fma_zeroed")])
def test_ifunc_vm_variant_matches_plain(cuda, variant, name):
    """Each variant of the kernel, as its plan picks it, against the plain
    version at the lanes' 8 shard tables; one launch each."""
    instrs, symbols = PROGRAMS[name]
    prog = assemble(instrs, symbols)
    assert vm_plan(prog).variant == variant
    rng = np.random.default_rng(4)
    pay = torch.from_numpy(rng.standard_normal((64, T, T)).astype(
        np.float32)).to(cuda)
    ext = torch.from_numpy((rng.standard_normal(
        (8, max(len(symbols), 1), T, T)) * 0.1).astype(np.float32)).to(cuda)
    before = ifunc_vm.launches
    out = ifunc_vm(prog, pay, ext)
    torch.cuda.synchronize()
    assert ifunc_vm.launches == before + 1
    torch.testing.assert_close(out, ifunc_vm_plain(prog, pay, ext),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("offset,per_slot", [(HDR_WORDS, 2),
                                             (HDR_WORDS + 2 * 4, 4)])
def test_ifunc_vm_reads_ring_slots_in_place(cuda, offset, per_slot):
    """Tiles at word 5 (a singleton ring) and 5 + 2K (an aggregate one,
    K = 4) of every slot, not 16-byte aligned, read where they lie: equal
    to the plain version on the copied tiles, for both variants."""
    rng = np.random.default_rng(offset)
    W = offset + per_slot * T * T + 3
    ring = torch.from_numpy(rng.standard_normal((16, W)).astype(
        np.float32).view(np.int32)).to(cuda)
    ext = torch.from_numpy((rng.standard_normal((8, 1, T, T)) * 0.1)
                           .astype(np.float32)).to(cuda)
    tiles = slot_tiles(ring, offset, per_slot)
    assert tiles.shape == (16 * per_slot, T, T)
    for name in ("affine_relu", "wide_fma_zeroed"):
        instrs, symbols = PROGRAMS[name]
        prog = assemble(instrs, symbols)
        before = ifunc_vm.launches
        out = ifunc_vm_slots(prog, ring, offset, per_slot, ext)
        torch.cuda.synchronize()
        assert ifunc_vm.launches == before + 1
        torch.testing.assert_close(out, ifunc_vm_plain(prog, tiles, ext),
                                   rtol=2e-5, atol=2e-5, msg=name)


@pytest.mark.cuda
def test_device_lane_on_the_card_matches_the_cpu(cuda):
    """Dispatcher -> DeviceMeshFabric(8 shards, shift 1) on the card and on
    the CPU, the same frames: equal statuses, results within 1e-5; on the
    card the sweeps run the fused kernel alone."""
    handle = register_ifunc(Context("src"), "uvm_affine")
    rng = np.random.default_rng(1)
    W = (rng.standard_normal((8, 1, T, T)) * 0.05).astype(np.float32)
    pays = rng.standard_normal((16, 2, T, T)).astype(np.float32)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        d = Dispatcher(handle.ctx, ProgressEngine(inflight_window="trailer"))
        d.add_peer("mesh", DeviceMeshFabric(8, shift=1, device=dev), None,
                   n_slots=2, slot_size=(2 * T * T + 6) * 4,
                   prog=deserialize_uvm(handle.lib.code), n_tiles=2,
                   externals=W)
        before = (ring_poll.launches, ifunc_vm.launches,
                  ifunc_vm_sweep.launches)
        for p in pays:
            assert d.send("mesh", ifunc_msg_create(handle, p))
        assert d.drain() == len(pays)
        if dev.type == "cuda":                 # one fused launch a sweep
            assert (ring_poll.launches, ifunc_vm.launches) == before[:2]
            assert ifunc_vm_sweep.launches > before[2]
        runs[dev.type] = (d.per_peer_stats()["mesh"],
                          d.peers["mesh"].target_args["results"])
    assert runs["cuda"][0] == runs["cpu"][0]
    for g, w in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 64])
@pytest.mark.parametrize("bound", [0x8000ABCD, 0])
def test_agg_ring_poll_kernel_matches_plain(cuda, k, bound):
    """Bit-exact on the mixed ring, read through strided views of the
    mailbox as the sweep passes them."""
    mb = torch.from_numpy(mixed_agg_ring(k, 8, bound).view(np.int32)).to(cuda)
    hdr, tr = mb[:, :HDR_WORDS + 2 * k], mb[:, -1:]
    before = agg_ring_poll.launches
    st, sub = agg_ring_poll(hdr, tr, bound)
    torch.cuda.synchronize()
    assert agg_ring_poll.launches == before + 1
    want_st, want_sub = agg_ring_poll_plain(hdr, tr, bound)
    assert torch.equal(st, want_st) and torch.equal(sub, want_sub)
    assert st.tolist() == [0, 1, 1, 1, 3, 2, 3, 3, 1, 0, 3, 1]


@pytest.mark.cuda
def test_agg_lane_on_the_card_matches_the_cpu(cuda):
    """Coalesced sends through an agg-bound DeviceMeshFabric(8 shards,
    shift 1) on the card and on the CPU, one sub-record NACKed and one
    poisoned: equal stats and replies, results within 1e-5; on the card
    the sweeps run the fused kernel alone."""
    from repro_torch.kernels.agg_poll import SUB_SALT

    handle = register_ifunc(Context("src"), "uvm_affine")
    rng = np.random.default_rng(2)
    W = (rng.standard_normal((8, 1, T, T)) * 0.05).astype(np.float32)
    pays = list(rng.standard_normal((24, 1, T, T)).astype(np.float32))
    k = 4
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        d = Dispatcher(handle.ctx, ProgressEngine(inflight_window="trailer"))
        d.set_coalescing(True, max_subs=k, max_sub_bytes=128 << 10)
        d.add_peer("mesh", DeviceMeshFabric(8, shift=1, device=dev), None,
                   n_slots=1, slot_size=8 << 20,
                   prog=deserialize_uvm(handle.lib.code), externals=W,
                   agg_k=k, prog_name=handle.lib.name)
        replies = []
        d.reply_router = lambda c, n, v, e, dec: replies.append((c, v, e))
        mb = d.peers["mesh"].rings[0].mailbox
        before = (ring_poll.launches, agg_ring_poll.launches,
                  ifunc_vm.launches, ifunc_vm_agg_sweep.launches)
        assert d.send_ifunc_many("mesh", handle, pays,
                                 corr_ids=list(range(1, 25))) == 24
        mb._staged[2, 0, HDR_WORDS + 2] = 0x1234             # a NACK
        mb._staged[2, 0, HDR_WORDS + 3] = 0x1234 ^ SUB_SALT
        mb._staged[3, 0, HDR_WORDS + 1] ^= 1                 # a poisoned sub
        assert d.drain() == 24              # 22 + 1 poisoned + 1 rebuilt
        after = (ring_poll.launches, agg_ring_poll.launches,
                 ifunc_vm.launches, ifunc_vm_agg_sweep.launches)
        if dev.type == "cuda":                 # one fused launch a sweep
            assert after[:3] == before[:3] and after[3] > before[3]
        runs[dev.type] = (d.per_peer_stats()["mesh"],
                          d.peers["mesh"].target_args["results"],
                          sorted(replies, key=lambda r: r[0]))
    assert runs["cuda"][0] == runs["cpu"][0]
    assert runs["cuda"][0]["nacks"] == 1 and runs["cuda"][0]["rejected"] == 1
    for g, w in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)
    assert len(runs["cuda"][2]) == len(runs["cpu"][2]) == 24
    for (cg, vg, eg), (cw, vw, ew) in zip(runs["cuda"][2], runs["cpu"][2]):
        assert (cg, eg) == (cw, ew)
        if not eg:
            torch.testing.assert_close(vg.cpu(), vw, rtol=1e-5, atol=1e-5)


# -- the fused sweeps: one launch polls, executes, masks and clears ---------

SWEEP_PROGRAMS = ("affine_relu", "wide_fma_zeroed")   # smem, global


def _bits(t):
    return t.contiguous().view(torch.int32)


def _sweep_both(cuda, prog, ring_np, ext, *, agg_k=0, bound=0, per_sub=1):
    """The fused sweep and its plain version on two copies of one ring,
    and ifunc_vm_slots on a third; returns (fused (status, [sub,] out),
    plain likewise, the two cleared rings, the slots' output, the
    pristine ring)."""
    pristine = torch.from_numpy(ring_np.view(np.int32)).to(cuda)
    a, b = pristine.clone(), pristine.clone()
    if agg_k:
        args = (agg_k, HDR_WORDS + 2 * agg_k, agg_k * per_sub, ext, bound)
        before = ifunc_vm_agg_sweep.launches
        got = ifunc_vm_agg_sweep(prog, a, *args)
        assert ifunc_vm_agg_sweep.launches == before + 1
        want = ifunc_vm_sweep_plain(prog, b, *args[1:4], agg_k=agg_k,
                                    bound_hash=bound)
        slots = ifunc_vm_slots(prog, pristine, args[1], args[2], ext)
    else:
        before = ifunc_vm_sweep.launches
        got = ifunc_vm_sweep(prog, a, HDR_WORDS, per_sub, ext)
        assert ifunc_vm_sweep.launches == before + 1
        want = ifunc_vm_sweep_plain(prog, b, HDR_WORDS, per_sub, ext)
        slots = ifunc_vm_slots(prog, pristine, HDR_WORDS, per_sub, ext)
    torch.cuda.synchronize()
    return got, want, a, b, slots, pristine


def _hold_sweep(got, want, cleared, plain_cleared, slots, pristine, run):
    """Statuses and the cleared ring bit for bit against the plain
    version; outputs of the tiles that ran (``run``) bit for bit equal to
    ifunc_vm_slots and within 2e-5 of the plain version, every other
    output +0.0; INFLIGHT and EMPTY slots untouched."""
    for g, w in zip(got[:-1], want[:-1]):
        assert torch.equal(g, w)
    assert torch.equal(cleared, plain_cleared)
    out, ref = got[-1], want[-1]
    assert torch.equal(_bits(out[run]), _bits(slots[run]))
    torch.testing.assert_close(out[run], ref[run], rtol=2e-5, atol=2e-5)
    assert not _bits(out[~run]).any()                 # +0.0, never -0.0
    status = got[0]
    kept = (status == 0) | (status == 2)
    assert torch.equal(cleared[kept], pristine[kept])
    assert not cleared[~kept].any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", SWEEP_PROGRAMS)
@pytest.mark.parametrize("per_slot", [1, 2, 4])
def test_ring_sweep_kernel_matches_plain(cuda, name, per_slot):
    """ring_sweep_*_kernel against ifunc_vm_sweep_plain on a ring mixing
    every status (a short READY frame among them), both plan variants."""
    instrs, symbols = PROGRAMS[name]
    prog = assemble(instrs, symbols)
    rng = np.random.default_rng(per_slot)
    ext = torch.from_numpy((rng.standard_normal(
        (4, len(symbols), T, T)) * 0.1).astype(np.float32)).to(cuda)
    got, want, a, b, slots, pristine = _sweep_both(
        cuda, prog, mixed_sweep_ring(16, per_slot), ext, per_sub=per_slot)
    assert got[0].tolist() == [0, 0, 1, 1, 2, 3, 3, 3] * 2
    run = (got[0] == 1).repeat_interleave(per_slot)
    _hold_sweep(got, want, a, b, slots, pristine, run)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SWEEP_PROGRAMS)
@pytest.mark.parametrize("k,per_sub,bound", [(4, 1, 0x8000ABCD), (4, 2, 0),
                                             (64, 1, 0x8000ABCD), (64, 1, 0)])
def test_agg_sweep_kernel_matches_plain(cuda, name, k, per_sub, bound):
    """agg_sweep_*_kernel against the plain version on the mixed aggregate
    ring: container and sub statuses, the cleared ring, the outputs of
    SUB_READY records and +0.0 elsewhere."""
    instrs, symbols = PROGRAMS[name]
    prog = assemble(instrs, symbols)
    rng = np.random.default_rng(k + per_sub)
    ext = torch.from_numpy((rng.standard_normal(
        (4, len(symbols), T, T)) * 0.1).astype(np.float32)).to(cuda)
    got, want, a, b, slots, pristine = _sweep_both(
        cuda, prog, mixed_agg_ring(k, per_sub * T * T, bound), ext, agg_k=k,
        bound=bound, per_sub=per_sub)
    assert got[0].tolist() == [0, 1, 1, 1, 3, 2, 3, 3, 1, 0, 3, 1]
    run = (got[1] == 1).reshape(-1).repeat_interleave(per_sub)
    _hold_sweep(got, want, a, b, slots, pristine, run)


@pytest.mark.cuda
@pytest.mark.parametrize("agg", [False, True])
@pytest.mark.parametrize("per_slot", [1, 2, 4])
def test_sweep_clear_has_no_race(cuda, agg, per_slot):
    """A ring of 64 slots, nearly all READY, one BAD and one INFLIGHT in
    every eight, swept 50 times from fresh copies: every sweep gives the
    first one's statuses, outputs and cleared ring bit for bit (a block
    clearing a header or trailer another block of its slot has yet to
    read would show as a wrong status or a slot left dirty)."""
    prog = assemble(*PROGRAMS["affine_relu"])
    rng = np.random.default_rng(per_slot)
    ext = torch.from_numpy((rng.standard_normal((8, 2, T, T)) * 0.1)
                           .astype(np.float32)).to(cuda)
    kinds = np.arange(64) % 8             # 6: BAD, 7: INFLIGHT, else READY
    if agg:                                # containers of per_slot records
        W = HDR_WORDS + per_slot * (2 + T * T) + 1
        ring = np.stack([pack_agg_word_frame(
            list(rng.standard_normal((per_slot, T * T)).astype(np.float32)),
            [7] * per_slot, per_slot, T * T, W, corrupt=kind == 6,
            no_trailer=kind == 7) for kind in kinds])
        args = (per_slot, HDR_WORDS + 2 * per_slot, per_slot, ext)
        fn = ifunc_vm_agg_sweep
    else:
        W = HDR_WORDS + per_slot * T * T + 1
        ring = np.stack([pack_word_frame(
            rng.standard_normal(per_slot * T * T).astype(np.float32), W,
            corrupt=kind == 6, no_trailer=kind == 7) for kind in kinds])
        args = (HDR_WORDS, per_slot, ext)
        fn = ifunc_vm_sweep
    pristine = torch.from_numpy(ring.view(np.int32)).to(cuda)
    mb = pristine.clone()
    first = fn(prog, mb, *args)
    first_mb = mb.clone()
    torch.cuda.synchronize()
    assert first[0].tolist() == [1] * 6 + [3, 2] + first[0].tolist()[8:]
    assert int((first[0] == 1).sum()) == 48
    for _ in range(50):
        mb.copy_(pristine)
        again = fn(prog, mb, *args)
        torch.cuda.synchronize()
        for g, w in zip(again, first):
            assert torch.equal(_bits(g), _bits(w))
        assert torch.equal(mb, first_mb)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["empty", "one", "full"])
def test_sweep_empty_one_and_full_rings(cuda, fill):
    """make_sweep on a card mailbox of 8 shards x 4 slots x 2 tiles:
    empty (nothing written, outputs +0.0), one READY slot, every slot
    READY; the cleared ring is the mailbox itself; a second sweep of it
    finds nothing READY."""
    rng = np.random.default_rng(3)
    W = HDR_WORDS + 2 * T * T + 1
    ring = np.zeros((8, 4, W), np.uint32)
    n = {"empty": 0, "one": 1, "full": 32}[fill]
    for i in range(n):
        ring[i % 8, i // 8] = pack_word_frame(
            rng.standard_normal(2 * T * T).astype(np.float32), W)
    mb = torch.from_numpy(ring.view(np.int32)).to(cuda)
    ext = torch.from_numpy((rng.standard_normal((8, 1, T, T)) * 0.1)
                           .astype(np.float32)).to(cuda)
    prog = deserialize_uvm(register_ifunc(Context("s"), "uvm_affine")
                           .lib.code)
    x = torch.from_numpy(ring[..., HDR_WORDS:HDR_WORDS + 2 * T * T].view(
        np.float32).reshape(8, 4, 2, T, T)).to(cuda)
    want = torch.relu(x @ ext[:, None, None, 0])
    sweep = make_sweep(prog, 2)
    status, out, cleared = sweep(mb, ext)
    assert cleared is mb
    assert int((status == 1).sum()) == n and not mb.any()
    want[status != 1] = 0
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-5)
    again, out2, _ = sweep(mb, ext)
    assert not again.any() and not _bits(out2).any()


@pytest.mark.cuda
@pytest.mark.parametrize("agg", [False, True])
def test_sweep_is_one_kernel_launch(cuda, agg):
    """Under torch.profiler a sweep is exactly one kernel, the fused one,
    by name: no poll kernel, no elementwise mask or clear."""
    from torch.profiler import ProfilerActivity, profile

    prog = deserialize_uvm(register_ifunc(Context("s"), "uvm_affine")
                           .lib.code)
    rng = np.random.default_rng(6)
    ext = torch.from_numpy((rng.standard_normal((4, 1, T, T)) * 0.1)
                           .astype(np.float32)).to(cuda)
    if agg:
        ring = mixed_agg_ring(4, T * T, 0)[None].repeat(4, 0)[:, :8]
        sweep = make_agg_sweep(prog, 4, 1)
    else:
        ring = mixed_sweep_ring(32, 2).reshape(4, 8, -1)
        sweep = make_sweep(prog, 2)
    pristine = torch.from_numpy(ring.view(np.int32)).to(cuda)
    mb = pristine.clone()
    sweep(mb, ext)                                      # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            mb.copy_(pristine)
            sweep(mb, ext)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset", "Activity"))]
    assert len(kernels) == 3, kernels
    assert all(sweep_kernel(prog, 4 if agg else 0) in k for k in kernels)


# Shapes that cross the edges of the bf16 kernels' tiles (64 keys and 128
# query rows forward; 128 keys and 64 or 32 queries in dK/dV) at both head
# dims, a window of one position, and a single position.
EDGE_SHAPES = [(2, 127, 64, 0), (2, 127, 128, 0), (2, 129, 64, 0),
               (2, 129, 128, 0), (2, 257, 64, 0), (2, 257, 128, 0),
               (2, 257, 64, 1), (2, 129, 128, 1), (1, 1, 128, 0)]

# The forward's head dims beyond the backward's: 96 (Phi-3-Vision; V's
# last column panel half padded) and 256 (RecurrentGemma; O by n256), at
# ragged tiles, with windows narrower than a tile and than S (2,048, the
# model's, at S = 2,100), and a single position.
FWD_ONLY_SHAPES = [(3, 200, 96, 0), (2, 257, 96, 64), (2, 129, 96, 1),
                   (3, 200, 256, 0), (2, 257, 256, 64), (1, 1, 256, 0),
                   (2, 2100, 256, 2048), (2, 2100, 96, 2048)]

# f32: the kernel and the plain version differ only in summation order.
# bf16: the kernel rounds O to bf16 (2^-8 relative), the plain version is
# taken in f32 on the same bf16 inputs; LSE stays f32 in both.
FLASH_TOL_F32 = dict(rtol=1e-4, atol=1e-4)
FLASH_TOL_BF16_O = dict(rtol=8e-3, atol=8e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 200, 64, 0), (2, 512, 128, 256),
                                   (15, 512, 64, 0), (2, 130, 64, 17),
                                   (1, 1, 64, 0), (2, 64, 128, 64)]
                         + EDGE_SHAPES + FWD_ONLY_SHAPES)
def test_flash_kernel_matches_plain(cuda, dtype, shape):
    """O and LSE of the kernel against the plain version: ragged tiles
    (S = 200, 130, 1), windows narrower and wider than a tile, the
    edges of the bf16 kernel's tiles of 64 keys and 128 query rows, and
    head_dim 96 and 256."""
    BH, S, hd, window = shape
    rng = np.random.default_rng(S + hd + window)
    q, k, v = (torch.from_numpy(rng.standard_normal((BH, S, hd))
                                .astype(np.float32)).to(cuda, dtype)
               for _ in range(3))
    scale = 1.0 / np.sqrt(hd)
    before = flash_fwd.launches
    o, lse = flash_fwd(q, k, v, scale=scale, window=window)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    o_p, lse_p = flash_fwd_plain(q.float(), k.float(), v.float(), scale=scale,
                                 window=window)
    tol = FLASH_TOL_F32 if dtype == torch.float32 else FLASH_TOL_BF16_O
    torch.testing.assert_close(o.float(), o_p, **tol)
    torch.testing.assert_close(lse, lse_p, **FLASH_TOL_F32)


@pytest.mark.cuda
def test_flash_kernel_refuses_other_head_dims(cuda):
    """Forward and backward (``flash_bwd``, each backward kernel's wrapper
    and ``flash_attention``) refuse a head_dim the kernels are not built
    for, 48 and 160, each with a ValueError naming it and before any
    launch."""
    def counts():
        return (flash_fwd.launches, flash_bwd_dq.launches,
                flash_bwd_dkv.launches)

    before = counts()
    for hd in (48, 160):
        x = torch.zeros(2, 64, hd, device=cuda)
        row = torch.zeros(2, 64, device=cuda)
        with pytest.raises(ValueError, match=f"not {hd}"):
            flash_fwd(x, x, x, scale=1.0)
        with pytest.raises(ValueError, match=f"not {hd}"):
            flash_attention(x, x, x, hd ** -0.5, 0, 64, 64)
        with pytest.raises(ValueError, match=f"not {hd}"):
            flash_bwd(x, x, x, x, row, x, scale=1.0)
        with pytest.raises(ValueError, match=f"not {hd}"):
            flash_bwd_dq(x, x, x, x, row, row, scale=1.0)
        with pytest.raises(ValueError, match=f"not {hd}"):
            flash_bwd_dkv(x, x, x, x, row, row, scale=1.0)
    assert counts() == before


def _ssd_groups(BH):
    """The group counts each shape runs: G = BH, G = 1 and G = 2 where
    BH is even."""
    return sorted({BH, 1} | ({2} if BH % 2 == 0 else set()))


def _ssd_inputs(cuda, BH, G, nc, Q, hd, ds, seed):
    """x, la, B and C of G groups, and B and C broadcast to BH rows."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(cuda)

    x = t(rng.standard_normal((BH, nc, Q, hd)))
    la = t(-np.abs(rng.standard_normal((BH, nc, Q))) * 0.2)
    Bg = t(rng.standard_normal((G, nc, Q, ds)) * 0.2)
    Cg = t(rng.standard_normal((G, nc, Q, ds)) * 0.2)
    Bb, Cb = (a.repeat_interleave(BH // G, dim=0) for a in (Bg, Cg))
    return x, la, Bg, Cg, Bb, Cb


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1, 200, 64, 128), (3, 4, 256, 64, 128),
                                   (2, 3, 8, 16, 16), (1, 2, 37, 32, 100),
                                   (48, 16, 256, 64, 128)])
def test_ssd_scan_kernel_matches_plain(cuda, shape):
    """Within the reference's 3e-4: Q = 200, the path's (256, 64, 128), the
    tests' Q = 8, a ragged Q = 37 with ds = 100, and the Mamba-2 prefill's
    [48, 16, 256, 64, 128]; each with B and C per row (G = BH), shared by
    all rows (G = 1) and, where BH is even, in two groups.  One launch
    count a call."""
    BH, nc, Q, hd, ds = shape
    for G in _ssd_groups(BH):
        x, la, Bg, Cg, Bb, Cb = _ssd_inputs(cuda, BH, G, nc, Q, hd, ds,
                                            Q + ds + G)
        before = ssd_scan.launches
        y = ssd_scan(x, la, Bg, Cg)
        torch.cuda.synchronize()
        assert ssd_scan.launches == before + 1
        torch.testing.assert_close(y, ssd_scan_plain(x, la, Bb, Cb),
                                   rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1, 200, 64, 128), (4, 2, 37, 32, 100),
                                   (48, 16, 256, 64, 128)])
def test_ssd_scan_groups_equal_broadcast_bit_for_bit(cuda, shape):
    """B and C in G groups give what the same tensors broadcast to every
    row give, bit for bit: every G runs the same C B^T code."""
    BH, nc, Q, hd, ds = shape
    for G in _ssd_groups(BH):
        x, la, Bg, Cg, Bb, Cb = _ssd_inputs(cuda, BH, G, nc, Q, hd, ds, G)
        assert torch.equal(ssd_scan(x, la, Bg, Cg), ssd_scan(x, la, Bb, Cb))


@pytest.mark.cuda
def test_ssd_scan_launches_its_four_kernels(cuda):
    """torch.profiler sees the four ssd_ kernels of one call, each once."""
    from torch.profiler import ProfilerActivity, profile

    x, la, Bg, Cg, _, _ = _ssd_inputs(cuda, 4, 1, 2, 256, 64, 128, 0)
    ssd_scan(x, la, Bg, Cg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ssd_scan(x, la, Bg, Cg)
        torch.cuda.synchronize()
    seen = {name: 0 for name in ("ssd_chunk_state_kernel",
                                 "ssd_state_pass_kernel", "ssd_bmm_kernel",
                                 "ssd_chunk_scan_kernel")}
    for e in prof.key_averages():
        for name in seen:
            if name in e.key:
                seen[name] += e.count
    assert seen == dict.fromkeys(seen, 1)


@pytest.mark.cuda
def test_ssd_scan_kernel_refuses_groups_that_do_not_divide(cuda):
    x, la, Bg, Cg, _, _ = _ssd_inputs(cuda, 4, 3, 1, 8, 16, 16, 0)
    before = ssd_scan.launches
    with pytest.raises(ValueError, match="do not divide"):
        ssd_scan(x, la, Bg, Cg)
    assert ssd_scan.launches == before


SMALL = {
    "attn": ModelConfig(name="small-attn", family="dense", num_layers=2,
                        d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                        vocab_size=512, head_dim=64, q_chunk=64,
                        attn_impl="flash", dtype="float32",
                        param_dtype="float32"),
    "ssd": ModelConfig(name="small-ssd", family="ssm", num_layers=2,
                       d_model=64, num_heads=1, num_kv_heads=1, d_ff=0,
                       vocab_size=512, block_pattern=("ssd",), ssm_state=16,
                       ssm_head_dim=16, ssm_chunk=8, tie_embeddings=True,
                       ssd_impl="kernel", dtype="float32",
                       param_dtype="float32"),
    # RecurrentGemma's blocks at head_dim 256 (rglru, rglru, attn_local
    # with a window of 16, one trailing rglru) and Qwen3-MoE's at head_dim
    # 128 (8 experts, top 2)
    "rglru": ModelConfig(name="small-rglru", family="hybrid", num_layers=4,
                         d_model=128, num_heads=2, num_kv_heads=1, d_ff=256,
                         vocab_size=512, head_dim=256,
                         block_pattern=("rglru", "rglru", "attn_local"),
                         attn_window=16, lru_width=128, tie_embeddings=True,
                         q_chunk=64, attn_impl="flash", dtype="float32",
                         param_dtype="float32"),
    "moe": ModelConfig(name="small-moe", family="moe", num_layers=2,
                       d_model=128, num_heads=4, num_kv_heads=2, d_ff=64,
                       vocab_size=512, head_dim=128,
                       block_pattern=("attn_moe",), num_experts=8,
                       experts_per_token=2, moe_d_ff=64, q_chunk=64,
                       attn_impl="flash", dtype="float32",
                       param_dtype="float32"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(SMALL))
def test_small_model_prefill_decode_on_the_card_matches_the_cpu(cuda, kind):
    """A small model through the kernels on the card and through the
    plain versions on the CPU, the same parameters: prefill logits and
    cache, then 4 decode steps, within 1e-4; the kernel runs once per
    attention (or SSD) layer in prefill and never in decode."""
    cfg = SMALL[kind]
    params = MT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 512, (2, 36)).astype(np.int64))
    counter = ssd_scan if kind == "ssd" else flash_fwd
    per_prefill = sum(k in ("ssd", *MT.ATTN_KINDS) for k in cfg.layer_kinds)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        p = {k: v.to(dev) for k, v in params.items()}
        before = counter.launches
        logits, cache, _ = MT.forward(p, {"tokens": toks[:, :32].to(dev)},
                                      cfg, mode="prefill")
        outs = [logits, *cache.values()]
        cache = pad_cache_to(cache, MT.cache_shapes(cfg, 2, 40))
        if dev.type == "cuda":
            assert counter.launches == before + per_prefill
        mid = counter.launches
        for t in range(32, 36):
            logits, cache, _ = MT.forward(p, {"tokens": toks[:, t:t + 1].to(dev)},
                                          cfg, mode="decode", cache=cache,
                                          pos=t)
            outs.append(logits)
        assert counter.launches == mid
        runs[dev.type] = outs + list(cache.values())
    for g, w in zip(runs["cuda"], runs["cpu"]):
        assert g.shape == w.shape and bool(torch.isfinite(g.float()).all())
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


# The backward kernels against flash_bwd_plain on the same inputs (the
# kernel's own forward O and LSE).  f32: summation order only, within the
# reference's gradient tolerance (tests/test_kernels.py).  bf16: the
# kernels round dQ, dK, dV to bf16 (2^-9 relative), the plain version is
# taken in f32 on the same bf16 inputs.
FLASH_BWD_TOL_F32 = dict(rtol=2e-4, atol=2e-4)
FLASH_BWD_TOL_BF16 = dict(rtol=8e-3, atol=8e-3)


def _flash_operands(cuda, dtype, BH, S, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((BH, S, hd))
                             .astype(np.float32)).to(cuda, dtype)
            for _ in range(4)]


# head_dim 96 (Phi-3-Vision: the padded last column panel) and 256
# (RecurrentGemma: dK and dV in separate warpgroups, key tiles of 32 in
# bf16 dQ, rows of 32 in f32): ragged S, a single position, windows
# narrower and wider than a tile, and the model's 2,048 at S = 2,100
BWD_WIDE_SHAPES = [(3, 200, 96, 0), (2, 130, 96, 17), (2, 300, 96, 200),
                   (1, 1, 96, 0), (2, 2100, 96, 2048), (3, 200, 256, 0),
                   (2, 130, 256, 17), (2, 300, 256, 200), (1, 1, 256, 0),
                   (2, 2100, 256, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 200, 64, 0), (2, 512, 128, 256),
                                   (15, 512, 64, 0), (2, 130, 64, 17),
                                   (1, 1, 64, 0), (2, 64, 128, 64),
                                   (2, 300, 128, 0)] + EDGE_SHAPES
                         + BWD_WIDE_SHAPES)
def test_flash_bwd_kernels_match_plain(cuda, dtype, shape):
    """dQ, dK, dV of the two backward kernels against the plain version:
    ragged tiles (S = 200, 130, 1, 300), windows narrower and wider than a
    tile, head_dim 64, 96, 128 and 256, the bf16 kernels' tile edges; each
    kernel launched once."""
    BH, S, hd, window = shape
    q, k, v, do = _flash_operands(cuda, dtype, BH, S, hd, S + hd + window)
    scale = 1.0 / np.sqrt(hd)
    o, lse = flash_fwd(q, k, v, scale=scale, window=window)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    got = flash_bwd(q, k, v, o, lse, do, scale=scale, window=window)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    want = flash_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                           do.float(), scale=scale, window=window)
    tol = FLASH_BWD_TOL_F32 if dtype == torch.float32 else FLASH_BWD_TOL_BF16
    for name, g, w in zip(("dQ", "dK", "dV"), got, want):
        assert g.dtype == dtype and bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g.float(), w, **tol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(15, 512, 64, 0), (2, 257, 128, 0),
                                   (2, 130, 64, 17), (2, 257, 96, 0),
                                   (3, 200, 256, 17), (2, 2100, 256, 2048)])
def test_flash_bwd_dkv_bf16_launches_are_bit_identical(cuda, shape):
    """Two launches of the bf16 dK/dV kernel on the same inputs give the
    same bits: each output has one writer and a fixed order of sums."""
    BH, S, hd, window = shape
    q, k, v, do = _flash_operands(cuda, torch.bfloat16, BH, S, hd, 11 + S)
    scale = 1.0 / np.sqrt(hd)
    o, lse = flash_fwd(q, k, v, scale=scale, window=window)
    delta = FA.flash_delta(o, do)
    before = flash_bwd_dkv.launches
    first = flash_bwd_dkv(q, k, v, do, lse, delta, scale=scale, window=window)
    second = flash_bwd_dkv(q, k, v, do, lse, delta, scale=scale, window=window)
    torch.cuda.synchronize()
    assert flash_bwd_dkv.launches == before + 2
    for a, b in zip(first, second):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(15, 512, 64, 0), (2, 257, 128, 0),
                                   (2, 130, 64, 17), (2, 257, 96, 0),
                                   (3, 200, 256, 17), (2, 2100, 256, 2048)])
def test_flash_bwd_dq_bf16_launches_are_bit_identical(cuda, shape):
    """Two launches of the bf16 dQ kernel on the same inputs give the same
    bits: each output has one writer and a fixed order of sums."""
    BH, S, hd, window = shape
    q, k, v, do = _flash_operands(cuda, torch.bfloat16, BH, S, hd, 13 + S)
    scale = 1.0 / np.sqrt(hd)
    o, lse = flash_fwd(q, k, v, scale=scale, window=window)
    delta = FA.flash_delta(o, do)
    before = flash_bwd_dq.launches
    first = flash_bwd_dq(q, k, v, do, lse, delta, scale=scale, window=window)
    second = flash_bwd_dq(q, k, v, do, lse, delta, scale=scale, window=window)
    torch.cuda.synchronize()
    assert flash_bwd_dq.launches == before + 2
    assert first.dtype == torch.bfloat16 and torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S", [1, 63, 65, 127, 129])
def test_flash_bwd_dq_bf16_tile_edges(cuda, S, hd):
    """The bf16 dQ kernel at the edges of its query tiles of 128 (two
    warpgroups of 64) and key tiles of 64, with a window of 17, against
    the plain version within 8e-3."""
    q, k, v, do = _flash_operands(cuda, torch.bfloat16, 2, S, hd, 29 + S)
    scale = 1.0 / np.sqrt(hd)
    o, lse = flash_fwd(q, k, v, scale=scale, window=17)
    delta = FA.flash_delta(o, do)
    got = flash_bwd_dq(q, k, v, do, lse, delta, scale=scale, window=17)
    want = FA.flash_bwd_dq_plain(q.float(), k.float(), v.float(), do.float(),
                                 lse, delta, scale=scale, window=17)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want, **FLASH_BWD_TOL_BF16)


@pytest.mark.cuda
def test_flash_attention_backward_on_the_card_runs_only_the_kernels(
        cuda, monkeypatch):
    """The autograd.Function's backward on CUDA tensors launches both
    kernels and never the plain formulas, and its gradients match the
    CPU's (the plain version) within 2e-4."""
    def refuse(*a, **k):
        raise AssertionError("the plain backward ran on a CUDA tensor")

    q, k, v, _ = _flash_operands(torch.device("cpu"), torch.float32, 4, 256,
                                 64, 7)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        if dev.type == "cuda":
            monkeypatch.setattr(FA, "_bwd_plain", refuse)
            monkeypatch.setattr(FA, "flash_bwd_plain", refuse)
            before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
        o = flash_attention(*leaves, 0.125, 32, 128, 128)
        (o.float() ** 2).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == \
                (before[0] + 1, before[1] + 1)
            monkeypatch.undo()
        grads[dev.type] = [t.grad for t in leaves]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(g.cpu(), w, **FLASH_BWD_TOL_F32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,remat", [("attn", "none"), ("attn", "block"),
                                        ("attn", "dots"), ("hd96", "block"),
                                        ("rglru", "block")])
def test_flash_train_step_on_the_card_matches_the_cpu(cuda, kind, remat):
    """A train step of a small flash model (2 microbatches) on the card
    and on the CPU from the same parameters: the loss within 1e-5 relative
    and every gradient within 1e-4 relative L2; the kernels ran (the
    forward once an attention layer a microbatch, twice under a
    checkpoint, each backward kernel once), and one AdamW step leaves
    finite parameters.  Head_dim 64, 96 (the attention model at
    Phi-3-Vision's head_dim) and 256 (the RG-LRU model, window 16)."""
    small = {**SMALL, "hd96": SMALL["attn"].with_(name="small-attn-96",
                                                  head_dim=96)}
    cfg = small[kind].with_(remat=remat)
    params = MT.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 512, (4, 64)).astype(np.int32),
             "labels": rng.integers(0, 512, (4, 64)).astype(np.int32)}
    step = make_train_step(cfg, OptConfig(), microbatches=2)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = {k: v.to(dev) for k, v in params.items()}
        before = (flash_fwd.launches, flash_bwd_dq.launches,
                  flash_bwd_dkv.launches)
        out[dev.type] = step.grads(p, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            n = sum(k in MT.ATTN_KINDS for k in cfg.layer_kinds) * 2
            fwd = n if remat == "none" else 2 * n
            assert (flash_fwd.launches - before[0],
                    flash_bwd_dq.launches - before[1],
                    flash_bwd_dkv.launches - before[2]) == (fwd, n, n)
            state, m = step({"params": p, "opt": step.init_opt(p), "step": 0},
                            batch)
            assert all(bool(torch.isfinite(t).all())
                       for t in state["params"].values())
    (lc, _, gc), (lp, _, gp) = out["cuda"], out["cpu"]
    assert abs(float(lc) - float(lp)) <= 1e-5 * abs(float(lp))
    assert set(gc) == set(gp)
    for key in gp:
        err = float(torch.linalg.vector_norm(gc[key].cpu() - gp[key])
                    / torch.linalg.vector_norm(gp[key]))
        assert err < 1e-4, (key, err)


@pytest.mark.cuda
def test_ssd_scan_refuses_gradients_on_the_card(cuda):
    x = torch.zeros(2, 1, 8, 16, device=cuda, requires_grad=True)
    la = torch.zeros(2, 1, 8, device=cuda)
    Bm = torch.zeros(2, 1, 8, 16, device=cuda)
    before = ssd_scan.launches
    with pytest.raises(SsdScanGradError):
        ssd_scan(x, la, Bm, Bm)
    assert ssd_scan.launches == before
    with torch.no_grad():
        ssd_scan(x, la, Bm, Bm)
    assert ssd_scan.launches == before + 1


# ------------------------------------------------------- the host target


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles", [1, 2, 128])
def test_uvm_frame_on_a_card_target_runs_ifunc_vm(cuda, n_tiles):
    """A μVM frame polled on a ``device="cuda"`` host target: one
    ``ifunc_vm`` launch, its result bit for bit the kernel's on the same
    tiles and within 2e-5 of the plain version, the slot cleared; the
    resident W is used where it lies."""
    from repro_torch.core import Status, ifunc_msg_send_nbix, poll_ifunc

    src, dst = Context("src"), Context("dst", device="cuda")
    h = register_ifunc(src, "uvm_affine")
    region = dst.nic.mem_map((n_tiles * T * T * 4 + 4096 + 0xFFF) & ~0xFFF)
    ep = src.nic.connect(dst.nic)
    rng = np.random.default_rng(n_tiles)
    x = rng.standard_normal((n_tiles, T, T)).astype(np.float32)
    W = torch.from_numpy((rng.standard_normal((T, T)) * 0.05)
                         .astype(np.float32)).to(cuda)
    ifunc_msg_send_nbix(ep, ifunc_msg_create(h, x), region.base, region.rkey)
    targs = {"externals": {"W": W}}
    before = ifunc_vm.launches
    assert poll_ifunc(dst, region.view(), None, targs) == Status.OK
    assert ifunc_vm.launches == before + 1
    got = targs["result"]
    assert got.device.type == "cuda" and not any(region.buf)
    prog = deserialize_uvm(h.lib.code)
    tiles = torch.from_numpy(x).to(cuda)
    assert torch.equal(got, ifunc_vm(prog, tiles, W[None]))
    torch.testing.assert_close(got, ifunc_vm_plain(prog, tiles, W[None]),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_hlo_frame_on_a_card_target_matches_the_cpu(cuda):
    """An HLO frame (a ``torch.export`` program traced on CPU tensors)
    polled on a ``device="cuda"`` host target runs there, and its result
    equals the CPU target's on the same payload."""
    from repro_torch.core import CodeKind, Status, poll_ifunc
    from repro_torch.core import codegen as CG
    from repro_torch.core import frame as F

    code = CG.serialize_hlo(lambda x: (x.to(torch.float32) * 3 - 7).sum(),
                            (torch.zeros(16, dtype=torch.uint8),))
    frame = F.pack_frame("hlo_affine_sum", code, bytes(range(16)),
                         CodeKind.HLO)
    out = {}
    for dev in ("cpu", "cuda"):
        dst = Context("dst", device=dev)
        region = dst.nic.mem_map(1 << 16)
        region.buf[:len(frame)] = frame
        targs = {}
        assert poll_ifunc(dst, region.view(), None, targs) == Status.OK
        assert dst.stats["links"] == 1 and not any(region.buf)
        out[dev] = targs["result"]
    assert out["cuda"].device.type == "cuda"
    assert torch.equal(out["cuda"].cpu(), out["cpu"])


@pytest.mark.cuda
def test_uvm_future_over_a_reply_ring_on_a_card_target(cuda):
    """A μVM task through ``TaskRuntime`` to an RDMA peer on a
    ``device="cuda"`` target with a reply ring: one ``ifunc_vm`` launch,
    the result on the card copied to the host once by the wire codec,
    the future's numpy value within rtol 1e-4, atol 1e-5 of relu(x @ W)."""
    from repro_torch.tasks import TaskRuntime
    from repro_torch.transport import RdmaFabric

    src = Context("src", device="cuda")
    rt = TaskRuntime(src, engine=ProgressEngine(inflight_window="trailer"))
    h = register_ifunc(src, "uvm_affine")
    rng = np.random.default_rng(23)
    W = torch.from_numpy((rng.standard_normal((T, T)) * 0.05)
                         .astype(np.float32)).to(cuda)
    rt.add_peer("rdma", RdmaFabric(), Context("rdma", link_mode="remote",
                                              device="cuda"),
                n_slots=4, slot_size=132 << 10,
                target_args={"externals": {"W": W}})
    assert rt.dispatcher.peers["rdma"].reply_mailbox is not None
    x = rng.standard_normal((2, T, T)).astype(np.float32)
    before = ifunc_vm.launches
    fut = rt.submit("rdma", h, x)
    got = fut.result(60)
    assert ifunc_vm.launches == before + 1
    assert isinstance(got, np.ndarray) and got.shape == (2, T, T)
    want = torch.relu(torch.from_numpy(x).to(cuda) @ W).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert rt.pending() == 0 and rt.dispatcher.peers["rdma"].stats[
        "replies"] == 1


@pytest.mark.cuda
def test_device_lane_future_on_the_card(cuda):
    """A μVM task through ``TaskRuntime`` to a ``DeviceMeshFabric`` peer
    on the card: no reply ring; the sweep's result tensor, on the card,
    resolves the future within rtol 1e-4, atol 1e-5 of relu(x @ W)."""
    from repro_torch.tasks import TaskRuntime

    src = Context("src")
    rt = TaskRuntime(src, engine=ProgressEngine(inflight_window="trailer"))
    h = register_ifunc(src, "uvm_affine")
    rng = np.random.default_rng(29)
    W = torch.from_numpy((rng.standard_normal((T, T)) * 0.05)
                         .astype(np.float32)).to(cuda)
    rt.add_peer("gpu", DeviceMeshFabric(2, shift=0, device="cuda"), None,
                n_slots=2, slot_size=(2 * T * T + 64) * 4,
                prog=deserialize_uvm(h.lib.code), n_tiles=2,
                externals=W.expand(2, 1, T, T))
    assert rt.dispatcher.peers["gpu"].reply_mailbox is None
    xs = [rng.standard_normal((2, T, T)).astype(np.float32) for _ in range(3)]
    before = ifunc_vm_sweep.launches
    futs = [rt.submit("gpu", h, x) for x in xs]
    for x, fut in zip(xs, futs):
        got = fut.result(60)
        assert got.device.type == "cuda" and got.shape == (2, T, T)
        torch.testing.assert_close(
            got, torch.relu(torch.from_numpy(x).to(cuda) @ W),
            rtol=1e-4, atol=1e-5)
    assert ifunc_vm_sweep.launches > before
    assert rt.pending() == 0 and rt.stats["resolved"] == 3


@pytest.mark.cuda
def test_graph_degree_sweep_on_the_card(cuda):
    """``graph_degree`` (loadp, loade, matmul, store: no relu) as futures on
    ``DeviceMeshFabric(2)`` on the card, the adjacency column-sharded into
    the externals: one frontier tile to each shard, ONE
    ``ring_sweep_smem_kernel`` launch for both, and each shard's counts
    equal to ``ifunc_vm_plain`` on the card and to numpy's ``f_ind @
    A_dev[d, 0]`` exactly (sums of 0/1 products, at most 128)."""
    from repro_torch.tasks import TaskRuntime

    src = Context("src")
    rt = TaskRuntime(src, engine=ProgressEngine(inflight_window="trailer"))
    h = register_ifunc(src, "graph_degree")
    prog = deserialize_uvm(h.lib.code)
    assert vm_plan(prog).n_tiles <= 3               # the smem variant
    rng = np.random.default_rng(31)
    A = (rng.random((T, T)) < 0.2).astype(np.float32)
    A_dev = np.zeros((2, 1, T, T), np.float32)
    for s in range(2):
        A_dev[s, 0, :, s * 64:(s + 1) * 64] = A[:, s * 64:(s + 1) * 64]
    ext = torch.from_numpy(A_dev).to(cuda)
    rt.add_peer("gpu", DeviceMeshFabric(2, shift=0, device="cuda"), None,
                n_slots=4, slot_size=128 << 10, prog=prog, n_tiles=1,
                externals=ext)
    lane = rt.dispatcher.peers["gpu"].rings[0]
    f_ind = (rng.random(T) < 0.4).astype(np.float32)
    tile = np.broadcast_to(f_ind, (T, T)).reshape(1, T, T).copy()
    sweeps, launches = ifunc_vm_sweep.launches, ifunc_vm.launches
    futs = [(lane.mailbox.slot_coords(lane.tail)[0], rt.submit("gpu", h, tile))
            for _ in range(2)]
    got = {s: f.result(60) for s, f in futs}
    assert ifunc_vm_sweep.launches == sweeps + 1
    assert ifunc_vm.launches == launches
    x = torch.from_numpy(tile).to(cuda)
    for s, out in got.items():
        assert out.device.type == "cuda" and out.shape == (1, T, T)
        assert torch.equal(out, ifunc_vm_plain(prog, x, ext[s]))
        assert (out.cpu().numpy() == f_ind @ A_dev[s, 0]).all()
    assert sorted(got) == [0, 1] and rt.pending() == 0


@pytest.mark.cuda
def test_uvm_stream_on_a_card_target_runs_ifunc_vm_once(cuda):
    """A 128-tile (8 MiB) ``uvm_affine`` stream by ``send_stream``, at
    ``set_streaming``'s defaults (256 KiB chunks, window 4), to an RDMA
    peer on a ``device="cuda"`` target: 32 chunks assembled, ONE
    ``ifunc_vm`` launch, the result bit for bit ``uvm_execute``'s on the
    same tiles, no receive state left."""
    from repro_torch.core import frame as F
    from repro_torch.kernels.ops import uvm_execute
    from repro_torch.transport import RdmaFabric

    src = Context("src")
    d = Dispatcher(src, ProgressEngine(flush_threshold=64))
    d.set_streaming(True)
    h = register_ifunc(src, "uvm_affine")
    slot = (F.HEADER_LEN + len(h.lib.code) + F.TRAILER_LEN
            + F.stream_payload_len(4, (256 << 10) + F.CHUNK_OVERHEAD))
    rng = np.random.default_rng(31)
    W = torch.from_numpy((rng.standard_normal((T, T)) * 0.05)
                         .astype(np.float32)).to(cuda)
    d.add_peer("rdma", RdmaFabric(), Context("dst", link_mode="remote",
                                             device="cuda"),
               n_slots=2, slot_size=slot, target_args={"externals": {"W": W}})
    x = rng.standard_normal((128, T, T)).astype(np.float32)
    before = ifunc_vm.launches
    assert d.send_stream("rdma", h, x)
    d.drain()
    assert ifunc_vm.launches == before + 1
    peer = d.peers["rdma"]
    assert peer.stats["streams"] == 1 and peer.stats["stream_chunks"] == 32
    assert not peer.rings[0].mailbox.streams and not d._active_streams
    got = peer.target_args["result"]
    assert got.device.type == "cuda" and got.shape == (128, T, T)
    prog = deserialize_uvm(h.lib.code)
    assert torch.equal(got, uvm_execute(prog, torch.from_numpy(x).to(cuda),
                                        [W], device=cuda))


@pytest.mark.cuda
def test_uvm_chain_on_card_targets_runs_ifunc_vm_per_hop(cuda):
    """A two-hop ``uvm_affine`` chain through ``repro_torch.flow`` on card
    contexts (the engine's default device): the first hop's result, a
    tensor on the card, is the second hop's payload, so the chain
    launches ``ifunc_vm`` twice and returns relu(relu(x @ W_a) @ W_agg)
    within rtol 1e-4, atol 1e-5 of ``ifunc_vm_plain`` stage by stage."""
    from repro_torch.flow import Flow, FlowEngine
    from repro_torch.transport import RdmaFabric

    eng = FlowEngine(Context("host"), default_timeout=60.0)
    rng = np.random.default_rng(26)
    Ws = {}
    for name in ("dpu_a", "agg"):
        node = eng.add_node(name, RdmaFabric(), slot_size=256 << 10)
        assert torch.device(node.ctx.device).type == "cuda"
        Ws[name] = torch.from_numpy((rng.standard_normal((T, T)) * 0.05)
                                    .astype(np.float32)).to(cuda)
        node.target_args["externals"] = {"W": Ws[name]}
    flow = Flow("affine").stage("uvm_affine", at="dpu_a") \
        .then("uvm_affine", at="agg")
    x = rng.standard_normal((2, T, T)).astype(np.float32)
    before = ifunc_vm.launches
    got = eng.submit(flow, x).result(60)
    assert ifunc_vm.launches == before + 2
    assert isinstance(got, np.ndarray) and got.shape == (2, T, T)
    prog = deserialize_uvm(eng.ctx.handles["uvm_affine"].lib.code)
    hop1 = ifunc_vm_plain(prog, torch.from_numpy(x).to(cuda),
                          Ws["dpu_a"][None])
    want = ifunc_vm_plain(prog, hop1, Ws["agg"][None]).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert eng.pending() == 0 and eng.stats["completed"] == 1


@pytest.mark.cuda
def test_checkpoint_round_trip_of_card_tensors(cuda, tmp_path):
    """A train-state-shaped dict of bf16 and f32 tensors on the card and
    int counters saves asynchronously (the host copy taken inside
    ``save``, so a later in-place update does not reach the files) and
    restores from a meta template onto the card bit for bit, ints as
    ints, with sha256 verified."""
    from repro_torch.runtime import CheckpointManager

    g = torch.Generator(device=cuda).manual_seed(5)
    state = {"params": {"w": torch.randn(64, 32, generator=g, device=cuda)
                        .to(torch.bfloat16),
                        "b": torch.randn(32, generator=g, device=cuda)},
             "opt": {"m": {"w": torch.randn(64, 32, generator=g,
                                            device=cuda)},
                     "count": 9},
             "step": 9}
    want = {"w": state["params"]["w"].clone(), "b": state["params"]["b"]
            .clone(), "m": state["opt"]["m"]["w"].clone()}
    cm = CheckpointManager(tmp_path, keep=1)
    cm.save(9, state, blocking=False)
    state["params"]["w"].add_(1)               # after the host copy
    cm.wait()
    meta = {"params": {"w": torch.empty(64, 32, dtype=torch.bfloat16,
                                        device="meta"),
                       "b": torch.empty(32, device="meta")},
            "opt": {"m": {"w": torch.empty(64, 32, device="meta")},
                    "count": 0},
            "step": 0}
    back = cm.restore(meta, verify=True)
    assert back["step"] == 9 and back["opt"]["count"] == 9
    for got, ref in ((back["params"]["w"], want["w"]),
                     (back["params"]["b"], want["b"]),
                     (back["opt"]["m"]["w"], want["m"])):
        assert got.device.type == "cuda" and got.dtype == ref.dtype
        assert torch.equal(got.view(torch.int16) if got.dtype ==
                           torch.bfloat16 else got,
                           ref.view(torch.int16) if ref.dtype ==
                           torch.bfloat16 else ref)
    assert cm.steps() == [9] and cm.history[0]["bytes"] == \
        64 * 32 * 2 + 32 * 4 + 64 * 32 * 4 + 4 + 4


@pytest.mark.cuda
def test_serving_fleet_on_the_card_matches_the_host(cuda):
    """The disaggregated 2+2 fleet on the card at a ``TINY``-like width
    with head_dim 64 and ``attn_impl="flash"``: prompts of distinct
    lengths (so every prefill group is one sequence, the host's shape)
    and the host's slot count on each decode peer give the single host's
    tokens, token for token; every KV slab streamed, and ``flash_fwd``
    launched once a layer in each prefill on both sides."""
    from repro_torch.serving import Request, Server, ServingFabric

    cfg = ModelConfig(name="serve-tiny-hd64", family="dense", num_layers=4,
                      d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
                      vocab_size=512, q_chunk=128, attn_impl="flash")
    params = MT.init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    lens, news = (128, 100, 64, 33, 16, 9, 7, 4), (8, 16, 32)

    def reqs():
        r = np.random.default_rng(25)
        return [Request(i, r.integers(0, cfg.vocab_size, n).astype(np.int32),
                        news[i % 3]) for i, n in enumerate(lens)]

    host = Server(cfg, params, 4, 256, device=cuda)
    before = flash_fwd.launches
    want, pending = {}, reqs()
    while pending or host.active:
        while pending and host.admit(pending[0]):
            pending.pop(0)
        for r in host.tick()[1]:
            want[r.rid] = list(r.out)
    assert flash_fwd.launches - before == cfg.num_layers * len(lens)
    fab = ServingFabric(cfg, params, n_prefill=2, n_decode=2, batch_slots=4,
                        cache_len=256, device=cuda)
    before = flash_fwd.launches
    done = fab.run(reqs())
    fab.drain()
    assert {k: list(r.out) for k, r in done.items()} == want
    assert flash_fwd.launches - before == cfg.num_layers * len(lens)
    assert fab.streams_landed() == len(lens) and fab.buffered_installs() == 0
    assert all(len(want[i]) == news[i % 3] for i in range(len(lens)))
