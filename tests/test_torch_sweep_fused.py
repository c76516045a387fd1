"""The sweep's contract on the CPU, where ``make_sweep`` and
``make_agg_sweep`` run their plain versions (``sweep_plain``,
``agg_sweep_plain``) — the same contract the fused CUDA kernels keep on
the card (``tests/test_torch_cuda.py``) — held against the JAX package:
statuses by its ``ring_poll_ref`` and ``agg_ring_poll`` (interpret mode),
outputs by its ``ifunc_vm_ref``.  Pinned besides: the clear is in place
(the cleared ring *is* the mailbox), INFLIGHT and EMPTY slots are left
bit for bit, masked outputs are +0.0, a second sweep finds nothing
READY, and an INFLIGHT slot completed in place then sweeps READY."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codegen as RCG
from repro.core.device_mailbox import \
    pack_agg_word_frame as ref_pack_agg_word_frame
from repro.core.device_mailbox import pack_word_frame as ref_pack_word_frame
from repro.kernels import ref as REF
from repro.kernels.agg_poll import agg_ring_poll as ref_agg_ring_poll
from repro_torch import convert
from repro_torch.core import Context, register_ifunc
from repro_torch.core.codegen import deserialize_uvm
from repro_torch.core.device_mailbox import (agg_sweep_plain, empty_mailbox,
                                             make_agg_sweep, make_deposit,
                                             make_sweep, sweep_plain)
from repro_torch.kernels.agg_poll import AGG_MAGIC, SUB_READY
from repro_torch.kernels.ifunc_vm import (ifunc_vm_agg_sweep, ifunc_vm_sweep,
                                          ifunc_vm_sweep_plain)
from repro_torch.kernels.ring_poll import (BAD, EMPTY, HDR_WORDS, INFLIGHT,
                                           READY, TRAILER)

T = 128
S, N, SHIFT = 4, 3, 3                 # shards, slots a shard, deposit shift
K = 4
TOL = dict(rtol=1e-4, atol=1e-5)      # the μVM on its oracle, as the lanes
HIGH_BIT = 0x8000ABCD                 # a bound hash negative as int32


@pytest.fixture(scope="module")
def handle():
    return register_ifunc(Context("src"), "uvm_affine")


def _ext(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((S, 1, T, T)) * 0.1).astype(np.float32)


def _land(frames):
    """Deposit ``frames`` [S, N, W] into an empty CPU mailbox, shifted by
    SHIFT shards; returns (mailbox, the frames as they landed).  A slot
    with magic 0 does not deposit (the put is slot-masked), so garbage
    behind magic 0 is written in place, as stale words would lie there."""
    mb = make_deposit(S)(empty_mailbox(S, N, frames.shape[-1], device="cpu"),
                         convert.mailbox_from_numpy(frames, "cpu"), SHIFT)
    arrived = np.roll(frames, SHIFT, axis=0)
    stale = arrived[..., 0] == 0
    assert not convert.mailbox_to_numpy(mb)[stale].any()
    mb[torch.from_numpy(stale)] = convert.mailbox_from_numpy(
        arrived[stale], "cpu")
    np.testing.assert_array_equal(convert.mailbox_to_numpy(mb), arrived)
    return mb, arrived


def _singleton_ring(nt, seed):
    """12 frames through the reference's packer: READY (full and short,
    the short one's trailer inside the first body tile), INFLIGHT, EMPTY
    (zeros, garbage behind magic 0) and BAD (check word, fw past the slot
    as 0xFFFFFFF0, bad magic)."""
    rng = np.random.default_rng(seed)
    body = nt * T * T
    W = HDR_WORDS + body + 1
    kinds = ["ready", "inflight", "zero", "corrupt", "short", "garbage",
             "fw_huge", "ready", "bad_magic", "inflight", "ready", "zero"]
    frames = np.zeros((S * N, W), np.uint32)
    for i, kind in enumerate(kinds):
        pay = rng.standard_normal(body).astype(np.float32)
        if kind == "garbage":
            frames[i] = rng.integers(0, 2 ** 32, W, dtype=np.uint32)
            frames[i, 0] = 0
        elif kind == "short":
            frames[i] = ref_pack_word_frame(pay[:T * T // 2 + 3], W)
        elif kind != "zero":
            frames[i] = ref_pack_word_frame(pay, W, corrupt=kind == "corrupt",
                                            no_trailer=kind == "inflight")
        if kind == "fw_huge":
            frames[i, 1] = 0xFFFFFFF0
            frames[i, 4] = frames[i, 0] ^ frames[i, 1] ^ frames[i, 2] ^ \
                frames[i, 3]
        if kind == "bad_magic":
            frames[i, 0] ^= 0x100
    return frames.reshape(S, N, W)


def _agg_ring(nt, bound, seed):
    """12 containers of K = 4 through the reference's packer: full,
    partial, a poisoned sub, a NACKed hash, a corrupt container, no
    trailer, empty, garbage behind magic 0, n_subs = 0xFFFFFFFF, and
    containers whose matching hash has the high bit set."""
    rng = np.random.default_rng(seed)
    body = nt * T * T
    W = HDR_WORDS + 2 * K + K * body + 1
    b = bound or 0xC0FFEE01                 # the hash a matching sub carries
    other = 0x9000ABCD

    def pack(n, hashes=None, **kw):
        pays = list(rng.standard_normal((n, body)).astype(np.float32))
        return ref_pack_agg_word_frame(pays, hashes or [b] * n, K, body, W,
                                       **kw)

    frames = np.zeros((S * N, W), np.uint32)
    frames[0] = pack(K)                                   # full
    frames[1] = pack(2)                                   # partial
    frames[2] = pack(3, corrupt_sub=1)                    # a poisoned sub
    frames[3] = pack(3, [b, other, HIGH_BIT])             # NACKed hashes
    frames[4] = pack(2, corrupt=True)                     # corrupt container
    frames[5] = pack(K, no_trailer=True)                  # no trailer
    frames[7] = rng.integers(0, 2 ** 32, W, dtype=np.uint32)
    frames[7, 0] = 0                                      # garbage, magic 0
    frames[8] = pack(1)
    frames[8, 1] = 0xFFFFFFFF                             # n_subs past K
    frames[8, 4] = AGG_MAGIC ^ 0xFFFFFFFF ^ 3
    frames[9] = pack(K, [HIGH_BIT] * K)
    frames[10] = pack(1, no_trailer=True)
    frames[11] = pack(2, [HIGH_BIT, b])
    return frames.reshape(S, N, W)


def _check_kept(cleared, arrived, status):
    """READY and BAD slots zeroed, INFLIGHT and EMPTY left bit for bit."""
    done = (status == READY) | (status == BAD)
    np.testing.assert_array_equal(convert.mailbox_to_numpy(cleared),
                                  np.where(done[..., None], 0, arrived))


def _positive_zero(t):
    return not t.contiguous().view(torch.int32).any()


@pytest.mark.parametrize("entry", ["sweep_plain", "make_sweep"])
@pytest.mark.parametrize("nt", [1, 2])
def test_singleton_sweep_matches_reference(handle, nt, entry):
    frames = _singleton_ring(nt, seed=nt)
    mb, arrived = _land(frames)
    ext = _ext(nt)
    prog = deserialize_uvm(handle.lib.code)
    if entry == "make_sweep":
        sweep = make_sweep(prog, nt)
    else:
        def sweep(m, e):
            return sweep_plain(prog, m, e, nt)
    W = arrived.shape[-1]
    status, out, cleared = sweep(mb, torch.from_numpy(ext))
    assert cleared is mb
    want = REF.ring_poll_ref(arrived.reshape(S * N, W)).reshape(S, N)
    np.testing.assert_array_equal(status.numpy(), want)
    assert sorted(set(want.reshape(-1).tolist())) == [EMPTY, READY,
                                                      INFLIGHT, BAD]
    rprog = RCG.deserialize_uvm(handle.lib.code)
    for s in range(S):
        for j in range(N):
            if want[s, j] == READY:
                body = arrived[s, j, HDR_WORDS:HDR_WORDS + nt * T * T]
                np.testing.assert_allclose(
                    out[s, j].numpy(), REF.ifunc_vm_ref(
                        rprog, body.view(np.float32).reshape(nt, T, T),
                        ext[s]), **TOL)
            else:
                assert _positive_zero(out[s, j])
    _check_kept(cleared, arrived, want)

    # a second sweep of the cleared ring finds nothing READY
    again, out2, _ = sweep(mb, torch.from_numpy(ext))
    assert not (again == READY).any() and _positive_zero(out2)
    np.testing.assert_array_equal(again.numpy(),
                                  np.where(want == INFLIGHT, INFLIGHT, EMPTY))

    # the INFLIGHT frames' trailers written in place: they sweep READY
    inflight = np.argwhere(want == INFLIGHT)
    for s, j in inflight:
        fw = int(arrived[s, j, 1])
        mb[s, j, HDR_WORDS + fw] = int(np.uint32(TRAILER).view(np.int32))
    late, out3, _ = sweep(mb, torch.from_numpy(ext))
    assert (late.numpy() == np.where(want == INFLIGHT, READY, EMPTY)).all()
    for s, j in inflight:
        body = arrived[s, j, HDR_WORDS:HDR_WORDS + nt * T * T]
        np.testing.assert_allclose(
            out3[s, j].numpy(), REF.ifunc_vm_ref(
                rprog, body.view(np.float32).reshape(nt, T, T), ext[s]),
            **TOL)
    _check_kept(mb, arrived, np.where(want == EMPTY, EMPTY, READY))


@pytest.mark.parametrize("entry", ["agg_sweep_plain", "make_agg_sweep"])
@pytest.mark.parametrize("bound", [0, HIGH_BIT])
@pytest.mark.parametrize("nt", [1, 2])
def test_agg_sweep_matches_reference(handle, nt, bound, entry):
    frames = _agg_ring(nt, bound, seed=10 * nt + (bound > 0))
    mb, arrived = _land(frames)
    ext = _ext(nt + 5)
    prog = deserialize_uvm(handle.lib.code)
    if entry == "make_agg_sweep":
        sweep = make_agg_sweep(prog, K, nt, bound_hash=bound)
    else:
        def sweep(m, e):
            return agg_sweep_plain(prog, m, e, K, nt, bound_hash=bound)
    W = arrived.shape[-1]
    status, sub, out, cleared = sweep(mb, torch.from_numpy(ext))
    assert cleared is mb
    flat = arrived.reshape(S * N, W)
    want_st, want_sub = ref_agg_ring_poll(
        jnp.asarray(flat[:, :HDR_WORDS + 2 * K]), jnp.asarray(flat[:, -1:]),
        jnp.asarray([bound], jnp.uint32), interpret=True)
    want_st = np.asarray(want_st).reshape(S, N)
    want_sub = np.asarray(want_sub).reshape(S, N, K)
    np.testing.assert_array_equal(status.numpy(), want_st)
    np.testing.assert_array_equal(sub.numpy(), want_sub)
    seen = set(want_sub.reshape(-1).tolist())
    assert {1, 3} <= seen and (4 in seen) == bool(bound)  # READY, BAD, NACK
    assert sorted(set(want_st.reshape(-1).tolist())) == [EMPTY, READY,
                                                         INFLIGHT, BAD]
    assert out.shape == (S, N, K, nt, T, T)
    rprog = RCG.deserialize_uvm(handle.lib.code)
    off = HDR_WORDS + 2 * K
    for s in range(S):
        for j in range(N):
            for i in range(K):
                if want_sub[s, j, i] != SUB_READY:
                    assert _positive_zero(out[s, j, i])
                    continue
                body = arrived[s, j, off + i * nt * T * T:
                               off + (i + 1) * nt * T * T]
                np.testing.assert_allclose(
                    out[s, j, i].numpy(), REF.ifunc_vm_ref(
                        rprog, body.view(np.float32).reshape(nt, T, T),
                        ext[s]), **TOL)
    _check_kept(cleared, arrived, want_st)

    again, sub2, out2, _ = sweep(mb, torch.from_numpy(ext))
    assert not (again == READY).any() and not sub2.any()
    assert _positive_zero(out2)

    # the withheld trailers written in place: those containers run
    for s, j in np.argwhere(want_st == INFLIGHT):
        mb[s, j, -1] = int(np.uint32(TRAILER).view(np.int32))
    late, sub3, out3, _ = sweep(mb, torch.from_numpy(ext))
    assert (late.numpy() == np.where(want_st == INFLIGHT, READY,
                                     EMPTY)).all()
    assert int((sub3 == SUB_READY).sum()) > 0
    _check_kept(mb, arrived, np.where(want_st == EMPTY, EMPTY, READY))


@pytest.mark.parametrize("agg_k", [0, K])
def test_sweep_wrapper_on_cpu_takes_the_plain_version(handle, agg_k):
    """ifunc_vm_sweep / ifunc_vm_agg_sweep on CPU tensors give the plain
    version's statuses, outputs and cleared ring, and launch nothing."""
    frames = (_agg_ring(1, 0, 3) if agg_k else _singleton_ring(1, 3))
    W = frames.shape[-1]
    a = convert.mailbox_from_numpy(frames, "cpu").view(S * N, W)
    b = a.clone()
    prog = deserialize_uvm(handle.lib.code)
    ext = torch.from_numpy(_ext(2))
    off, per = HDR_WORDS + 2 * agg_k, max(agg_k, 1)
    counter = ifunc_vm_agg_sweep if agg_k else ifunc_vm_sweep
    before = counter.launches
    if agg_k:
        got = ifunc_vm_agg_sweep(prog, a, agg_k, off, per, ext)
    else:
        got = ifunc_vm_sweep(prog, a, off, per, ext)
    want = ifunc_vm_sweep_plain(prog, b, off, per, ext, agg_k=agg_k)
    assert counter.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(a, b)


def test_sweep_wrappers_refuse_what_the_kernel_cannot_take(handle):
    prog = deserialize_uvm(handle.lib.code)
    ext = torch.zeros(1, T, T)
    W = HDR_WORDS + 2 * K + K * T * T + 1
    mb = torch.zeros(3, W, dtype=torch.int32)
    with pytest.raises(TypeError):
        ifunc_vm_sweep(prog, mb.long(), HDR_WORDS, 1, ext)
    with pytest.raises(ValueError, match="header"):
        ifunc_vm_sweep(prog, mb, HDR_WORDS - 1, 1, ext)    # over the header
    with pytest.raises(ValueError, match="header"):
        ifunc_vm_agg_sweep(prog, mb, K, HDR_WORDS + 2 * K - 1, K, ext)
    with pytest.raises(ValueError, match="do not fit"):
        ifunc_vm_sweep(prog, mb, HDR_WORDS, 5, ext)         # past the slot
    with pytest.raises(ValueError, match="split"):
        ifunc_vm_agg_sweep(prog, mb, K, HDR_WORDS + 2 * K, 3, ext)
    with pytest.raises(ValueError, match="agg_k"):
        ifunc_vm_agg_sweep(prog, mb, 0, HDR_WORDS, 1, ext)
