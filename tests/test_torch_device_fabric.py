"""The port's device lane end to end on the CPU — Dispatcher -> word-frame
deposit -> ring_poll + ifunc_vm sweep — held against the JAX package:
frames packed by its ``pack_word_frame``, statuses by its ``ring_poll_ref``,
outputs by its ``ifunc_vm_ref``."""

import numpy as np
import pytest
import torch

from repro.core import codegen as RCG
from repro.core.device_mailbox import pack_word_frame as ref_pack_word_frame
from repro.kernels import ref as REF
from repro.kernels.ring_poll import BAD as REF_BAD, READY as REF_READY
from repro_torch import convert
from repro_torch.core import Context, ifunc_msg_create, register_ifunc
from repro_torch.core import frame as F
from repro_torch.core.codegen import deserialize_uvm
from repro_torch.core.device_mailbox import (empty_mailbox, make_deposit,
                                             make_sweep)
from repro_torch.transport import (DeviceMeshFabric, Dispatcher,
                                   ProgressEngine, TransportError)

T = 128
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def handle():
    return register_ifunc(Context("src"), "uvm_affine")


def _prog(handle):
    return deserialize_uvm(handle.lib.code)


def _ref_prog(handle):
    return RCG.deserialize_uvm(handle.lib.code)


def _dispatcher(handle, n_shards, W, *, shift=0, n_slots=2, n_tiles=1,
                engine=None):
    d = Dispatcher(handle.ctx,
                   engine or ProgressEngine(inflight_window="trailer"))
    d.add_peer("mesh", DeviceMeshFabric(n_shards, shift=shift, device="cpu"),
               None, n_slots=n_slots, slot_size=(n_tiles * T * T + 6) * 4,
               prog=_prog(handle), n_tiles=n_tiles,
               externals=np.broadcast_to(W, (n_shards, 1, T, T)))
    return d


def test_slice_end_to_end_against_reference(handle):
    """8 shards, shift 1: shard d runs the frame staged at shard d - 1."""
    S, NT = 8, 2
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((T, T)) * 0.05).astype(np.float32)
    pays = rng.standard_normal((S, NT, T, T)).astype(np.float32)
    d = _dispatcher(handle, S, W, shift=1, n_tiles=NT)
    for p in pays:
        assert d.send("mesh", ifunc_msg_create(handle, p))
    assert d.drain() == S
    mb = d.peers["mesh"].rings[0].mailbox
    res = d.peers["mesh"].target_args["results"]
    assert len(res) == S and mb.results == res
    for s in range(S):
        ref = REF.ifunc_vm_ref(_ref_prog(handle), pays[(s - 1) % S], W[None])
        np.testing.assert_allclose(res[s].numpy(), ref, rtol=1e-4, atol=1e-5)
    assert not convert.mailbox_to_numpy(mb._mb).any()     # cleared
    st = d.per_peer_stats()["mesh"]
    assert (st["sent"], st["slim_sent"], st["delivered"], st["rejected"],
            st["credits"]) == (S, S, S, 0, 2 * S)


def test_device_fabric_through_dispatcher(handle):
    """Port of tests/test_transport.py::test_device_fabric_through_dispatcher."""
    W = np.eye(T, dtype=np.float32) * 0.5
    d = _dispatcher(handle, 1, W)
    x = np.random.default_rng(0).standard_normal((1, T, T)).astype(np.float32)
    assert d.send("mesh", ifunc_msg_create(handle, x))
    assert d.drain() == 1
    res = d.peers["mesh"].target_args["results"]
    assert len(res) == 1
    np.testing.assert_allclose(res[0].numpy()[0], np.maximum(x[0] @ W, 0),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_shards", [1, 8])
def test_device_fabric_multiple_generations_no_loss(handle, n_shards):
    """Port of tests/test_transport.py::
    test_device_fabric_multiple_generations_no_loss: two flushes without a
    sweep between them must not clobber the first generation."""
    W = np.eye(T, dtype=np.float32)
    d = _dispatcher(handle, n_shards, W, n_slots=4)
    xs = np.random.default_rng(1).standard_normal(
        (3, 1, T, T)).astype(np.float32)
    assert d.send("mesh", ifunc_msg_create(handle, xs[0]))
    d.flush()                                  # generation 1 deposited
    for x in xs[1:]:
        assert d.send("mesh", ifunc_msg_create(handle, x))
    d.flush()                                  # generation 2: keeps gen 1
    assert d.drain() == 3
    res = d.peers["mesh"].target_args["results"]
    assert len(res) == 3
    got = sorted(float(r.sum()) for r in res)
    want = sorted(float(np.maximum(x, 0).sum()) for x in xs)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    peer = d.peers["mesh"]
    assert peer.credits == 4 * peer.rings[0].mailbox.n_shards


def test_second_generation_keeps_unswept_slots_in_place(handle):
    """A deposit lands only the slots it wrote; the first generation's
    frames stay bit-identical in the ring until the sweep."""
    S = 4
    W = np.eye(T, dtype=np.float32)
    d = _dispatcher(handle, S, W, shift=1, n_slots=2)
    mb = d.peers["mesh"].rings[0].mailbox
    xs = np.random.default_rng(2).standard_normal(
        (2 * S, 1, T, T)).astype(np.float32)
    for x in xs[:S]:
        assert d.send("mesh", ifunc_msg_create(handle, x))
    d.flush()
    gen1 = convert.mailbox_to_numpy(mb._mb)
    for x in xs[S:]:
        assert d.send("mesh", ifunc_msg_create(handle, x))
    d.flush()
    both = convert.mailbox_to_numpy(mb._mb)
    np.testing.assert_array_equal(both[:, 0], gen1[:, 0])
    assert (both[:, 1, 0] != 0).all()
    assert d.drain() == 2 * S
    res = d.peers["mesh"].target_args["results"]
    assert len(res) == 2 * S
    for s in range(S):                      # sweep order: shard, then slot
        for j in range(2):
            np.testing.assert_allclose(res[2 * s + j].numpy(),
                                       np.maximum(xs[S * j + (s - 1) % S], 0),
                                       rtol=1e-5)


def test_deposit_and_sweep_match_reference_semantics(handle):
    """Statuses against ring_poll_ref on the rolled frames; READY outputs
    against ifunc_vm_ref; the cleared ring keeps exactly the INFLIGHT and
    EMPTY slots; an unswept slot survives a later deposit."""
    S, N, NT, shift = 4, 3, 1, 3
    W_words = 5 + NT * T * T + 1
    rng = np.random.default_rng(7)
    pays = rng.standard_normal((S, N, NT * T * T)).astype(np.float32)
    frames = np.zeros((S, N, W_words), np.uint32)
    for s in range(S):
        frames[s, 0] = ref_pack_word_frame(pays[s, 0], W_words)
        frames[s, 1] = ref_pack_word_frame(pays[s, 1], W_words,
                                           no_trailer=True)
        if s % 2:
            frames[s, 2] = ref_pack_word_frame(pays[s, 2], W_words,
                                               corrupt=True)
    mb = empty_mailbox(S, N, W_words, device="cpu")
    mb = make_deposit(S)(mb, convert.mailbox_from_numpy(frames, CPU), shift)
    arrived = np.roll(frames, shift, axis=0)
    np.testing.assert_array_equal(convert.mailbox_to_numpy(mb), arrived)
    ext = (rng.standard_normal((S, 1, T, T)) * 0.1).astype(np.float32)
    status, out, cleared = make_sweep(_prog(handle), NT)(
        mb, torch.from_numpy(ext))
    want = REF.ring_poll_ref(arrived.reshape(S * N, W_words)).reshape(S, N)
    np.testing.assert_array_equal(status.numpy(), want)
    for s in range(S):
        for j in range(N):
            if want[s, j] == REF_READY:
                ref = REF.ifunc_vm_ref(_ref_prog(handle),
                                       pays[(s - shift) % S, j]
                                       .reshape(NT, T, T), ext[s])
                np.testing.assert_allclose(out[s, j].numpy(), ref,
                                           rtol=1e-4, atol=1e-5)
            else:
                assert not out[s, j].numpy().any()
    done = (want == REF_READY) | (want == REF_BAD)
    keep = np.where(done[..., None], 0, arrived)
    np.testing.assert_array_equal(convert.mailbox_to_numpy(cleared), keep)
    again = make_deposit(S)(cleared, torch.zeros_like(cleared), 1)
    np.testing.assert_array_equal(convert.mailbox_to_numpy(again), keep)


def test_corrupt_frame_rejected_and_partial_put_in_progress_then_ok(handle):
    S = 2
    W = np.eye(T, dtype=np.float32)
    d = _dispatcher(handle, S, W, shift=1)
    peer = d.peers["mesh"]
    mb = peer.rings[0].mailbox
    x = np.random.default_rng(3).standard_normal((1, T, T)).astype(np.float32)
    assert d.send("mesh", ifunc_msg_create(handle, x))
    shard, idx = mb.slot_coords(0)
    mb._staged[shard, idx, 4] ^= 1              # flip the check word
    assert d.drain() == 1
    assert peer.stats["rejected"] == 1
    assert peer.target_args.get("results", []) == []
    # the generation lands before the flush completes the trailer
    assert d.send("mesh", ifunc_msg_create(handle, x))
    mb.publish()
    assert d.poll() == 0
    assert peer.stats["inflight_polls"] == 1
    assert peer.credits == 2 * S - 1
    assert d.drain() == 1
    np.testing.assert_allclose(peer.target_args["results"][0].numpy(),
                               np.maximum(x, 0), rtol=1e-5)
    assert peer.credits == 2 * S


def test_backpressure_when_credits_run_out(handle):
    d = _dispatcher(handle, 2, np.eye(T, dtype=np.float32), n_slots=1)
    x = np.zeros((1, T, T), np.float32)
    assert d.send("mesh", ifunc_msg_create(handle, x))
    assert d.send("mesh", ifunc_msg_create(handle, x))
    assert not d.send("mesh", ifunc_msg_create(handle, x))
    assert d.peers["mesh"].stats["backpressure"] == 1
    assert d.drain() == 2
    assert d.send("mesh", ifunc_msg_create(handle, x))


def test_device_lane_refusals(handle):
    fab = DeviceMeshFabric(2, device="cpu")
    with pytest.raises(TransportError, match="aggregate"):
        fab.open_mailbox(None, 2, 1 << 20, prog=_prog(handle), agg_k=4)
    with pytest.raises(TransportError):
        fab.open_mailbox(None, 2, 1 << 20)               # no program bound
    with pytest.raises(TransportError):                  # slot too small
        fab.open_mailbox(None, 2, 1024, prog=_prog(handle))
    d = _dispatcher(handle, 2, np.eye(T, dtype=np.float32))
    pybc = F.pack_frame("f", b"code", np.zeros(T * T, np.float32).tobytes(),
                        F.CodeKind.PYBC)
    with pytest.raises(TransportError, match="UVM"):
        d.send("mesh", pybc)
    with pytest.raises(TransportError, match="words"):
        d.send("mesh", ifunc_msg_create(handle, np.zeros((1, T, T // 2),
                                                         np.float32)))


def test_device_fabric_without_cuda_raises(monkeypatch):
    """The card is the default: with no CUDA the fabric refuses rather than
    quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceMeshFabric(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        empty_mailbox(1, 1, 8)


def test_convert_round_trips():
    rng = np.random.default_rng(11)
    words = rng.integers(0, 2 ** 32, (2, 3, 17), dtype=np.uint32)
    words[0, 0, 0] = 0xD0E1F2A3
    t = convert.mailbox_from_numpy(words, "cpu")
    assert t.dtype == torch.int32 and int(t[0, 0, 0]) < 0
    back = convert.mailbox_to_numpy(t)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, words)
    with pytest.raises(TypeError):
        convert.mailbox_from_numpy(words.astype(np.int64), "cpu")
    ext = rng.standard_normal((2, 1, T, T)).astype(np.float32)
    np.testing.assert_array_equal(
        convert.externals_from_numpy(ext, "cpu").numpy(), ext)
    with pytest.raises(ValueError):
        convert.externals_from_numpy(ext[0], "cpu")
    rp = RCG.assemble([("loadp", 0), ("loade", 1, 2), ("scale", 1, 1, 0, 0.5),
                       ("store", 0, 1)], ("a", "b", "c"))
    pp = convert.uvm_program_from_arrays(rp.opcode, rp.dst, rp.a, rp.b,
                                         rp.imm, rp.n_ext, rp.symbols)
    assert RCG.serialize_uvm(rp) == RCG.serialize_uvm(pp)
