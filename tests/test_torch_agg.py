"""The port's aggregate device lane on the CPU — coalesced FLAG_AGG
containers -> agg word frames -> agg_ring_poll + one ifunc_vm over every
sub-record — held against the JAX package: container bytes by its
``seal_agg_frame``, word frames by its ``pack_agg_word_frame``, statuses by
its ``agg_ring_poll`` in interpret mode, staged words by its dispatcher,
outputs by its ``ifunc_vm_ref``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Context as RefContext
from repro.core import codegen as RCG
from repro.core import frame as RF
from repro.core import ifunc_msg_create as ref_ifunc_msg_create
from repro.core import register_ifunc as ref_register_ifunc
from repro.core.device_mailbox import \
    pack_agg_word_frame as ref_pack_agg_word_frame
from repro.kernels import ref as REF
from repro.kernels.agg_poll import agg_ring_poll as ref_agg_ring_poll
from repro.parallel.sharding import make_mesh
from repro.transport import Dispatcher as RefDispatcher
from repro.transport import ProgressEngine as RefProgressEngine
from repro.transport.device_fabric import DeviceMeshFabric as RefMeshFabric
from repro_torch import convert
from repro_torch.core import Context, ifunc_msg_create, register_ifunc
from repro_torch.core import frame as F
from repro_torch.core.codegen import deserialize_uvm
from repro_torch.core.device_mailbox import (empty_mailbox, make_agg_sweep,
                                             make_deposit,
                                             pack_agg_word_frame)
from repro_torch.kernels.agg_poll import (AGG_MAGIC, SUB_BAD, SUB_EMPTY,
                                          SUB_NACK, SUB_READY, SUB_SALT,
                                          agg_ring_poll, agg_ring_poll_plain)
from repro_torch.kernels.ring_poll import (BAD, EMPTY, HDR_WORDS, INFLIGHT,
                                           READY, TRAILER)
from repro_torch.transport import (DeviceMeshFabric, Dispatcher,
                                   ProgressEngine, TransportError)
from test_torch_cuda import mixed_agg_ring

T = 128
K = 4
TOL_VM = dict(rtol=2e-5, atol=2e-5)     # the μVM against its oracle
TOL_PATH = dict(rtol=1e-4, atol=1e-5)   # a path's results against relu(x @ W)
LANES = [(1, 0), (8, 1)]                # (shards, shift)


@pytest.fixture(scope="module")
def handle():
    return register_ifunc(Context("src"), "uvm_affine")


def _payloads(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, T, T)).astype(np.float32)
            for _ in range(n)]


def _weights(n_shards):
    if n_shards == 1:
        return np.eye(T, dtype=np.float32)[None] * 0.5
    rng = np.random.default_rng(100 + n_shards)
    return (rng.standard_normal((n_shards, T, T)) * 0.05).astype(np.float32)


def _dispatcher(handle, n_shards=1, shift=0, *, agg_k=K, n_slots=2,
                prog_name="bind", engine=None, max_subs=K,
                max_sub_bytes=128 << 10):
    """A port Dispatcher with one agg-bound mesh lane running uvm_affine
    (relu(x @ W[s]) on shard s), as the reference's tests build it."""
    W = _weights(n_shards)
    d = Dispatcher(handle.ctx,
                   engine or ProgressEngine(inflight_window="trailer"))
    d.set_coalescing(True, max_subs=max_subs, max_sub_bytes=max_sub_bytes)
    d.add_peer("mesh", DeviceMeshFabric(n_shards, shift=shift, device="cpu"),
               None, n_slots=n_slots, slot_size=8 << 20,
               prog=deserialize_uvm(handle.lib.code), externals=W[:, None],
               agg_k=agg_k,
               prog_name=handle.lib.name if prog_name == "bind"
               else prog_name)
    return d, W


def _want(handle, x, W, landed):
    return REF.ifunc_vm_ref(RCG.deserialize_uvm(handle.lib.code), x,
                            W[landed])


def _landed(d, tail):
    """The shard a send at produce index ``tail`` lands on."""
    mb = d.peers["mesh"].rings[0].mailbox
    return (mb.slot_coords(tail)[0] + mb.shift) % mb.n_shards


# -- the container wire format -----------------------------------------------

def _sub_specs(seed):
    rng = np.random.default_rng(seed)
    names = ["uvm_affine", "a", "counter_bump", "x" * 31]
    return [(names[int(rng.integers(0, len(names)))],
             int(rng.integers(1, 4)),
             rng.integers(0, 256, 16, dtype=np.uint8).tobytes(),
             int(rng.integers(0, 2 ** 63)) if rng.random() < 0.7 else 0,
             rng.integers(0, 256, int(rng.integers(0, 600)),
                          dtype=np.uint8).tobytes())
            for _ in range(int(rng.integers(1, 40)))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_agg_container_bytes_match_reference(seed):
    specs = _sub_specs(seed)
    port = [F.AggSub(n, F.CodeKind(k), dg, c, p) for n, k, dg, c, p in specs]
    ref = [RF.AggSub(n, RF.CodeKind(k), dg, c, p) for n, k, dg, c, p in specs]
    bp, br = bytearray(1 << 16), bytearray(1 << 16)
    n = F.seal_agg_frame(bp, port, kind=F.CodeKind.UVM)
    assert n == RF.seal_agg_frame(br, ref, kind=RF.CodeKind.UVM)
    assert bp[:n] == br[:n]
    assert n == F.agg_frame_len(port) == RF.agg_frame_len(ref)
    hdr = F.peek_header(bp)
    assert hdr.is_agg and hdr.name == F.AGG_NAME and hdr.frame_len == n
    _, payload = F.frame_sections(bp, hdr)
    batch = F.parse_agg(payload)
    assert batch.n == len(specs)
    assert [(s.name, int(s.kind), s.digest, s.corr_id, bytes(s.payload))
            for s in F.unpack_agg(payload)] == specs
    rbatch = RF.parse_agg(RF.frame_sections(br, RF.peek_header(br))[1])
    assert (batch.names, batch.name_idx, batch.corrs, batch.starts,
            batch.plens) == (rbatch.names, rbatch.name_idx, rbatch.corrs,
                             rbatch.starts, rbatch.plens)


def test_agg_container_streamed_pack_matches_sealed():
    """begin_agg / agg_sub_hdr / finish_agg build the same bytes as
    seal_agg_frame, as the dispatcher's direct slab pack relies on."""
    specs = [("uvm_affine", 3, b"d" * 16, 7 * i, bytes([i]) * (40 + i))
             for i in range(5)]
    sealed = bytearray(4096)
    n = F.seal_agg_frame(sealed, [F.AggSub(nm, F.CodeKind(k), dg, c, p)
                                  for nm, k, dg, c, p in specs],
                         kind=F.CodeKind.UVM)
    buf = bytearray(4096)
    view = F.frame_payload_view(buf, 0, len(buf) - F.HEADER_LEN
                                - F.TRAILER_LEN)
    off = start = F.begin_agg(view, ["uvm_affine"])
    hdrs = []
    for nm, k, dg, c, p in specs:
        view[off:off + len(p)] = p
        off += len(p)
        hdrs.append(F.agg_sub_hdr(0, F.CodeKind(k), dg, c, len(p)))
    plen = F.finish_agg(view, start, off, hdrs)
    m = F.seal_frame(buf, F.AGG_NAME, b"", F.CodeKind.UVM, plen,
                     digest=F.NO_DIGEST, flags=F.FLAG_AGG)
    assert buf[:m] == sealed[:n]


def test_agg_container_corruption_rejected_whole():
    subs = [F.AggSub(nm, F.CodeKind(k), dg, c, p)
            for nm, k, dg, c, p in _sub_specs(4)]
    buf = bytearray(1 << 16)
    n = F.seal_agg_frame(buf, subs)
    _, payload = F.frame_sections(buf, F.peek_header(buf))
    tbl_at = len(payload) - 4 - F.AGG_SUB_OVERHEAD      # last table row
    for at in (0, 3, tbl_at + 1, len(payload) - 1):
        bad = bytearray(payload)
        bad[at] ^= 0x40
        with pytest.raises(F.FrameError):
            F.parse_agg(bad)
        with pytest.raises(RF.FrameError):
            RF.parse_agg(bad)
    with pytest.raises(F.FrameError):
        F.seal_agg_frame(bytearray(n - 1), subs)


# -- the word frame and the poll kernel --------------------------------------

@pytest.mark.parametrize("variant", ["plain", "corrupt", "corrupt_sub",
                                     "no_trailer"])
def test_pack_agg_word_frame_matches_reference(variant):
    body_words = 2 * T * T
    slot_words = HDR_WORDS + 2 * K + K * body_words + 1
    rng = np.random.default_rng(5)
    pays = [rng.standard_normal(body_words).astype(np.float32)
            for _ in range(3)]
    hashes = [0xF00DBEEF, 0x1234, F.fletcher32(b"uvm_affine")]
    kw = {"plain": {}, "corrupt": {"corrupt": True},
          "corrupt_sub": {"corrupt_sub": 1},
          "no_trailer": {"no_trailer": True}}[variant]
    got = pack_agg_word_frame(pays, hashes, K, body_words, slot_words, **kw)
    want = ref_pack_agg_word_frame(pays, hashes, K, body_words, slot_words,
                                   **kw)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def _split(slots, k):
    t = convert.mailbox_from_numpy(slots, "cpu")
    return t[:, :HDR_WORDS + 2 * k], t[:, -1:]


@pytest.mark.parametrize("k", [4, 16])
@pytest.mark.parametrize("bound", [0x8000ABCD, 0])
def test_agg_ring_poll_plain_matches_reference(k, bound):
    slots = mixed_agg_ring(k, 8, bound)
    hdr, tr = _split(slots, k)
    st, sub = agg_ring_poll_plain(hdr, tr, bound)
    want_st, want_sub = ref_agg_ring_poll(
        jnp.asarray(slots[:, :HDR_WORDS + 2 * k]), jnp.asarray(slots[:, -1:]),
        jnp.asarray([bound], jnp.uint32), interpret=True)
    np.testing.assert_array_equal(st.numpy(), np.asarray(want_st))
    np.testing.assert_array_equal(sub.numpy(), np.asarray(want_sub))
    assert st.tolist() == [EMPTY, READY, READY, READY, BAD, INFLIGHT, BAD,
                           BAD, READY, EMPTY, BAD, READY]
    nack = SUB_READY if bound == 0 else SUB_NACK
    assert sub[1].tolist() == [SUB_READY] * k
    assert sub[2].tolist() == [SUB_READY, nack] + [SUB_EMPTY] * (k - 2)
    assert sub[3].tolist() == ([SUB_READY, SUB_BAD, SUB_READY]
                               + [SUB_EMPTY] * (k - 3))
    assert sub[8].tolist()[:3] == [nack, SUB_READY, nack]
    assert sub[11].tolist() == [SUB_READY] + [SUB_EMPTY] * (k - 1)
    for i in (0, 4, 5, 6, 7, 9, 10):
        assert sub[i].tolist() == [SUB_EMPTY] * k


def test_agg_ring_poll_wrapper_takes_strided_views_and_checks():
    k = 4
    slots = mixed_agg_ring(k, 8, 0x8000ABCD)
    mb = convert.mailbox_from_numpy(slots, "cpu")
    before = agg_ring_poll.launches
    st, sub = agg_ring_poll(mb[:, :HDR_WORDS + 2 * k], mb[:, -1:],
                            0x8000ABCD)
    assert agg_ring_poll.launches == before       # the CPU runs the plain
    want = agg_ring_poll_plain(*_split(slots, k), 0x8000ABCD)
    assert torch.equal(st, want[0]) and torch.equal(sub, want[1])
    with pytest.raises(TypeError):
        agg_ring_poll(mb[:, :HDR_WORDS + 2 * k].float(), mb[:, -1:], 0)
    with pytest.raises(ValueError):                # 5 + 2K + 1 words
        agg_ring_poll(mb[:, :HDR_WORDS + 2 * k + 1], mb[:, -1:], 0)
    with pytest.raises(ValueError):
        agg_ring_poll(mb[:, :HDR_WORDS + 2 * k], mb[:-1, -1:], 0)


# -- the sweep ---------------------------------------------------------------

def test_agg_deposit_and_sweep_match_reference_composition(handle):
    """Statuses against the reference's agg_ring_poll on the rolled
    containers; outputs against ifunc_vm_ref over the same bodies with
    non-READY subs zeroed; the cleared ring keeps exactly the INFLIGHT and
    EMPTY slots."""
    S, N, NT, k, shift = 2, 3, 1, 4, 1
    body_words = NT * T * T
    W = HDR_WORDS + 2 * k + k * body_words + 1
    bound = F.fletcher32(b"uvm_affine")
    rng = np.random.default_rng(8)
    pays = rng.standard_normal((S, N, k, body_words)).astype(np.float32)
    frames = np.zeros((S, N, W), np.uint32)
    frames[0, 0] = pack_agg_word_frame(list(pays[0, 0]), [bound] * k, k,
                                       body_words, W)
    frames[0, 1] = pack_agg_word_frame(list(pays[0, 1, :3]),
                                       [bound, 0x77, bound], k, body_words,
                                       W, corrupt_sub=2)
    frames[0, 2] = pack_agg_word_frame(list(pays[0, 2, :2]), [bound] * 2, k,
                                       body_words, W, no_trailer=True)
    frames[1, 0] = pack_agg_word_frame(list(pays[1, 0, :2]), [bound] * 2, k,
                                       body_words, W, corrupt=True)
    frames[1, 2] = pack_agg_word_frame(list(pays[1, 2, :1]), [bound], k,
                                       body_words, W)
    mb = make_deposit(S)(empty_mailbox(S, N, W, device="cpu"),
                         convert.mailbox_from_numpy(frames, "cpu"), shift)
    arrived = np.roll(frames, shift, axis=0)
    ext = (rng.standard_normal((S, 1, T, T)) * 0.1).astype(np.float32)
    prog = deserialize_uvm(handle.lib.code)
    status, sub, out, cleared = make_agg_sweep(prog, k, NT, bound_hash=bound)(
        mb, torch.from_numpy(ext))
    flat = arrived.reshape(S * N, W)
    want_st, want_sub = ref_agg_ring_poll(
        jnp.asarray(flat[:, :HDR_WORDS + 2 * k]), jnp.asarray(flat[:, -1:]),
        jnp.asarray([bound], jnp.uint32), interpret=True)
    np.testing.assert_array_equal(status.numpy().reshape(-1),
                                  np.asarray(want_st))
    np.testing.assert_array_equal(sub.numpy().reshape(S * N, k),
                                  np.asarray(want_sub))
    want_sub = np.asarray(want_sub).reshape(S, N, k)
    assert out.shape == (S, N, k, NT, T, T)
    rprog = RCG.deserialize_uvm(handle.lib.code)
    for s in range(S):
        for j in range(N):
            for i in range(k):
                body = arrived[s, j, HDR_WORDS + 2 * k + i * body_words:
                               HDR_WORDS + 2 * k + (i + 1) * body_words]
                want = REF.ifunc_vm_ref(rprog, body.view(np.float32)
                                        .reshape(NT, T, T), ext[s])
                if want_sub[s, j, i] != SUB_READY:
                    want = np.zeros_like(want)
                np.testing.assert_allclose(out[s, j, i].numpy(), want,
                                           **TOL_VM)
    st = np.asarray(want_st).reshape(S, N)
    done = (st == READY) | (st == BAD)
    np.testing.assert_array_equal(convert.mailbox_to_numpy(cleared),
                                  np.where(done[..., None], 0, arrived))


# -- the lane end to end: the reference's five device behaviours -------------

@pytest.mark.parametrize("n_shards,shift", LANES)
def test_agg_batch_executes(handle, n_shards, shift):
    """K coalesced sends ship as ONE container, execute in ONE sweep, and
    every result comes back right."""
    d, W = _dispatcher(handle, n_shards, shift)
    peer = d.peers["mesh"]
    xs = _payloads(3)
    assert d.send_ifunc_many("mesh", handle, xs) == 3
    assert peer.stats["agg_sent"] == 1 and peer.stats["agg_subs"] == 3
    assert d.drain() == 3
    res = peer.target_args["results"]
    assert len(res) == 3
    mb = peer.rings[0].mailbox
    assert mb.results == [res]               # one entry per container
    for r, x in zip(res, xs):
        np.testing.assert_allclose(r.numpy(), _want(handle, x, W,
                                                    _landed(d, 0)),
                                   **TOL_PATH)
    st = d.per_peer_stats()["mesh"]
    assert (st["sent"], st["delivered"], st["rejected"], st["nacks"],
            st["credits"]) == (1, 3, 0, 0, 2 * n_shards)
    assert not convert.mailbox_to_numpy(mb._mb).any()


@pytest.mark.parametrize("n_shards,shift", LANES)
def test_agg_sub_nack_full_rebuild_no_sibling_replay(handle, n_shards,
                                                     shift):
    """A hash-mismatched sub-record NACKs alone: ONLY it is rebuilt as a
    FULL singleton; its siblings' results land exactly once."""
    d, W = _dispatcher(handle, n_shards, shift)
    peer = d.peers["mesh"]
    mb = peer.rings[0].mailbox
    replies = []
    d.reply_router = lambda corr, name, value, is_err, decoded: \
        replies.append((corr, value, is_err))
    xs = _payloads(3)
    assert d.send_ifunc_many("mesh", handle, xs, corr_ids=[1, 2, 3]) == 3
    # staged, not deposited yet: a *self-consistent* wrong hash in sub 1's
    # descriptor — the program bound to this lane is not the one named
    off = HDR_WORDS + 2 * 1
    mb._staged[0, 0, off] = 0x1234
    mb._staged[0, 0, off + 1] = 0x1234 ^ SUB_SALT
    assert d.drain() == 3
    assert (peer.stats["nacks"], peer.stats["resent"]) == (1, 1)
    assert d.stats["nacks"] == 1 and not peer.resend
    res = peer.target_args["results"]
    assert len(res) == 3                     # 2 siblings + 1 rebuilt
    assert sorted(c for c, _, _ in replies) == [1, 2, 3]
    by_corr = {c: v for c, v, e in replies if not e}
    landed = {1: _landed(d, 0), 2: _landed(d, 1), 3: _landed(d, 0)}
    for corr, x in zip((1, 2, 3), xs):
        np.testing.assert_allclose(by_corr[corr].numpy(),
                                   _want(handle, x, W, landed[corr]),
                                   **TOL_PATH)
    assert peer.stats["delivered"] == 3 and peer.credits == 2 * n_shards


@pytest.mark.parametrize("n_shards,shift", LANES)
def test_agg_poisoned_sub_err_siblings_unharmed(handle, n_shards, shift):
    """A corrupt descriptor check word poisons ONE sub-record: its corr id
    resolves with an error while both siblings deliver values."""
    d, W = _dispatcher(handle, n_shards, shift)
    peer = d.peers["mesh"]
    mb = peer.rings[0].mailbox
    replies = []
    d.reply_router = lambda corr, name, value, is_err, decoded: \
        replies.append((corr, value, is_err))
    xs = _payloads(3)
    assert d.send_ifunc_many("mesh", handle, xs, corr_ids=[11, 12, 13]) == 3
    mb._staged[0, 0, HDR_WORDS + 2 * 1 + 1] ^= 1     # sub 1's check word
    d.drain()
    assert sorted(c for c, _, _ in replies) == [11, 12, 13]
    by_corr = {c: (v, e) for c, v, e in replies}
    assert by_corr[12][1] and "poisoned" in str(by_corr[12][0])
    for corr, x in ((11, xs[0]), (13, xs[2])):
        val, is_err = by_corr[corr]
        assert not is_err
        np.testing.assert_allclose(val.numpy(),
                                   _want(handle, x, W, _landed(d, 0)),
                                   **TOL_PATH)
    assert peer.stats["rejected"] == 1      # the poisoned record, not more
    assert peer.stats["replies"] == 3 and d.stats["replies"] == 3
    assert len(peer.target_args["results"]) == 2


@pytest.mark.parametrize("n_shards,shift", LANES)
def test_agg_corrupt_container_whole_reject(handle, n_shards, shift):
    """A corrupt container header rejects the WHOLE batch: nothing runs,
    every corr id resolves with the error, the slot clears and the lane
    runs a fresh batch."""
    d, W = _dispatcher(handle, n_shards, shift)
    peer = d.peers["mesh"]
    mb = peer.rings[0].mailbox
    replies = []
    d.reply_router = lambda corr, name, value, is_err, decoded: \
        replies.append((corr, value, is_err))
    xs = _payloads(3)
    assert d.send_ifunc_many("mesh", handle, xs, corr_ids=[21, 22, 23]) == 3
    mb._staged[0, 0, 4] ^= 1                # the container's check word
    assert d.drain() == 1
    assert peer.stats["rejected"] == 1 and peer.stats["delivered"] == 0
    assert peer.target_args.get("results", []) == []
    assert sorted(c for c, _, _ in replies) == [21, 22, 23]
    assert all(is_err for _, _, is_err in replies)
    assert not convert.mailbox_to_numpy(mb._mb).any()
    ys = _payloads(2, seed=9)
    assert d.send_ifunc_many("mesh", handle, ys) == 2
    assert d.drain() == 2
    res = peer.target_args["results"]
    assert len(res) == 2
    for r, y in zip(res, ys):
        np.testing.assert_allclose(r.numpy(),
                                   _want(handle, y, W, _landed(d, 1)),
                                   **TOL_PATH)


@pytest.mark.parametrize("n_shards,shift", LANES)
def test_agg_singleton_on_agg_bound_lane(handle, n_shards, shift):
    """A plain send still works on an agg-bound mailbox: it transcodes as a
    1-sub container carrying the bound hash, and its corr id is routed."""
    d, W = _dispatcher(handle, n_shards, shift)
    peer = d.peers["mesh"]
    replies = []
    d.reply_router = lambda corr, name, value, is_err, decoded: \
        replies.append((corr, value, is_err))
    x = _payloads(1, seed=5)[0]
    assert d.send("mesh", ifunc_msg_create(handle, x, corr_id=77))
    mb = peer.rings[0].mailbox
    staged = mb._staged[mb.slot_coords(0)]
    assert staged[0] == AGG_MAGIC and staged[1] == 1
    assert staged[HDR_WORDS] == mb.bound_hash
    assert d.drain() == 1
    res = peer.target_args["results"]
    assert len(res) == 1 and mb.results == res
    np.testing.assert_allclose(res[0].numpy(),
                               _want(handle, x, W, _landed(d, 0)), **TOL_PATH)
    assert [(c, e) for c, _, e in replies] == [(77, False)]
    assert replies[0][1] is res[0]


@pytest.mark.parametrize("n_shards,shift", LANES)
def test_agg_generations_reuse_slots(handle, n_shards, shift):
    """Two flushed generations without a sweep between them, then a third
    after it: every container's slot is reused and no result is lost."""
    d, W = _dispatcher(handle, n_shards, shift, n_slots=2)
    peer = d.peers["mesh"]
    n_slots = 2 * n_shards
    gens = [_payloads(K * n_slots // 2, seed=20 + g) for g in range(3)]
    assert d.send_ifunc_many("mesh", handle, gens[0]) == len(gens[0])
    d.flush()
    assert d.send_ifunc_many("mesh", handle, gens[1]) == len(gens[1])
    d.flush()
    assert peer.credits == 0
    assert d.drain() == 2 * len(gens[0])
    assert d.send_ifunc_many("mesh", handle, gens[2]) == len(gens[2])
    assert d.drain() == len(gens[2])
    res = peer.target_args["results"]
    assert len(res) == sum(map(len, gens))
    got = sorted(float(r.sum()) for r in res)
    want = sorted(float(_want(handle, x, W, _landed(d, t // K)).sum())
                  for t, x in enumerate(gens[0] + gens[1] + gens[2]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert peer.stats["agg_sent"] == 3 * n_slots // 2
    assert peer.credits == n_slots


# -- the transcode against the reference's dispatcher ------------------------

def _ref_dispatcher(lib_dir, n_slots=2):
    import jax

    mesh = make_mesh((len(jax.devices()),), ("model",))
    assert mesh.shape["model"] == 1
    src = RefContext("src", lib_dir=lib_dir)
    h = ref_register_ifunc(src, "uvm_affine")
    d = RefDispatcher(src, RefProgressEngine(inflight_window="trailer"))
    d.set_coalescing(True, max_subs=K, max_sub_bytes=128 << 10)
    d.add_peer("mesh", RefMeshFabric(mesh, "model", shift=0), None,
               n_slots=n_slots, slot_size=8 << 20,
               prog=RCG.deserialize_uvm(h.lib.code),
               externals=jnp.zeros((1, 1, T, T), jnp.float32), agg_k=K,
               prog_name=h.lib.name)
    return d, h


@pytest.mark.parametrize("how", ["many", "many_corr", "queued", "singleton"])
def test_agg_transcode_matches_reference_dispatcher(handle, lib_dir, how):
    """The same sends through the reference's dispatcher and the port's (1
    shard, as the reference's CPU mesh has): the posted container bytes
    and the staged words are equal bit for bit."""
    rd, rh = _ref_dispatcher(lib_dir)
    pd, _ = _dispatcher(handle, 1, 0)
    xs = _payloads(3, seed=4)
    for d, h in ((rd, rh), (pd, handle)):
        if how.startswith("many"):
            corr = [5, 0, 9] if how == "many_corr" else None
            assert d.send_ifunc_many("mesh", h, xs, corr_ids=corr) == 3
        elif how == "queued":
            for x in xs:
                assert d.send_ifunc("mesh", h, x, corr_id=3)
            assert d.flush_coalesced("mesh")
        else:
            create = ifunc_msg_create if d is pd else ref_ifunc_msg_create
            assert d.send("mesh", create(h, xs[0]))
    rl, pl = rd.peers["mesh"].rings[0], pd.peers["mesh"].rings[0]
    assert rl.tail == pl.tail == 1
    rs = rd.engine.slab_slot(rl.channel, 0)
    ps = pd.engine.slab_slot(pl.channel, 0)
    n = F.peek_header(ps).frame_len
    assert RF.peek_header(rs).frame_len == n
    assert bytes(ps[:n]) == bytes(rs[:n])
    np.testing.assert_array_equal(pl.mailbox._staged,
                                  np.asarray(rl.mailbox._staged))
    assert pl.mailbox.slot_words == rl.mailbox.slot_words
    assert pl.mailbox.slot_size == rl.mailbox.slot_size
    assert pl.mailbox.bound_hash == rl.mailbox.bound_hash


# -- refusals and the bypass -------------------------------------------------

def test_agg_refusals(handle):
    d1 = Dispatcher(handle.ctx, ProgressEngine(inflight_window="trailer"))
    d1.add_peer("mesh", DeviceMeshFabric(1, device="cpu"), None, n_slots=2,
                slot_size=1 << 20, prog=deserialize_uvm(handle.lib.code))
    lane = d1.peers["mesh"].rings[0]
    sub = F.AggSub(handle.lib.name, F.CodeKind.UVM, handle.lib.code_digest,
                   0, np.zeros(T * T, np.float32).tobytes())
    buf = bytearray(1 << 20)
    n = F.seal_agg_frame(buf, [sub, sub], kind=F.CodeKind.UVM)
    with pytest.raises(TransportError, match="agg_k"):
        lane.channel.put(memoryview(buf)[:n], 0)

    d, _ = _dispatcher(handle)
    ch = d.peers["mesh"].rings[0].channel
    pybc = F.AggSub("f", F.CodeKind.PYBC, b"\0" * 16, 0,
                    np.zeros(T * T, np.float32).tobytes())
    n = F.seal_agg_frame(buf, [sub, pybc], kind=F.CodeKind.UVM)
    with pytest.raises(TransportError, match="UVM"):
        ch.put(memoryview(buf)[:n], 0)
    short = F.AggSub(handle.lib.name, F.CodeKind.UVM, handle.lib.code_digest,
                     0, np.zeros(T * T // 2, np.float32).tobytes())
    n = F.seal_agg_frame(buf, [sub, short], kind=F.CodeKind.UVM)
    with pytest.raises(TransportError, match="words"):
        ch.put(memoryview(buf)[:n], 0)
    with pytest.raises(TransportError, match="words"):
        d.send_ifunc_many("mesh", handle,
                          [np.zeros((1, T, T // 2), np.float32)] * 2)
    n = F.seal_agg_frame(buf, [sub] * (K + 1), kind=F.CodeKind.UVM)
    with pytest.raises(TransportError, match="agg_k"):
        ch.put(memoryview(buf)[:n], 0)
    with pytest.raises(TransportError, match="slot_size"):
        DeviceMeshFabric(1, device="cpu").open_mailbox(
            None, 2, 1 << 17, prog=deserialize_uvm(handle.lib.code),
            agg_k=K)                                  # slot too small


def test_agg_bypass_record_ships_after_the_queue(handle):
    """A record above max_sub_bytes ships as a SLIM singleton only after
    the records queued ahead of it have flushed, so per-peer FIFO holds."""
    d, W = _dispatcher(handle, 1, 0, n_slots=4, max_sub_bytes=T * T * 4)
    peer = d.peers["mesh"]
    xs = _payloads(2, seed=6)
    for x in xs:                                      # a tile each: queued
        assert d.send_ifunc("mesh", handle, x)
    assert len(peer.coalesce[None].subs) == 2 and peer.rings[0].tail == 0
    d.set_coalescing(True, max_subs=K, max_sub_bytes=T * T * 4 - 1)
    y = _payloads(1, seed=8)[0]
    assert d.send_ifunc("mesh", handle, y)            # now above the bound
    assert not peer.coalesce and peer.rings[0].tail == 2
    assert peer.stats["agg_sent"] == 1 and peer.stats["agg_subs"] == 2
    assert d.drain() == 3
    res = peer.target_args["results"]
    order = xs + [y]
    for r, x in zip(res, order):                      # sweep order = FIFO
        np.testing.assert_allclose(r.numpy(), _want(handle, x, W, 0),
                                   **TOL_PATH)


def test_agg_queue_respects_agg_k_and_backpressure(handle):
    """Queued records split into containers of at most agg_k, and a queue
    that cannot flush for lack of credits reports backpressure once it
    holds a ring's worth."""
    d, W = _dispatcher(handle, 1, 0, agg_k=2, n_slots=2, max_subs=16)
    peer = d.peers["mesh"]
    xs = _payloads(6, seed=10)
    for x in xs[:5]:
        assert d.send_ifunc("mesh", handle, x)
    assert d.flush_coalesced("mesh") is False      # 2 slots of 2: 1 left
    assert peer.stats["agg_subs"] == 4 and len(peer.coalesce[None].subs) == 1
    assert peer.stats["backpressure"] == 1
    assert d.drain() == 5
    assert d.send_ifunc_many("mesh", handle, xs) == 6
    assert d.drain() == 6
    res = peer.target_args["results"]
    got = sorted(float(r.sum()) for r in res)      # sweep order: ring order
    want = sorted(float(_want(handle, x, W, 0).sum()) for x in xs[:5] + xs)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_agg_lane_age_flush_on_poll(handle):
    d, _ = _dispatcher(handle)
    d.set_coalescing(True, max_subs=K, max_age=0.0,
                     max_sub_bytes=128 << 10)
    assert d.send_ifunc("mesh", handle, _payloads(1)[0])
    peer = d.peers["mesh"]
    assert peer.rings[0].tail == 0
    d.poll()
    assert not peer.coalesce and peer.rings[0].tail == 1
