"""The port's task runtime (``repro_torch.tasks``) and the Dispatcher's
reply path held against the reference's: the cases of
``tests/test_tasks.py`` that need no placement or graph library, each run
as the same scenario through both packages on the same inputs.

Each scenario builds its runtime, peers and frames with one package (the
port's contexts at ``device="cpu"``), loading ``ifunc_libs/`` into both
registries so PYBC frames are equal bit for bit.  Besides the reference
test's own assertions, the two runs must agree on every future's outcome
(value, or exception type and message), the runtime's stats and
everything ``same_run`` compares, the reply rings' bytes and cursors
included.  ``test_device_future_resolves`` runs the port alone (the
reference's μVM needs ``pl.load``) and holds it against relu(x @ W) and
``repro.kernels.ref``.
"""

import types

import numpy as np
import pytest
import torch

import repro.core.registry as RREG
import repro.tasks as RTK
import repro.tasks.wire as RW
import repro_torch.core.registry as PREG
import repro_torch.tasks as PTK
import repro_torch.tasks.wire as PW
from repro.core import codegen as RCG
from repro.kernels import ref as KREF
from test_torch_transport import PORT, REF, _mailbox_bytes, ctx, same_run

RPKG = types.SimpleNamespace(**vars(REF), tasks=RTK, wire=RW, registry=RREG)
PPKG = types.SimpleNamespace(**vars(PORT), tasks=PTK, wire=PW, registry=PREG)
PKGS = (RPKG, PPKG)

T = 128


def both(scenario, lib_dir, **kw):
    return tuple(scenario(pkg, lib_dir, **kw) for pkg in PKGS)


def _mk_runtime(pkg, lib_dir, peers, *, n_slots=4, slot_size=16 << 10,
                window="trailer", **kw):
    T_ = pkg.transport
    rt = pkg.tasks.TaskRuntime(
        ctx(pkg, "src", lib_dir),
        engine=T_.ProgressEngine(flush_threshold=64, inflight_window=window),
        default_timeout=10.0)
    for name, kind in peers:
        fab = T_.RdmaFabric() if kind == "rdma" else T_.LoopbackFabric()
        rt.add_peer(name, fab, ctx(pkg, name, lib_dir, link_mode="remote"),
                    n_slots=n_slots, slot_size=slot_size, target_args={},
                    **kw)
    return rt


def _rt(pkg, lib_dir, **kw):
    return _mk_runtime(pkg, lib_dir, [("rdma", "rdma"), ("loop", "loopback")],
                       **kw)


def _sum_handle(pkg, rt, lib_dir):
    return pkg.core.register_ifunc(rt.ctx, "task_sum", lib_dir)


def outcome(fut):
    """A future's state and value or error, comparable across packages
    (a liveness error's elapsed time cut off)."""
    if not fut.done():
        return (fut.state.name, None)
    exc = fut._exc
    if exc is not None:
        return (fut.state.name, type(exc).__name__,
                str(exc).split(" (in flight")[0])
    v = fut._value
    if isinstance(v, np.ndarray):
        v = (v.dtype.str, v.shape, v.tolist())
    return (fut.state.name, v)


def same_runtime(ref_rt, port_rt, *, spans=True):
    """The two runtimes (and their dispatchers) ended in the same
    observable state."""
    same_run(ref_rt.dispatcher, port_rt.dispatcher, spans=spans)
    assert port_rt.stats == ref_rt.stats
    assert sorted(port_rt.futures) == sorted(ref_rt.futures)
    for name, rp in ref_rt.dispatcher.peers.items():
        pp = port_rt.dispatcher.peers[name]
        assert (pp.reply_mailbox is None) == (rp.reply_mailbox is None)
        if rp.reply_mailbox is None:
            continue
        assert _mailbox_bytes(pp.reply_mailbox) == \
            _mailbox_bytes(rp.reply_mailbox), name
        assert (pp.reply_tail, pp.reply_mailbox.head,
                pp.reply_mailbox.consumed) == \
            (rp.reply_tail, rp.reply_mailbox.head,
             rp.reply_mailbox.consumed), name


def held(scenario, lib_dir, **kw):
    """Run through both packages; the futures' outcomes (the scenario's
    second return) and the runtimes must agree."""
    (rrt, rout), (prt, pout) = both(scenario, lib_dir, **kw)
    assert pout == rout
    same_runtime(rrt, prt)
    return pout


# ---------------------------------------------------------------------------
# futures resolve (both host fabrics), core.submit sugar, sent wiring


def _host_futures(pkg, lib_dir):
    rt = _rt(pkg, lib_dir)
    h = _sum_handle(pkg, rt, lib_dir)
    f1 = rt.submit("rdma", h, b"\x01\x02\x03")
    f2 = pkg.core.submit(rt, "loop", h, b"\x05" * 10)   # the core.api sugar
    assert f1.result() == 6
    assert f2.result() == 50
    assert f1.done() and f1.state is pkg.tasks.TaskState.DONE
    assert rt.stats["resolved"] == 2 and rt.pending() == 0
    return rt, [outcome(f1), outcome(f2)]


def test_future_resolves_on_host_fabrics(lib_dir):
    held(_host_futures, lib_dir)


def _sent_at_flush(pkg, lib_dir):
    rt = _rt(pkg, lib_dir)
    h = _sum_handle(pkg, rt, lib_dir)
    fut = rt.submit("rdma", h, b"\x01")
    states = [fut.state.name]                    # posted, trailer withheld
    rt.dispatcher.engine.flush()
    states.append(fut.state.name)
    assert states == ["PENDING", "SENT"]
    assert fut.result() == 1
    assert rt.dispatcher.engine.stats["futures_sent"] == 1
    return rt, states + [outcome(fut)]


def test_future_marked_sent_at_flush(lib_dir):
    """PENDING until the engine's flush publishes the frame: the
    completion -> future wiring through TxHandle.future."""
    held(_sent_at_flush, lib_dir)


def _callbacks(pkg, lib_dir):
    rt = _rt(pkg, lib_dir)
    h = _sum_handle(pkg, rt, lib_dir)
    seen = []
    futs = [rt.submit("loop", h, bytes([i])) for i in range(1, 5)]
    futs[0].add_done_callback(lambda f: seen.append(f.corr_id))
    assert pkg.tasks.wait_all(futs) == [1, 2, 3, 4]
    assert seen == [futs[0].corr_id]
    futs[1].add_done_callback(lambda f: seen.append("late"))  # fires inline
    assert seen[-1] == "late"
    return rt, [outcome(f) for f in futs] + [seen]


def test_callbacks_and_wait_all(lib_dir):
    held(_callbacks, lib_dir)


# ---------------------------------------------------------------------------
# error paths: target raises -> exception future; ring survives


def _exception_future(pkg, lib_dir):
    rt = _rt(pkg, lib_dir)
    h = _sum_handle(pkg, rt, lib_dir)
    bad = rt.submit("rdma", h, b"\xff\x00")      # poison marker: main raises
    good = rt.submit("rdma", h, b"\x02\x02")
    with pytest.raises(pkg.wire.RemoteExecutionError) as ei:
        bad.result()
    assert ei.value.remote_type == "ValueError"
    assert bad.exception() is ei.value
    assert good.result() == 4                    # the slot after: not wedged
    peer = rt.dispatcher.peers["rdma"]
    assert peer.stats["errors"] == 1
    assert peer.stats["delivered"] == 2          # poisoned frame consumed
    assert peer.credits == 4                     # all credits returned
    return rt, [outcome(bad), outcome(good), ei.value.remote_message]


def test_exception_future_and_ring_survival(lib_dir):
    held(_exception_future, lib_dir)


def _fire_and_forget(pkg, lib_dir):
    rt = _rt(pkg, lib_dir)
    h = _sum_handle(pkg, rt, lib_dir)
    assert rt.dispatcher.send("loop", pkg.core.ifunc_msg_create(h, b"\xff"))
    with pytest.raises(ValueError, match="poisoned"):
        rt.dispatcher.drain()
    peer = rt.dispatcher.peers["loop"]
    assert peer.stats["errors"] == 1
    assert peer.credits == 4                     # slot consumed, not wedged
    fut = rt.submit("loop", h, b"\x01")
    assert fut.result() == 1
    return rt, [outcome(fut)]


def test_fire_and_forget_exception_reraises(lib_dir):
    """corr_id == 0 has no future to carry an error: the exception
    surfaces to the poll caller, after the poisoned slot was consumed."""
    held(_fire_and_forget, lib_dir)


def _submit_failure(pkg, lib_dir):
    rt = _rt(pkg, lib_dir)
    h = _sum_handle(pkg, rt, lib_dir)
    with pytest.raises(pkg.transport.TransportError) as ei:
        rt.submit("rdma", h, b"x" * (64 << 10))  # frame exceeds the 16K slot
    assert rt.pending() == 0 and not rt.futures
    return rt, [str(ei.value)]


def test_submit_failure_does_not_leak_future(lib_dir):
    held(_submit_failure, lib_dir)


def _reply_lost(pkg, lib_dir):
    rt = _rt(pkg, lib_dir)
    h = _sum_handle(pkg, rt, lib_dir)
    peer = rt.dispatcher.peers["loop"]
    peer.reply_channel.put = lambda *a, **k: None   # the wire eats the reply
    fut = rt.submit("loop", h, b"\x01")
    with pytest.raises(pkg.tasks.TaskTimeout):
        fut.result(timeout=0.2)
    assert not fut.done()                        # still pending
    assert peer.stats["replies"] == 1            # the target did reply
    assert peer.stats["delivered"] == 1
    return rt, [outcome(fut)]


def test_reply_lost_times_out(lib_dir):
    (rrt, rout), (prt, pout) = both(_reply_lost, lib_dir)
    assert pout == rout
    # the timeout loop's poll count follows the clock: compare the rest
    for rt in (rrt, prt):
        rt.dispatcher.stats["poll_rounds"] = 0
        rt.dispatcher.engine.stats["flushes"] = 0
        rt.dispatcher.peers["loop"].stats["inflight_polls"] = 0
        rt.dispatcher.peers["rdma"].stats["inflight_polls"] = 0
    same_runtime(rrt, prt)


def _duplicate(pkg, lib_dir):
    F = pkg.core.frame
    rt = _rt(pkg, lib_dir)
    h = _sum_handle(pkg, rt, lib_dir)
    fut = rt.submit("loop", h, b"\x03\x04")
    assert fut.result() == 7
    # forge a second reply with the same corr id straight into the ring
    peer = rt.dispatcher.peers["loop"]
    mb = peer.reply_mailbox
    frame = F.pack_reply("task_sum", pkg.wire.encode(999), F.CodeKind.PYBC,
                         fut.corr_id)
    mb.slot_view(mb.head)[:len(frame)] = frame
    assert rt.dispatcher.poll_replies() == 1
    assert rt.stats["orphan_replies"] == 1       # routed nowhere, counted
    assert fut.result() == 7                     # value unchanged
    assert not fut.set_result(123)               # double resolve refused
    return rt, [outcome(fut), bytes(frame)]


def test_duplicate_corr_id_reply_ignored(lib_dir):
    held(_duplicate, lib_dir)


def _reply_on_request_ring(pkg, lib_dir):
    F = pkg.core.frame
    c = ctx(pkg, "t", lib_dir)
    frame = F.pack_reply("task_sum", pkg.wire.encode(1), F.CodeKind.PYBC, 9)
    buf = bytearray(4 << 10)
    buf[:len(frame)] = frame
    st = pkg.core.poll_ifunc(c, buf, None, {})
    assert st == pkg.core.Status.REJECTED
    assert "reply frame" in c.stats["last_reject"]
    return st.name, c.stats, bytes(frame), bytes(buf)


def test_reply_frame_rejected_on_request_ring(lib_dir):
    """A FLAG_REPLY frame never links or executes through poll_ifunc."""
    ref, port = both(_reply_on_request_ring, lib_dir)
    assert port == ref


# ---------------------------------------------------------------------------
# corr id survives the cached fast path's NACK fallback


def _nack_corr(pkg, lib_dir):
    rt = pkg.tasks.TaskRuntime(
        ctx(pkg, "src", lib_dir),
        engine=pkg.transport.ProgressEngine(flush_threshold=64),
        default_timeout=10.0)
    tgt = ctx(pkg, "tgt", lib_dir, link_mode="remote")
    rt.add_peer("p", pkg.transport.RdmaFabric(), tgt, n_slots=4,
                slot_size=16 << 10, target_args={})
    h = _sum_handle(pkg, rt, lib_dir)
    first = rt.submit("p", h, b"\x01")
    assert first.result() == 1                   # FULL; confirms the digest
    assert tgt.link_cache.evict("task_sum", h.digest)
    fut = rt.submit("p", h, b"\x02\x03")         # SLIM -> NACK -> FULL
    assert fut.result() == 5
    peer = rt.dispatcher.peers["p"]
    assert peer.stats["nacks"] == 1 and peer.stats["resent"] == 1
    assert rt.stats["orphan_replies"] == 0
    return rt, [outcome(first), outcome(fut)]


def test_corr_id_survives_nack_retransmit(lib_dir):
    held(_nack_corr, lib_dir)


# ---------------------------------------------------------------------------
# LinkCache LRU: bounded capacity makes eviction and NACK operational


def _lru(pkg):
    c = pkg.registry.LinkCache(capacity=2)
    c.insert("a", b"1" * 16, "fa")
    c.insert("b", b"2" * 16, "fb")
    assert c.lookup("a", b"1" * 16) == "fa"      # touches a: b is now LRU
    c.insert("c", b"3" * 16, "fc")               # evicts b
    assert c.lookup("b", b"2" * 16) is None
    assert c.lookup("a", b"1" * 16) == "fa"
    s = c.stats()
    assert s["evictions"] == 1 and s["size"] == 2 and s["capacity"] == 2
    assert s["hits"] == 2 and s["misses"] == 1
    with pytest.raises(Exception) as ei:
        pkg.registry.LinkCache(capacity=0)
    return s, type(ei.value).__name__, str(ei.value)


def test_link_cache_lru_eviction_and_stats():
    assert _lru(PPKG) == _lru(RPKG)


def _capacity_pressure(pkg, lib_dir):
    T_ = pkg.transport
    src = ctx(pkg, "src", lib_dir)
    tgt = ctx(pkg, "tgt", lib_dir, link_mode="remote",
              link_cache=pkg.registry.LinkCache(capacity=1))
    d = T_.Dispatcher(src, T_.ProgressEngine(flush_threshold=64))
    d.add_peer("p", T_.RdmaFabric(), tgt, n_slots=4, slot_size=16 << 10,
               target_args={"db": []})
    h_sum = pkg.core.register_ifunc(src, "task_sum", lib_dir)
    h_rle = pkg.core.register_ifunc(src, "rle_insert", lib_dir)
    delivered = 0
    for _ in range(3):                           # alternate: constant churn
        assert d.send("p", pkg.core.ifunc_msg_create(h_sum, b"\x01"))
        delivered += d.drain()
        assert d.send("p", pkg.core.ifunc_msg_create(h_rle, b"x"))
        delivered += d.drain()
    peer = d.peers["p"]
    assert peer.stats["nacks"] >= 2
    assert peer.stats["resent"] == peer.stats["nacks"]
    assert peer.stats["nack_lost"] == 0
    assert delivered == 6
    assert tgt.link_cache.stats()["evictions"] >= 5
    assert tgt.stats["nacks"] == peer.stats["nacks"]
    return d, tgt.link_cache.stats()


def test_link_cache_capacity_pressure_drives_nack_recovery(lib_dir):
    """A capacity-1 target churns between two ifuncs: every SLIM send of
    the evicted one NACKs and the FULL resend recovers."""
    (rd, rs), (pd, ps) = both(_capacity_pressure, lib_dir)
    assert ps == rs
    same_run(rd, pd)


# ---------------------------------------------------------------------------
# device-mesh futures (sweep-correlated replies)


def test_device_future_resolves(lib_dir):
    """The port's device lane resolves a μVM future with the sweep's result
    (the reference's own case needs ``pl.load``: held against relu(x @ W)
    and the reference's ``ifunc_vm_ref`` instead)."""
    from repro_torch.core import Context, register_ifunc
    from repro_torch.core.codegen import deserialize_uvm
    from repro_torch.transport import (DeviceMeshFabric, Dispatcher,
                                       ProgressEngine)

    src = Context("src", lib_dir=lib_dir, device="cpu")
    rt = PTK.TaskRuntime(src, Dispatcher(src, ProgressEngine(
        inflight_window="trailer")), default_timeout=60.0)
    h = register_ifunc(src, "uvm_affine", lib_dir)
    W = np.eye(T, dtype=np.float32) * 0.5
    rt.add_peer("gpu", DeviceMeshFabric(1, shift=0, device="cpu"), None,
                n_slots=2, slot_size=128 << 10,
                prog=deserialize_uvm(h.lib.code),
                externals=np.broadcast_to(W, (1, 1, T, T)))
    assert rt.dispatcher.peers["gpu"].reply_mailbox is None
    x = np.random.default_rng(0).standard_normal((1, T, T)).astype(np.float32)
    fut = rt.submit("gpu", h, x)
    got = fut.result()
    assert isinstance(got, torch.Tensor) and got.shape == (1, T, T)
    np.testing.assert_allclose(got[0].numpy(), np.maximum(x[0] @ W, 0),
                               rtol=1e-4, atol=1e-5)
    ref = KREF.ifunc_vm_ref(RCG.deserialize_uvm(h.lib.code), x, W[None])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    assert rt.pending() == 0 and rt.stats["resolved"] == 1
    assert rt.dispatcher.peers["gpu"].stats["replies"] == 0   # no ring
    assert rt.dispatcher.engine.stats["futures_sent"] == 1


# ---------------------------------------------------------------------------
# wire codec


def _wire(pkg):
    w = pkg.wire
    assert w.decode(w.encode(b"raw")) == b"raw"
    assert w.decode(w.encode({"a": [1, 2], "b": None})) == {
        "a": [1, 2], "b": None}
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(w.decode(w.encode(arr)), arr)
    scalar = w.decode(w.encode(np.float32(2.5)))
    assert scalar == np.float32(2.5) and scalar.shape == ()
    err = w.decode(w.encode_error(ValueError("boom")))
    assert isinstance(err, w.RemoteExecutionError)
    assert err.remote_type == "ValueError" and "boom" in str(err)
    with pytest.raises(w.WireError):
        w.decode(b"")
    with pytest.raises(w.WireError):
        w.encode(object())
    return str(err), w.encode(arr), w.encode(np.float32(2.5))


def test_wire_roundtrips():
    assert _wire(PPKG) == _wire(RPKG)


_WIRE_VALUES = {
    "int": 7, "neg_int": -3, "none": None, "bool": True, "str": "héllo",
    "json": {"a": [1, 2.5, None], "b": "x"}, "bytes": b"\x00\x01raw",
    "bytearray": bytearray(b"ba"), "empty_bytes": b"",
    "f32": np.arange(12, dtype=np.float32).reshape(3, 4),
    "i64": np.arange(-4, 4, dtype=np.int64).reshape(2, 2, 2),
    "u8": np.arange(5, dtype=np.uint8), "f32_0d": np.float32(2.5),
    "i32_0d": np.array(-9, dtype=np.int32),
    "f32_fortran": np.asfortranarray(np.arange(6, dtype=np.float32)
                                     .reshape(2, 3)),
    "error": ValueError("boom"), "error_str": "plain message",
}


@pytest.mark.parametrize("name", sorted(_WIRE_VALUES) + ["tensor_f32",
                                                          "tensor_i64",
                                                          "tensor_0d",
                                                          "tensor_grad"])
def test_wire_bytes_equal_reference(name):
    """``encode`` gives the reference's bytes for every value kind; a CPU
    tensor encodes as the numpy array it holds, and decodes to it."""
    tensors = {
        "tensor_f32": torch.arange(24, dtype=torch.float32).reshape(2, 3, 4),
        "tensor_i64": torch.arange(-3, 3),
        "tensor_0d": torch.tensor(1.25),
        "tensor_grad": torch.ones(2, 2, requires_grad=True) * 3,
    }
    if name in tensors:
        t = tensors[name]
        got = PW.encode(t)
        assert got == RW.encode(t.detach().numpy())
        back = PW.decode(got)
        assert isinstance(back, np.ndarray)
        np.testing.assert_array_equal(back, t.detach().numpy())
        return
    v = _WIRE_VALUES[name]
    enc = "encode_error" if name.startswith("error") else "encode"
    got, want = getattr(PW, enc)(v), getattr(RW, enc)(v)
    assert got == want
    dp, dr = PW.decode(got), RW.decode(want)
    if isinstance(dr, np.ndarray):
        assert dp.dtype == dr.dtype and dp.shape == dr.shape
        np.testing.assert_array_equal(dp, dr)
    elif isinstance(dr, Exception):
        assert (type(dp).__name__, str(dp), dp.remote_type) == \
            (type(dr).__name__, str(dr), dr.remote_type)
    else:
        assert dp == dr


def test_wire_refuses_bf16(lib_dir):
    """numpy has no bf16: such a result raises WireError naming the dtype,
    and is never upcast; through the reply path it becomes an error
    reply that fails the future."""
    with pytest.raises(PW.WireError, match="bfloat16"):
        PW.encode(torch.ones(2, 2, dtype=torch.bfloat16))
    assert PW.encode(torch.ones(2, 2, dtype=torch.bfloat16).float()) == \
        RW.encode(np.ones((2, 2), np.float32))
    rt = _rt(PPKG, lib_dir)
    h = _sum_handle(PPKG, rt, lib_dir)
    fut = PPKG.tasks.Future(rt, 77, "rdma", h.name)
    rt.futures[77] = fut
    d = rt.dispatcher
    d._post_reply(d.peers["rdma"], h.name, h.lib.kind, 77,
                  torch.ones(2, dtype=torch.bfloat16), False)
    assert d.poll_replies() == 1
    with pytest.raises(PW.RemoteExecutionError, match="bfloat16") as ei:
        fut.result(0)
    assert ei.value.remote_type == "WireError"


def test_run_local_uniform_future(lib_dir):
    def run(pkg, lib_dir):
        rt = _rt(pkg, lib_dir)
        ok = rt.run_local(lambda a, b: a + b, 2, 3)
        assert ok.done() and ok.result() == 5
        bad = rt.run_local(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            bad.result()
        return rt, [outcome(ok), outcome(bad)]

    held(run, lib_dir)


# ---------------------------------------------------------------------------
# reply-ring credits: a full reply ring drains inline, never drops


@pytest.mark.parametrize("coalesce", [False, True], ids=["singles", "agg"])
def test_reply_ring_smaller_than_request_ring(lib_dir, coalesce):
    """Two reply slots against eight request slots: a sweep that fills the
    reply ring drains the source's own inbox inline, mid-sweep, so every
    future resolves and nothing counts ``reply_dropped``."""

    def run(pkg, lib_dir):
        rt = _mk_runtime(pkg, lib_dir, [("p", "rdma")], n_slots=8,
                         reply_slots=2)
        h = _sum_handle(pkg, rt, lib_dir)
        assert rt.submit("p", h, b"warm").result() == sum(b"warm")
        if coalesce:
            rt.dispatcher.set_coalescing(True, max_subs=4)
        pays = [bytes([i + 1]) * (i + 1) for i in range(24)]
        pays[5] = bytes([255, 1])                # one poisoned record
        futs = rt.submit_many("p", h, pays)
        rt.drain()
        outs = [outcome(f) for f in futs]
        for i, f in enumerate(futs):
            if i == 5:
                with pytest.raises(pkg.wire.RemoteExecutionError,
                                   match="poisoned"):
                    f.result()
            else:
                assert f.result() == sum(pays[i])
        s = rt.dispatcher.peers["p"].stats
        assert rt.dispatcher.stats["reply_dropped"] == 0
        assert rt.pending() == 0 and rt.stats["orphan_replies"] == 0
        assert s["replies"] == 25
        assert (s["agg_replies"] > 0) == coalesce
        return rt, outs

    held(run, lib_dir)


# ---------------------------------------------------------------------------
# liveness: a wedged peer's futures fail instead of hanging


def _zero_clocked(rt):
    """Counters that follow the clock (rounds a deadline's spin took):
    zeroed so the rest of two runs compare."""
    d = rt.dispatcher
    d.stats["poll_rounds"] = 0
    d.engine.stats["flushes"] = 0
    for p in d.peers.values():
        p.stats["inflight_polls"] = 0


@pytest.mark.parametrize("how", ["singleton", "container", "queued"])
def test_fail_inflight_resolves_wedged_futures(lib_dir, how):
    """fail_inflight on a wedged peer resolves a singleton's future, each
    record of a posted container, and (once something in flight timed out)
    each record still queued for a container with a TransportError, as the
    reference does; the peer's healthy neighbour keeps its futures."""

    def run(pkg, lib_dir):
        rt = _rt(pkg, lib_dir)
        h = _sum_handle(pkg, rt, lib_dir)
        assert rt.submit("loop", h, b"warm").result() == sum(b"warm")
        d = rt.dispatcher
        d.peers["loop"].rings[0].mailbox.sweep = lambda *a, **k: []
        if how != "singleton":
            d.set_coalescing(True, max_subs=4)
        futs = [rt.submit("loop", h, bytes([i + 1])) for i in range(3)]
        rt.flush()                           # singletons or one container
        if how == "queued":                  # queued behind the container
            futs += [rt.submit("loop", h, bytes([9, i])) for i in range(2)]
        healthy = rt.submit("rdma", h, b"\x05")
        failed = d.fail_inflight("wedged", peers={"loop"})
        assert failed == len(futs)
        assert all(isinstance(f.exception(0), pkg.transport.TransportError)
                   for f in futs)
        assert healthy.result() == 5
        assert d.peers["loop"].stats["timed_out"] == len(futs)
        assert not d.peers["loop"].coalesce
        del d.peers["loop"].rings[0].mailbox.sweep
        _zero_clocked(rt)
        return rt, [outcome(f) for f in futs + [healthy]]

    held(run, lib_dir)


def test_drain_deadline_fails_only_old_futures(lib_dir):
    """drain(deadline=) cranks while a wedged peer holds frames, then fails
    those in flight for the whole deadline with a TransportError naming it
    and spares a future submitted halfway through; unwedged, the young
    future resolves and the old ones' late replies are orphans."""
    import time

    def run(pkg, lib_dir):
        rt = _rt(pkg, lib_dir)
        h = _sum_handle(pkg, rt, lib_dir)
        mb = rt.dispatcher.peers["loop"].rings[0].mailbox
        young, t0 = [], time.monotonic()

        def wedged(*a, **k):
            if not young and time.monotonic() - t0 >= 0.2:
                young.append(rt.submit("loop", h, b"\x07\x07"))
            return []

        mb.sweep = wedged
        old = [rt.submit("loop", h, bytes([i + 1])) for i in range(2)]
        t0 = time.monotonic()
        rt.drain(deadline=0.4)
        assert all("drain deadline (0.4s) exceeded" in str(f.exception(0))
                   for f in old)
        assert young and not young[0].done()
        assert rt.dispatcher.stats["timed_out"] == 2
        del mb.sweep
        rt.drain()
        assert young[0].result() == 14
        assert rt.stats["orphan_replies"] == 2 and rt.pending() == 0
        _zero_clocked(rt)
        return rt, [outcome(f) for f in old + young]

    held(run, lib_dir)
