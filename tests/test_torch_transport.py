"""The port's ``Dispatcher`` host lanes held against the reference's: the
host tests of ``tests/test_transport.py``, each run as the same scenario
through both packages on the same inputs.

Each scenario builds its dispatcher, peers and frames with one package
(``REF`` or ``PORT``; the port's contexts at ``device="cpu"``), loading
``ifunc_libs/`` into both registries so PYBC frames are equal bit for
bit.  Besides the reference test's own assertions, the two runs must
agree on statuses, ``per_peer_stats()``, the dispatcher's, engine's and
targets' stats, the target_args, the mailbox and slab bytes and the obs
counters (``same_run``).  The two device-fabric tests of that file are
covered by ``tests/test_torch_device_fabric.py``, and
``test_controller_inject_flushes_despite_refusal`` waits for the runtime
(ROADMAP.md Queue 1 item 5).
"""

import types

import pytest

import repro.core as RC
import repro.obs as RO
import repro.transport as RT
import repro_torch.core as PC
import repro_torch.obs as PO
import repro_torch.transport as PT

REF = types.SimpleNamespace(name="ref", core=RC, transport=RT, obs=RO, kw={})
PORT = types.SimpleNamespace(name="port", core=PC, transport=PT, obs=PO,
                             kw={"device": "cpu"})
PKGS = (REF, PORT)

def ctx(pkg, name, lib_dir, **kw):
    return pkg.core.Context(name, lib_dir=lib_dir, **pkg.kw, **kw)


def mk_dispatcher(pkg, lib_dir, peers, *, n_slots=4, slot_size=8 << 10,
                  engine=None, obs=None, **peer_kw):
    """Dispatcher with one rle_insert-capable target per (name, fabric
    kind); ``fabric`` is "rdma" or "loopback"."""
    T = pkg.transport
    src = ctx(pkg, "src", lib_dir)
    d = T.Dispatcher(src, engine or T.ProgressEngine(flush_threshold=64),
                     obs=obs)
    for name, kind in peers:
        fab = T.RdmaFabric() if kind == "rdma" else T.LoopbackFabric()
        d.add_peer(name, fab, ctx(pkg, name, lib_dir, link_mode="remote"),
                   n_slots=n_slots, slot_size=slot_size,
                   target_args={"db": []}, **peer_kw)
    return d


def _mailbox_bytes(mb):
    buf = getattr(mb, "buf", None)
    return bytes(buf if buf is not None else mb.region.buf)


def _comparable_targs(targs):
    """target_args with μVM results left out (tensors in the port, arrays
    in the reference: compared by value where a test needs it)."""
    return {k: v for k, v in targs.items()
            if k not in ("results", "result", "externals")}


def _span_names(obs):
    return [(s.name, s.cat, s.args.get("status") if s.args else None)
            for s in obs.tracer.events]


def same_run(ref_d, port_d, *, spans=True):
    """The two dispatchers ended in the same observable state."""
    drop = lambda st: {k: v for k, v in st.items()  # noqa: E731
                       if k != "oldest_inflight_s"}
    assert {n: drop(s) for n, s in port_d.per_peer_stats().items()} == \
        {n: drop(s) for n, s in ref_d.per_peer_stats().items()}
    assert port_d.stats == ref_d.stats
    assert port_d.engine.stats == ref_d.engine.stats
    assert port_d.engine.outstanding() == ref_d.engine.outstanding()
    assert [bytes(s[0]) for s in port_d.engine._slabs.values()] == \
        [bytes(s[0]) for s in ref_d.engine._slabs.values()]
    for name, rp in ref_d.peers.items():
        pp = port_d.peers[name]
        assert pp.cached == rp.cached, name
        assert len(pp.resend) == len(rp.resend), name
        if rp.target_ctx is not None:
            assert pp.target_ctx.stats == rp.target_ctx.stats, name
            assert _comparable_targs(pp.target_args) == \
                _comparable_targs(rp.target_args), name
            for rr, pr in zip(rp.rings, pp.rings):
                assert _mailbox_bytes(pr.mailbox) == \
                    _mailbox_bytes(rr.mailbox), name
                assert (pr.tail, pr.mailbox.head, pr.mailbox.consumed) == \
                    (rr.tail, rr.mailbox.head, rr.mailbox.consumed), name
    rs, ps = ref_d.obs.snapshot(), port_d.obs.snapshot()
    assert ps["counters"] == rs["counters"]
    assert {k: h["count"] for k, h in ps["histograms"].items()} == \
        {k: h["count"] for k, h in rs["histograms"].items()}
    assert [e[1] for e in port_d.obs.recorder.events()] == \
        [e[1] for e in ref_d.obs.recorder.events()]
    if spans:
        assert _span_names(port_d.obs) == _span_names(ref_d.obs)
        assert port_d.obs.tracer.open_count() == \
            ref_d.obs.tracer.open_count()


def both(scenario, lib_dir, **kw):
    """Run ``scenario(pkg, lib_dir, **kw)`` through both packages; returns
    (reference result, port result)."""
    return tuple(scenario(pkg, lib_dir, **kw) for pkg in PKGS)


def _record(i: int) -> bytes:
    return bytes([i % 251]) * (16 + i)


def _fanout(pkg, lib_dir):
    return mk_dispatcher(pkg, lib_dir, [("rdma_a", "rdma"),
                                        ("rdma_b", "rdma"),
                                        ("loop", "loopback")])


def _handle(pkg, d, lib_dir, name="rle_insert"):
    return pkg.core.register_ifunc(d.src_ctx, name, lib_dir)


def _msg(pkg, h, payload, **kw):
    return pkg.core.ifunc_msg_create(h, payload, **kw)


# ---------------------------------------------------------------------------


def _ordering(pkg, lib_dir):
    fanout = _fanout(pkg, lib_dir)
    h = _handle(pkg, fanout, lib_dir)
    sent = {name: [] for name in fanout.peers}
    retries = 0
    for i in range(12):
        for name in fanout.peers:
            rec = _record(i)
            while not fanout.send(name, _msg(pkg, h, rec)):
                retries += 1
                fanout.drain()
            sent[name].append(rec)
    fanout.drain()
    for name, peer in fanout.peers.items():
        assert peer.target_args["db"] == sent[name], name
        assert peer.stats["delivered"] == 12
    return fanout, retries


def test_multi_peer_dispatch_ordering(lib_dir):
    """Per-peer FIFO across interleaved sends to three peers on two fabric
    kinds; the same backpressure retries and SLIM switch in both."""
    (rd, rr), (pd, pr) = both(_ordering, lib_dir)
    assert pr == rr
    assert all(0 < p.stats["slim_sent"] < 12 for p in pd.peers.values())
    same_run(rd, pd)


def _credits(pkg, lib_dir):
    d = mk_dispatcher(pkg, lib_dir, [("p", "rdma")], n_slots=2)
    h = _handle(pkg, d, lib_dir)
    out = [d.send("p", _msg(pkg, h, b"a")), d.send("p", _msg(pkg, h, b"b")),
           d.send("p", _msg(pkg, h, b"c"))]
    peer = d.peers["p"]
    assert out == [True, True, False]
    assert peer.stats["backpressure"] == 1 and peer.credits == 0
    assert d.drain() == 2
    assert peer.credits == 2
    assert d.send("p", _msg(pkg, h, b"c"))
    d.drain()
    assert peer.target_args["db"] == [b"a", b"b", b"c"]
    assert peer.stats["sent"] == 3
    return d


def test_credit_exhaustion_and_return(lib_dir):
    same_run(*both(_credits, lib_dir))


def _inflight(pkg, lib_dir):
    T = pkg.transport
    eng = T.ProgressEngine(flush_threshold=64, inflight_window="trailer")
    d = mk_dispatcher(pkg, lib_dir, [("p", "rdma")], engine=eng)
    peer = d.peers["p"]
    peer.target_ctx.max_trailer_spins = 10
    h = _handle(pkg, d, lib_dir)
    handle = eng.post(peer.rings[0].channel, _msg(pkg, h, b"x").frame,
                      peer.rings[0].tail, peer="p")
    peer.rings[0].tail += 1
    assert not handle.done and eng.outstanding() == 1
    polls = [d.poll()]
    assert peer.stats["inflight_polls"] >= 1
    assert peer.target_args["db"] == []
    assert eng.flush() == 1
    assert handle.done and eng.outstanding() == 0
    polls.append(d.poll())
    assert polls == [0, 1]
    assert peer.target_args["db"] == [b"x"]
    return d


def test_inflight_window_surfaced_via_progress_engine(lib_dir):
    same_run(*both(_inflight, lib_dir))


def _cq(pkg, lib_dir):
    T = pkg.transport
    eng = T.ProgressEngine(flush_threshold=2, inflight_window="trailer")
    d = mk_dispatcher(pkg, lib_dir, [("p", "rdma")], engine=eng)
    h = _handle(pkg, d, lib_dir)
    order = []
    for i in range(2):
        d.send("p", _msg(pkg, h, _record(i)),
               on_complete=lambda hd, i=i: order.append(i))
    assert eng.stats["auto_flushes"] == 1
    assert order == [0, 1]
    cqes = eng.poll_cq()
    assert eng.poll_cq() == []
    return d, [(c.seq, c.peer, c.nbytes, c.slot) for c in cqes]


def test_completion_queue_and_callbacks(lib_dir):
    (rd, rq), (pd, pq) = both(_cq, lib_dir)
    assert [c[1] for c in pq] == ["p", "p"] and [c[3] for c in pq] == [0, 1]
    assert pq == rq
    same_run(rd, pd)


def _rejected(pkg, lib_dir):
    core, T = pkg.core, pkg.transport
    src = ctx(pkg, "src", lib_dir)
    d = T.Dispatcher(src, T.ProgressEngine())
    strict = ctx(pkg, "strict", lib_dir, policy=core.SecurityPolicy(
        allowed_kinds=frozenset({core.CodeKind.UVM})))
    d.add_peer("strict", T.RdmaFabric(), strict, n_slots=4,
               slot_size=8 << 10, target_args={"db": []})
    d.add_peer("open", T.RdmaFabric(),
               ctx(pkg, "open", lib_dir, link_mode="remote"),
               n_slots=4, slot_size=8 << 10, target_args={"db": []})
    h = _handle(pkg, d, lib_dir)
    for name in ("strict", "open"):
        assert d.send(name, _msg(pkg, h, b"z"))
    d.drain()
    stats = d.per_peer_stats()
    assert (stats["strict"]["rejected"], stats["strict"]["delivered"]) == \
        (1, 0)
    assert (stats["open"]["rejected"], stats["open"]["delivered"]) == (0, 1)
    assert strict.stats["rejected"] == 1
    assert d.peers["strict"].credits == 4
    return d


def test_rejected_frames_accounted_per_peer(lib_dir):
    rd, pd = both(_rejected, lib_dir)
    assert pd.peers["strict"].target_ctx.stats["last_reject"] == \
        rd.peers["strict"].target_ctx.stats["last_reject"]
    same_run(rd, pd)


def _fairness(pkg, lib_dir):
    fanout = _fanout(pkg, lib_dir)
    h = _handle(pkg, fanout, lib_dir)
    for i in range(3):
        fanout.send("rdma_a", _msg(pkg, h, _record(i)))
    fanout.send("rdma_b", _msg(pkg, h, b"b0"))
    fanout.send("loop", _msg(pkg, h, b"l0"))
    fanout.flush()
    assert fanout.poll(budget=3) == 3
    mid = {n: s["delivered"] for n, s in fanout.per_peer_stats().items()}
    assert mid == {"rdma_a": 1, "rdma_b": 1, "loop": 1}
    fanout.drain()
    assert fanout.per_peer_stats()["rdma_a"]["delivered"] == 3
    return fanout


def test_poll_fairness_budget_round_robin(lib_dir):
    same_run(*both(_fairness, lib_dir))


def _rings(pkg, lib_dir):
    d = mk_dispatcher(pkg, lib_dir, [("p", "rdma")], n_slots=2, rings=2)
    peer = d.peers["p"]
    assert len(peer.rings) == 2 and peer.credits == 4
    h = _handle(pkg, d, lib_dir)
    for i in range(4):
        assert d.send("p", _msg(pkg, h, _record(i)))
    assert peer.credits == 0
    assert not d.send("p", _msg(pkg, h, b"over"))
    assert d.drain() == 4
    assert len(peer.target_args["db"]) == 4
    return d


def test_multiple_rings_per_peer(lib_dir):
    same_run(*both(_rings, lib_dir))


def _too_large(pkg, lib_dir):
    d = mk_dispatcher(pkg, lib_dir, [("p", "rdma")], slot_size=1 << 10)
    h = _handle(pkg, d, lib_dir)
    with pytest.raises(pkg.transport.TransportError) as e:
        d.send("p", _msg(pkg, h, bytes(range(256)) * 32))
    return d, str(e.value)


def test_frame_too_large_for_slot(lib_dir):
    (rd, re_), (pd, pe) = both(_too_large, lib_dir)
    assert pe == re_
    same_run(rd, pd)


def _loopback(pkg, lib_dir):
    core, T = pkg.core, pkg.transport
    fab = T.LoopbackFabric()
    dst = ctx(pkg, "dst", lib_dir, link_mode="remote")
    dst.max_trailer_spins = 10
    mb = fab.open_mailbox(dst, 2, 8 << 10)
    ch = fab.connect(None, mb)
    h = core.register_ifunc(ctx(pkg, "src", lib_dir), "rle_insert", lib_dir)
    msg = core.ifunc_msg_create(h, b"partial")
    ch.put(msg.frame, 0, deliver_bytes=msg.nbytes - 3)
    db = {"db": []}
    sts = [core.poll_ifunc(dst, mb.slot_view(0), None, db).name]
    seen = bytes(mb.buf)
    ch.flush()
    sts.append(core.poll_ifunc(dst, mb.slot_view(0), None, db).name)
    assert sts == ["IN_PROGRESS", "OK"] and db["db"] == [b"partial"]
    # the stream-path puts (sub-slot and scatter-gather, a tail withheld)
    ch.put_at(b"abcdef", 1, 10, deliver_bytes=2)
    ch.putv_at([(100, b"xyz"), (200, b"0123456789")], 1, withhold_tail=4)
    before = bytes(mb.buf)
    ch.flush()
    return sts, seen, before, bytes(mb.buf), dict(ch.stats), dict(dst.stats)


def test_loopback_zero_copy_and_partial(lib_dir):
    """Loopback honours the same partial-delivery contract as RDMA, byte
    for byte and stat for stat with the reference's."""
    ref, port = both(_loopback, lib_dir)
    assert port == ref


def _legacy(pkg, lib_dir):
    core, T = pkg.core, pkg.transport
    src = ctx(pkg, "s", lib_dir)
    dst = ctx(pkg, "d", lib_dir, link_mode="remote")
    region = dst.nic.mem_map(32 << 10)
    ring = core.RingBuffer(region, 8 << 10)
    ep = src.nic.connect(dst.nic)
    h = core.register_ifunc(src, "rle_insert", lib_dir)
    m = core.ifunc_msg_create(h, b"legacy")
    core.ifunc_msg_send_nbix(ep, m, ring.slot_addr(ring.tail), region.rkey)
    ring.tail += 1
    db = {"db": []}
    st = core.poll_ring(dst, ring, db)
    assert st.name == "OK" and db["db"] == [b"legacy"]
    ch = T.fabric.endpoint_channel(ep)
    assert ch.stats["puts"] == 1
    return dict(ch.stats), dict(dst.stats), bytes(region.buf)


def test_legacy_api_routes_through_transport(lib_dir):
    ref, port = both(_legacy, lib_dir)
    assert port == ref


# ---------------------------------------------------------------------------
# what the port does not carry yet, and says so


def test_refused_paths_name_their_roadmap_item(lib_dir):
    """Streams, codecs and striping (item 3(b)); faults, pollers and peer
    removal (5): each raises a TransportError naming its ROADMAP.md
    item."""
    T = PT
    d = mk_dispatcher(PORT, lib_dir, [("p", "rdma")])
    h = _handle(PORT, d, lib_dir)
    cases = [
        ("3(b)", lambda: d.add_peer("q", T.RdmaFabric(),
                                    ctx(PORT, "q", lib_dir), rings=2,
                                    stripe=True)),
        ("3(b)", lambda: d.add_peer("q", T.RdmaFabric(),
                                    ctx(PORT, "q", lib_dir), codec="zlib")),
        ("3(b)", lambda: d.set_streaming(True)),
        ("3(b)", lambda: d.send_stream("p", h, b"x" * 64)),
        ("5", lambda: d.remove_peer("p")),
        ("5", lambda: setattr(d, "faults", object())),
        ("5", lambda: setattr(d, "pollers", [lambda: None])),
    ]
    for item, call in cases:
        with pytest.raises(T.TransportError,
                           match=rf"ROADMAP\.md Queue 1 item {re_item(item)}"):
            call()
    assert "q" not in d.peers and d.faults is None and d.pollers == ()
    assert d.peers["p"].stats["sent"] == 0      # nothing was posted


def re_item(item: str) -> str:
    return item.replace("(", r"\(").replace(")", r"\)")
