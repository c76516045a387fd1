"""The port's flow layer (``repro_torch.flow``) held against the
reference's ``repro.flow``.

* The 22 cases of ``tests/test_flow.py`` run as the same scenario
  through both packages on the same inputs (the port's contexts at
  ``device="cpu"``), loading ``ifunc_libs/`` into both registries so PYBC
  frames are equal bit for bit.  Besides the reference test's own
  assertions, the frames and descriptors must be equal byte for byte, and
  the two engines must end in the same state (``same_flow``): futures'
  outcomes (values, error types and messages, the failing hop),
  ``FlowEngine.stats``, each node's ``stats``, its context's stats, its
  dispatcher's state (``same_run``: stats, slab and ring bytes, obs
  counters), the return rings' bytes, and the spans' names, categories
  and actors.  The three device-lane cases run the reference's lane
  through the traceable jnp μVM interpreter of ``tests/test_torch_graph``
  (its Pallas one needs ``pl.load``), the port's on
  ``DeviceMeshFabric(1, device="cpu")``.
* Beyond that file: a coalesced scatter whose branches share one
  aggregate container (the ``AGG_SUBFLAG_CONT`` branch of ``_run_agg``);
  the two-hop ``uvm_affine`` chain of ``chip_smoke.py`` phase 23 (d),
  the reference's μVM through that interpreter, results within the
  host-target μVM tolerance (2e-5); ``on_peer_death`` retiring a node
  through the dispatchers' ``remove_peer`` and failing a pinned chain;
  and ``examples/storage_pipeline.py`` run
  whole against ``chip_smoke.storage_pipeline`` at the same seed.
"""

import pathlib
import struct
import time
import types

import numpy as np
import pytest
import torch

import chip_smoke
import repro.core.device_mailbox as RDM
import repro.flow as RFL
import repro.flow.engine as RFE
import repro.kernels.ops as RKO
import repro.tasks.graph as RG
import repro_torch.flow as PFL
import repro_torch.tasks.graph as PG
from repro.core.registry import LinkCache as RLinkCache
from repro_torch.core.registry import LinkCache as PLinkCache
from test_torch_graph import _jnp_uvm
from test_torch_tasks import PPKG as _PPKG
from test_torch_tasks import RPKG as _RPKG
from test_torch_tasks import outcome, same_runtime
from test_torch_transport import _mailbox_bytes, ctx, same_run

REPO = pathlib.Path(__file__).resolve().parents[1]
RPKG = types.SimpleNamespace(**vars(_RPKG), flow=RFL, graph=RG,
                             LinkCache=RLinkCache)
PPKG = types.SimpleNamespace(**vars(_PPKG), flow=PFL, graph=PG,
                             LinkCache=PLinkCache)
PKGS = (RPKG, PPKG)
T = 128
TOL = 2e-5          # the port's host-target μVM tests against the reference


def both(scenario, lib_dir, **kw):
    return tuple(scenario(pkg, lib_dir, **kw) for pkg in PKGS)


def flow_outcome(fut):
    """``outcome`` plus, for an error, the failing hop and remote type."""
    out = outcome(fut)
    exc = fut._exc
    if exc is not None:
        out += (getattr(exc, "hop", None), getattr(exc, "remote_type", None))
    return out


def _spans(obs):
    return [(s.name, s.cat, s.actor,
             s.args.get("status") if s.args else None)
            for s in obs.tracer.events]


def same_flow(ref, port, *, exact=True):
    """The two engines ended in the same observable state.  ``exact``
    also compares every dispatcher's slab and ring bytes and the return
    rings' bytes (not for μVM chains, whose forwarded payloads carry each
    package's own float rounding)."""
    assert port.stats == ref.stats
    assert list(port.nodes) == list(ref.nodes)
    assert sorted(port.futures) == sorted(ref.futures)
    assert sorted(port._chains) == sorted(ref._chains)
    assert sorted(port.libraries) == sorted(ref.libraries)
    assert port.pe.stats == ref.pe.stats
    for name, rn in ref.nodes.items():
        pn = port.nodes[name]
        assert pn.stats == rn.stats, name
        assert pn.ctx.stats == rn.ctx.stats, name
        assert list(pn.dispatcher.peers) == list(rn.dispatcher.peers), name
        assert len(pn.outbox) == len(rn.outbox), name
        assert {k: (g["expect"], g["chunks"]) for k, g in pn.gathers.items()} \
            == {k: (g["expect"], g["chunks"]) for k, g in rn.gathers.items()}
        if exact:
            same_run(rn.dispatcher, pn.dispatcher, spans=False)
        else:
            assert pn.dispatcher.stats == rn.dispatcher.stats, name
            drop = lambda st: {k: v for k, v in st.items()  # noqa: E731
                               if k != "oldest_inflight_s"}
            assert {n: drop(s) for n, s in
                    pn.dispatcher.per_peer_stats().items()} == \
                {n: drop(s) for n, s in
                 rn.dispatcher.per_peer_stats().items()}, name
        rr, pr = ref.returns[name], port.returns[name]
        assert (pr["tail"], pr["mb"].head, pr["mb"].consumed) == \
            (rr["tail"], rr["mb"].head, rr["mb"].consumed), name
        if exact:
            assert _mailbox_bytes(pr["mb"]) == _mailbox_bytes(rr["mb"]), name
    assert port.obs.snapshot()["counters"] == ref.obs.snapshot()["counters"]
    assert _spans(port.obs) == _spans(ref.obs)
    assert port.obs.tracer.open_count() == ref.obs.tracer.open_count()


def held(scenario, lib_dir, **kw):
    """Run through both packages; the outcomes (the scenario's second
    return) and the engines must agree."""
    (reng, rout), (peng, pout) = both(scenario, lib_dir, **kw)
    assert pout == rout
    same_flow(reng, peng)
    return pout


# ---------------------------------------------------------------------------
# frame v2.2: the continuation section


def _cont_section(pkg, lib_dir):
    F = pkg.core.frame
    cont = b"continuation-descriptor-bytes"
    buf = F.pack_frame("f", b"CODE", b"PAYLOAD", F.CodeKind.PYBC,
                       corr_id=7, cont=cont)
    hdr = F.peek_header(buf)
    assert hdr.has_cont and hdr.corr_id == 7
    code, payload = F.frame_sections(buf, hdr)
    assert bytes(code) == b"CODE"
    assert bytes(payload) == b"PAYLOAD"
    assert bytes(F.frame_cont(buf, hdr)) == cont
    plain = F.pack_frame("f", b"CODE", b"PAYLOAD", F.CodeKind.PYBC)
    h2 = F.peek_header(plain)
    assert not h2.has_cont and F.frame_cont(plain, h2) is None
    return bytes(buf), bytes(plain)


def test_frame_cont_section_roundtrip(lib_dir):
    ref, port = both(_cont_section, lib_dir)
    assert port == ref


def _cont_validation(pkg, lib_dir):
    F = pkg.core.frame
    raw = bytearray(F.pack_frame("f", b"", b"p", F.CodeKind.PYBC))
    (flags,) = struct.unpack_from("<I", raw, 60)
    struct.pack_into("<I", raw, 60, flags | F.FLAG_CONT)
    struct.pack_into("<I", raw, F.SIGNAL_OFF,
                     F.fletcher32(bytes(raw[:F.SIGNAL_OFF])))
    with pytest.raises(F.FrameError, match="empty continuation") as e1:
        F.peek_header(raw)
    with pytest.raises(F.FrameError) as e2:
        F.peek_header(F.pack_frame("f", b"", b"p", F.CodeKind.PYBC,
                                   flags=F.FLAG_REPLY, cont=b"x"))
    return bytes(raw), str(e1.value), str(e2.value)


def test_frame_cont_validation(lib_dir):
    ref, port = both(_cont_validation, lib_dir)
    assert port == ref


def _flowless(pkg, lib_dir):
    core = pkg.core
    c = ctx(pkg, "plain", lib_dir)
    h = core.register_ifunc(c, "task_sum")
    msg = core.ifunc_msg_create(h, b"\x01", cont=b"bogus-but-present")
    buf = bytearray(8 << 10)
    buf[:len(msg.frame)] = msg.frame
    st = core.poll_ifunc(c, buf, None, {})
    assert st.name == "REJECTED"
    assert "flow-less" in c.stats["last_reject"]
    return bytes(msg.frame), st.name, c.stats, bytes(buf)


def test_cont_frame_rejected_on_flow_less_target(lib_dir):
    ref, port = both(_flowless, lib_dir)
    assert port == ref


# ---------------------------------------------------------------------------
# descriptor codec


def _descriptor(pkg, lib_dir):
    fl = pkg.flow
    D = fl.descriptor
    chain = fl.Chain("origin-host", 42, (
        fl.Hop("a", "f1", b"\x01" * 16, {"mode": "raw"}),
        fl.Scatter((fl.Hop("b", "f2", b"\x02" * 16, None),
                    fl.Hop("c", "f2", b"\x02" * 16,
                           {"mode": "static", "static": {"k": 1}}))),
        fl.Hop("d", "f3", b"\x03" * 16, None, expect=2, gid=9, idx=0,
               kind=D.KIND_GATHER),
    ))
    packed = fl.pack_chain(chain)
    assert fl.parse_chain(packed) == chain
    errs = []
    for bad in (b"\x00\x01", packed + b"xx"):
        with pytest.raises(fl.FlowError) as e:
            fl.parse_chain(bad)
        errs.append(str(e.value))
    assert issubclass(fl.FlowError, pkg.core.frame.FrameError)
    assert fl.apply_bind(None, b"v") == b"v"
    assert fl.apply_bind({"mode": "kw", "key": "d", "static": {"t": 2}},
                         b"v") == {"t": 2, "d": b"v"}
    assert fl.apply_bind({"mode": "static", "static": {"a": 1}},
                         b"v") == {"a": 1}
    with pytest.raises(fl.FlowError) as e:
        fl.apply_bind({"mode": "nope"}, b"v")
    errs.append(str(e.value))
    arrival = fl.Hop("g", "f4", b"\x04" * 16, {"mode": "kw", "key": "x"},
                     expect=3, gid=0xFFFF, idx=2,
                     kind=D.KIND_GATHER_ARRIVAL)
    packed2 = fl.pack_chain(fl.Chain("o", 2 ** 64 - 1, (arrival,)))
    assert fl.parse_chain(packed2).entries == (arrival,)
    for bad_chain in (fl.Chain("o", 1, (fl.Scatter(()),)),
                      fl.Chain("o", 1, (fl.Hop("a", "f", b"\x00"),)),
                      fl.Chain("o", 1, (fl.Hop("a", "f", b"\x00" * 16,
                                               expect=1 << 16,
                                               kind=D.KIND_GATHER),))):
        with pytest.raises(fl.FlowError) as e:
            fl.pack_chain(bad_chain)
        errs.append(str(e.value))
    return packed, packed2, errs


def test_descriptor_roundtrip_and_errors(lib_dir):
    ref, port = both(_descriptor, lib_dir)
    assert port == ref


def _chunks(pkg, lib_dir):
    w = pkg.wire
    chunks = [b"", b"abc", b"\x00" * 100]
    packed = w.pack_chunks(chunks)
    assert w.unpack_chunks(packed) == chunks
    err = w.RemoteExecutionError("ValueError", "boom", hop="f@peer")
    assert err.hop == "f@peer" and "at f@peer" in str(err)
    return packed, str(err), w.encode_error(ValueError("boom"), hop="f@peer")


def test_wire_chunk_framing(lib_dir):
    ref, port = both(_chunks, lib_dir)
    assert port == ref


# ---------------------------------------------------------------------------
# chains end to end


def _mk_engine(pkg, lib_dir, peers=("csd", "dpu", "agg"), **kw):
    X = pkg.transport
    eng = pkg.flow.FlowEngine(ctx(pkg, "host", lib_dir), default_timeout=20.0,
                              **kw)
    fabs = {"csd": X.LoopbackFabric(), "dpu": X.RdmaFabric(),
            "agg": X.RdmaFabric()}
    for p in peers:
        eng.add_node(p, fabs.get(p, X.LoopbackFabric()))
    return eng


def _blob(runs):
    return struct.pack("<I", len(runs)) + b"".join(
        struct.pack("<II", v, c) for v, c in runs)


def _etl(bind_thr=50):
    return lambda fl: (fl.Flow("etl")
                       .stage("csd_decompress", at="csd")
                       .then("dpu_filter", at="dpu",
                             bind={"mode": "kw", "key": "data",
                                   "static": {"threshold": bind_thr}})
                       .then("host_aggregate", at="agg"))


def _three_stage(pkg, lib_dir):
    eng = _mk_engine(pkg, lib_dir)
    fut = eng.submit(_etl()(pkg.flow), _blob([(7, 10), (100, 5), (7, 3)]))
    assert fut.result() == {"count": 5, "sum": 500, "min": 100, "max": 100}
    assert eng.origin.dispatcher.stats["sent"] == 1
    assert eng.nodes["csd"].stats["forwards"] == 1
    assert eng.nodes["dpu"].stats["forwards"] == 1
    assert eng.nodes["agg"].stats["replies"] == 1
    assert eng.pending() == 0 and eng.stats["orphan_replies"] == 0
    return eng, [flow_outcome(fut)]


def test_three_stage_chain_host_never_sees_intermediates(lib_dir):
    held(_three_stage, lib_dir)


def _slim_after_warmup(pkg, lib_dir):
    eng = _mk_engine(pkg, lib_dir)
    flow = (pkg.flow.Flow("w").stage("csd_decompress", at="csd")
            .then("host_aggregate", at="agg"))
    futs = []
    for _ in range(3):
        futs.append(eng.submit(flow, _blob([(9, 4)])))
        assert futs[-1].result()["count"] == 4
    slim = sum(p.stats["slim_sent"] for node in eng.nodes.values()
               for p in node.dispatcher.peers.values())
    assert slim > 0
    return eng, [flow_outcome(f) for f in futs] + [slim]


def test_chain_goes_slim_after_warmup(lib_dir):
    held(_slim_after_warmup, lib_dir)


def _shard_edges(pkg, eng, placement):
    edges = {0: [(0, 1, 0.9), (1, 0, 0.2)],
             1: [(2, 3, 0.8), (3, 2, 0.7), (2, 0, 0.1)]}
    for sid, peer in placement.items():
        eng.nodes[peer].target_args.setdefault("shards", {})[sid] = \
            pkg.graph.pack_csr_shard(sid * 2, 2, edges[sid])


def _count_query(fl, at):
    return (fl.Flow("count")
            .scatter("graph_count", at=at,
                     binds=[{"mode": "static",
                             "static": {"sid": s, "wmin": 0.5}}
                            for s in range(len(at))])
            .gather("flow_reduce", at="agg"))


def _scatter_gather(pkg, lib_dir):
    eng = _mk_engine(pkg, lib_dir)
    _shard_edges(pkg, eng, {0: "csd", 1: "dpu"})
    fut = eng.submit(_count_query(pkg.flow, ["csd", "dpu"]), None)
    assert fut.result() == 3
    agg = eng.nodes["agg"]
    assert agg.stats["gather_buffered"] == 2
    assert agg.stats["gather_reduced"] == 1
    assert not agg.gathers
    assert eng.stats["completed"] == 1
    return eng, [flow_outcome(fut)]


def test_scatter_gather_partial_aggregation(lib_dir):
    held(_scatter_gather, lib_dir)


def _late_gather(pkg, lib_dir):
    fl = pkg.flow
    eng = _mk_engine(pkg, lib_dir)
    agg = eng.nodes["agg"]
    g = fl.Hop("agg", "flow_reduce", eng.digest_of("flow_reduce"), None,
               expect=2, gid=1, idx=0,
               kind=fl.descriptor.KIND_GATHER_ARRIVAL)
    eng.origin.continue_chain(fl.Chain("host", 98765, (g,)), 3)
    eng.drain()
    assert agg.stats.get("gather_orphans", 0) == 1
    assert not agg.gathers
    return eng, []


def test_late_gather_arrival_after_resolve_is_dropped(lib_dir):
    held(_late_gather, lib_dir)


def _scatter_needs_gather(pkg, lib_dir):
    fl = pkg.flow
    eng = _mk_engine(pkg, lib_dir)
    msgs = []
    with pytest.raises(fl.FlowError, match="followed by a gather") as e:
        fl.Flow("bad").scatter("graph_count", at=["csd"]).compile(eng)
    msgs.append(str(e.value))
    with pytest.raises(fl.FlowError,
                       match="without a preceding scatter") as e:
        fl.Flow("bad").gather("flow_reduce", at="agg").compile(eng)
    msgs.append(str(e.value))
    return eng, msgs


def test_scatter_must_be_followed_by_gather(lib_dir):
    held(_scatter_needs_gather, lib_dir)


def _short_circuit(pkg, lib_dir):
    eng = _mk_engine(pkg, lib_dir)
    bad = (pkg.flow.Flow("bad")
           .stage("csd_decompress", at="csd")
           .then("graph_count", at="dpu",
                 bind={"mode": "static", "static": {"sid": 99, "wmin": 0.0}})
           .then("host_aggregate", at="agg"))
    fut = eng.submit(bad, _blob([(1, 2)]))
    with pytest.raises(pkg.tasks.RemoteExecutionError) as ei:
        fut.result()
    assert ei.value.hop == "graph_count@dpu"
    assert ei.value.remote_type == "ValueError"
    assert eng.nodes["agg"].ctx.stats["executed"] == 0
    assert eng.nodes["dpu"].stats["errors"] == 1
    assert eng.pending() == 0
    return eng, [flow_outcome(fut)]


def test_error_short_circuits_chain(lib_dir):
    held(_short_circuit, lib_dir)


def _unknown_digest(pkg, lib_dir):
    fl = pkg.flow
    eng = _mk_engine(pkg, lib_dir)
    entries = (fl.Hop("csd", "csd_decompress",
                      eng.digest_of("csd_decompress")),
               fl.Hop("dpu", "host_aggregate", b"\xde\xad" * 8))
    eng._corr += 1
    fut = pkg.tasks.Future(eng, eng._corr, "csd", "forged")
    eng.futures[eng._corr] = fut
    eng.origin.continue_chain(fl.Chain("host", eng._corr, entries),
                              _blob([(1, 1)]))
    with pytest.raises(pkg.tasks.RemoteExecutionError,
                       match="digest mismatch"):
        fut.result()
    return eng, [flow_outcome(fut)]


def test_unknown_digest_short_circuits(lib_dir):
    held(_unknown_digest, lib_dir)


def _placement(pkg, lib_dir):
    eng = _mk_engine(pkg, lib_dir)
    eng.add_node("dpu2", pkg.transport.RdmaFabric())
    flow = (pkg.flow.Flow("pick")
            .stage("csd_decompress", at="csd")
            .then("dpu_filter", at=["dpu", "dpu2"],
                  bind={"mode": "kw", "key": "data",
                        "static": {"threshold": 0}})
            .then("host_aggregate", at="agg"))
    picks = [flow.compile(eng)[1].peer]
    csd = eng.nodes["csd"]
    bump = pkg.core.register_ifunc(csd.ctx, "counter_bump")
    for _ in range(6):
        assert csd.dispatcher.send_ifunc("dpu", bump, b"bg")
    picks.append(flow.compile(eng)[1].peer)
    assert picks == ["dpu", "dpu2"]
    costs = [csd.pricer.hop_cost(p, 4096) for p in ("dpu", "dpu2")]
    fut = eng.submit(flow, _blob([(5, 3)]))
    assert fut.result()["count"] == 3
    eng.drain()
    return eng, [picks, costs, flow_outcome(fut)]


def test_placement_prices_hops_around_congestion(lib_dir):
    held(_placement, lib_dir)


def _device_nodes(pkg, lib_dir):
    class FakeDeviceFabric:
        kind = "device"

    eng = _mk_engine(pkg, lib_dir, peers=())
    with pytest.raises(pkg.transport.TransportError, match="device") as e:
        eng.add_node("tpu", FakeDeviceFabric())
    return eng, [str(e.value)]


def test_flow_rejects_device_nodes(lib_dir):
    held(_device_nodes, lib_dir)


# ---------------------------------------------------------------------------
# SLIM traffic carrying continuation descriptors (the NACK fallback)


def _slim_nack(pkg, lib_dir):
    eng = _mk_engine(pkg, lib_dir)
    blob = _blob([(60, 4)])
    flow = (pkg.flow.Flow("nack").stage("csd_decompress", at="csd")
            .then("host_aggregate", at="agg"))
    f1 = eng.submit(flow, blob)
    assert f1.result()["count"] == 4
    csd = eng.nodes["csd"].ctx
    assert csd.link_cache.evict("csd_decompress",
                                eng.digest_of("csd_decompress"))
    f2 = eng.submit(flow, blob)
    assert f2.result() == {"count": 4, "sum": 240, "min": 60, "max": 60}
    origin_peer = eng.origin.dispatcher.peers["csd"]
    assert origin_peer.stats["nacks"] >= 1
    assert origin_peer.stats["resent"] >= 1
    assert eng.pending() == 0 and eng.stats["orphan_replies"] == 0
    return eng, [flow_outcome(f1), flow_outcome(f2)]


def test_slim_cont_frame_survives_nack_retransmit(lib_dir):
    held(_slim_nack, lib_dir)


def _lru_churn(pkg, lib_dir):
    X = pkg.transport
    eng = pkg.flow.FlowEngine(ctx(pkg, "host", lib_dir), default_timeout=20.0)
    hopctx = ctx(pkg, "hop", lib_dir, link_cache=pkg.LinkCache(capacity=1))
    eng.add_node("hop", X.LoopbackFabric(), hopctx)
    eng.add_node("agg", X.RdmaFabric())
    f1 = (pkg.flow.Flow("a").stage("csd_decompress", at="hop")
          .then("host_aggregate", at="agg"))
    f2 = (pkg.flow.Flow("b").stage("flow_xform", at="hop")
          .then("host_aggregate", at="agg"))
    blob, raw = _blob([(3, 2)]), struct.pack("<II", 3, 3)
    outs = []
    for _ in range(3):
        a, b = eng.submit(f1, blob), None
        assert a.result()["count"] == 2
        b = eng.submit(f2, raw)
        assert b.result()["count"] == 2
        outs += [flow_outcome(a), flow_outcome(b)]
    peer = eng.origin.dispatcher.peers["hop"]
    assert peer.stats["nacks"] >= 2
    assert peer.stats["resent"] == peer.stats["nacks"]
    assert hopctx.link_cache.stats()["evictions"] >= 4
    assert eng.pending() == 0 and eng.stats["orphan_replies"] == 0
    assert eng.stats["completed"] == 6
    return eng, outs + [hopctx.link_cache.stats()]


def test_lru_churn_with_cont_descriptors(lib_dir):
    held(_lru_churn, lib_dir)


# ---------------------------------------------------------------------------
# dispatcher liveness floor


def _mk_runtime(pkg, lib_dir):
    X = pkg.transport
    rt = pkg.tasks.TaskRuntime(
        ctx(pkg, "src", lib_dir),
        engine=X.ProgressEngine(flush_threshold=64,
                                inflight_window="trailer"),
        default_timeout=10.0)
    rt.add_peer("p", X.RdmaFabric(), ctx(pkg, "p", lib_dir),
                n_slots=4, slot_size=16 << 10, target_args={})
    return rt


def _drain_deadline(pkg, lib_dir):
    rt = _mk_runtime(pkg, lib_dir)
    h = pkg.core.register_ifunc(rt.ctx, "task_sum")
    peer = rt.dispatcher.peers["p"]
    lane = peer.rings[0]
    lane.mailbox.sweep = lambda *a, **k: []
    futs = [rt.submit("p", h, b"\x01"), rt.submit("p", h, b"\x02")]
    t0 = time.monotonic()
    rt.drain(deadline=0.15)
    assert time.monotonic() - t0 >= 0.15
    for fut in futs:
        with pytest.raises(pkg.transport.TransportError, match="deadline"):
            fut.result()
    assert peer.stats["timed_out"] == 2
    assert rt.dispatcher.stats["timed_out"] == 2
    assert not lane.inflight
    assert rt.pending() == 0
    del lane.mailbox.sweep
    return rt, [outcome(f) for f in futs]


def same_but_rounds(rrt, prt):
    """``same_runtime``, but for the drain's rounds and the engine's
    flushes (one a round): a drain with a deadline cranks for wall time,
    so those counts are the host's speed."""
    for rt in (rrt, prt):
        assert rt.dispatcher.stats["poll_rounds"] >= 1
        rt.dispatcher.stats["poll_rounds"] = 0
        rt.dispatcher.engine.stats["flushes"] = 0
    same_runtime(rrt, prt)


def test_drain_deadline_fails_wedged_futures(lib_dir):
    (rrt, rout), (prt, pout) = both(_drain_deadline, lib_dir)
    assert pout == rout
    same_but_rounds(rrt, prt)


def _oldest_age(pkg, lib_dir):
    rt = _mk_runtime(pkg, lib_dir)
    h = pkg.core.register_ifunc(rt.ctx, "task_sum")
    assert rt.dispatcher.per_peer_stats()["p"]["oldest_inflight_s"] == 0.0
    lane = rt.dispatcher.peers["p"].rings[0]
    lane.mailbox.sweep = lambda *a, **k: []
    fut = rt.submit("p", h, b"\x01")
    time.sleep(0.02)
    rt.progress()
    assert rt.dispatcher.per_peer_stats()["p"]["oldest_inflight_s"] >= 0.02
    rt.drain(deadline=0.01)
    assert fut.done()
    assert rt.dispatcher.per_peer_stats()["p"]["oldest_inflight_s"] == 0.0
    del lane.mailbox.sweep
    return rt, [outcome(fut)]


def test_oldest_inflight_age_surfaces_in_stats(lib_dir):
    (rrt, rout), (prt, pout) = both(_oldest_age, lib_dir)
    assert pout == rout
    same_but_rounds(rrt, prt)


def _drain_no_deadline(pkg, lib_dir):
    rt = _mk_runtime(pkg, lib_dir)
    h = pkg.core.register_ifunc(rt.ctx, "task_sum")
    fut = rt.submit("p", h, b"\x02\x03")
    rt.drain()
    assert fut.result() == 5
    assert rt.dispatcher.stats.get("timed_out", 0) == 0
    return rt, [outcome(fut)]


def test_drain_without_deadline_unchanged(lib_dir):
    (rrt, rout), (prt, pout) = both(_drain_no_deadline, lib_dir)
    assert pout == rout
    same_runtime(rrt, prt)


# ---------------------------------------------------------------------------
# device-mesh reply-path edge cases


@pytest.fixture()
def device_rts(lib_dir, monkeypatch):
    """The reference's device runtime (one jax device, its μVM through the
    jnp interpreter) and the port's on ``DeviceMeshFabric(1, "cpu")``,
    the same ``uvm_affine`` program and W = 2 I."""
    import jax
    import jax.numpy as jnp

    from repro.core.codegen import deserialize_uvm as rdes
    from repro.parallel.sharding import make_mesh
    from repro.transport.device_fabric import DeviceMeshFabric as RDMF
    from repro_torch.core.codegen import deserialize_uvm as pdes
    from repro_torch.transport import DeviceMeshFabric as PDMF

    monkeypatch.setattr(RDM, "ifunc_vm", _jnp_uvm)
    W = np.eye(T, dtype=np.float32) * 2.0
    rts = []
    for pkg in PKGS:
        X = pkg.transport
        rt = pkg.tasks.TaskRuntime(
            ctx(pkg, "src", lib_dir),
            engine=X.ProgressEngine(inflight_window="trailer"),
            default_timeout=60.0)
        h = pkg.core.register_ifunc(rt.ctx, "uvm_affine")
        if pkg is RPKG:
            mesh = make_mesh((len(jax.devices()),), ("model",))
            fab, prog = RDMF(mesh, "model", shift=0), rdes(h.lib.code)
            ext = jnp.broadcast_to(jnp.asarray(W)[None, None],
                                   (mesh.shape["model"], 1, T, T))
        else:
            fab, prog = PDMF(1, shift=0, device="cpu"), pdes(h.lib.code)
            ext = torch.from_numpy(np.broadcast_to(W, (1, 1, T, T)).copy())
        rt.add_peer("tpu", fab, None, n_slots=2, slot_size=128 << 10,
                    prog=prog, externals=ext)
        rts.append((rt, h))
    return rts


def _value(v):
    return np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)


def test_device_orphan_reply_after_cancel(device_rts):
    """A device sweep result whose future was cancelled routes as an
    orphan in both packages; the lane stays usable."""
    x = np.ones((1, T, T), np.float32)
    outs = []
    for rt, h in device_rts:
        fut = rt.submit("tpu", h, x)
        assert rt.cancel(fut)
        rt.drain()
        assert rt.stats["orphan_replies"] == 1
        with pytest.raises(Exception):
            fut.result(timeout=0.01)
        out = _value(rt.submit("tpu", h, x).result())
        np.testing.assert_allclose(out[0], np.maximum(x[0] * 2.0, 0),
                                   rtol=1e-4, atol=1e-5)
        assert rt.stats["orphan_replies"] == 1
        outs.append((out, outcome(fut)))
    (rout, rfut), (pout, pfut) = outs
    assert pfut == rfut
    np.testing.assert_allclose(pout, rout, rtol=TOL, atol=TOL)
    (rrt, _), (prt, _) = device_rts
    assert prt.stats == rrt.stats
    assert prt.dispatcher.stats == rrt.dispatcher.stats


def test_device_duplicate_corr_reply_ignored(device_rts):
    """A replayed device correlation routes as an orphan and cannot
    double-resolve the future, in both packages."""
    x = np.ones((1, T, T), np.float32)
    vals = []
    for rt, h in device_rts:
        fut = rt.submit("tpu", h, x)
        val = _value(fut.result())
        rt.dispatcher._route_reply(fut.corr_id, "tpu", np.zeros(3), False,
                                   decoded=True)
        assert rt.stats["orphan_replies"] == 1
        np.testing.assert_array_equal(_value(fut.result()), val)
        vals.append(val)
    np.testing.assert_allclose(vals[1], vals[0], rtol=TOL, atol=TOL)
    (rrt, _), (prt, _) = device_rts
    assert prt.stats == rrt.stats


def test_device_lane_pending_corr_fails_on_deadline(device_rts):
    """``fail_inflight`` covers device lanes in both packages: a staged
    but never swept send's future fails with ``TransportError``."""
    outs = []
    for (rt, h), pkg in zip(device_rts, PKGS):
        lane = rt.dispatcher.peers["tpu"].rings[0]
        lane.mailbox.sweep = lambda *a, **k: []
        fut = rt.submit("tpu", h, np.ones((1, T, T), np.float32))
        rt.drain(deadline=0.1)
        with pytest.raises(pkg.transport.TransportError, match="device lane"):
            fut.result()
        assert not lane.corr_by_coords
        outs.append(outcome(fut))
    assert outs[1] == outs[0]
    (rrt, _), (prt, _) = device_rts
    assert prt.stats == rrt.stats
    rounds = "poll_rounds"      # the deadline's wall time, the host's speed
    assert {k: v for k, v in prt.dispatcher.stats.items() if k != rounds} \
        == {k: v for k, v in rrt.dispatcher.stats.items() if k != rounds}


# ---------------------------------------------------------------------------
# beyond tests/test_flow.py


def _coalesced_scatter(pkg, lib_dir):
    """Two branches at one peer: once the lane is warm, the origin's
    forwards of a scatter coalesce into one aggregate container of two
    continuation sub-records."""
    eng = _mk_engine(pkg, lib_dir, coalesce=True)
    _shard_edges(pkg, eng, {0: "dpu", 1: "dpu"})
    q = _count_query(pkg.flow, ["dpu", "dpu"])
    futs = []
    for _ in range(3):
        futs.append(eng.submit(q, None))
        assert futs[-1].result() == 3
    dpu = eng.origin.dispatcher.peers["dpu"]
    assert dpu.stats["agg_sent"] >= 1 and dpu.stats["agg_subs"] >= 2
    assert eng.nodes["agg"].stats["gather_reduced"] == 3
    eng.drain()
    return eng, [flow_outcome(f) for f in futs]


def test_coalesced_scatter_shares_an_aggregate_container(lib_dir):
    held(_coalesced_scatter, lib_dir)


def _peer_death_replays(pkg, lib_dir):
    """A dead node is retired from every dispatcher of the mesh and the
    chains in flight are replayed or failed: a finished chain is left
    alone, one in flight through the dead (pinned) stage fails with the
    reference's TransportError, and the survivors serve again."""
    eng = _mk_engine(pkg, lib_dir)
    done = eng.submit(_etl()(pkg.flow), _blob([(70, 2)]))
    assert done.result()["count"] == 2
    doomed = eng.submit(_etl()(pkg.flow), _blob([(90, 1)]))
    assert eng.on_peer_death("dpu") == 0       # pinned: nothing to replay
    assert "dpu" not in eng.nodes
    assert all("dpu" not in nd.dispatcher.peers for nd in eng.nodes.values())
    with pytest.raises(pkg.transport.TransportError,
                       match="cannot be rebuilt"):
        doomed.result()
    after = eng.submit(pkg.flow.Flow("x").stage("flow_xform", at="csd"),
                       b"abc")
    assert after.result() == b"cba"
    assert eng.stats["replay_failed"] == 1 and eng.pending() == 0
    return eng, [flow_outcome(f) for f in (done, doomed, after)]


def test_on_peer_death_replays_past_remove_peer(lib_dir):
    held(_peer_death_replays, lib_dir)


def test_uvm_chain_matches_reference(lib_dir, monkeypatch):
    """Phase 23 (d)'s two-hop ``uvm_affine`` chain at 4 chains (``dpu_a``
    congested before the third), the reference's μVM through the jnp
    interpreter and the port's own library (its tensor payload codec on
    the second hop): the same picks and engine state, each result within
    2e-5 of the reference's and of relu(relu(x @ W_dpu) @ W_agg)."""
    monkeypatch.setattr(RKO, "ifunc_vm", _jnp_uvm)
    rng = np.random.default_rng(23)
    Ws = {n: (rng.standard_normal((T, T)) * 0.05).astype(np.float32)
          for n in chip_smoke.CHAIN_NODES}
    xs = rng.standard_normal((4, 2, T, T)).astype(np.float32)
    runs = []
    for pkg, w in ((RPKG, Ws),
                   (PPKG, {k: torch.from_numpy(v) for k, v in Ws.items()})):
        eng = chip_smoke.chain_engine(pkg, w, lib_dir=lib_dir)
        if pkg is PPKG:     # the port's own uvm_affine: the same program
            pkg.core.register_ifunc(eng.ctx, "uvm_affine",
                                    pkg.registry.lib_dir())
        runs.append((eng, *chip_smoke.uvm_chains(pkg, eng, xs,
                                                 congest_at=2)))
    peng = runs[1][0]
    lib = peng.libraries[peng.digest_of("uvm_affine")]
    assert "repro_torch" in lib.payload_init.__code__.co_filename
    (reng, rpicks, routs), (peng, ppicks, pouts) = runs
    assert ppicks == rpicks and set(ppicks) == {"dpu_a", "dpu_b"}
    same_flow(reng, peng, exact=False)
    for x, p, r, pick in zip(xs, pouts, routs, ppicks):
        assert isinstance(p, np.ndarray) and p.shape == (2, T, T)
        np.testing.assert_allclose(p, r, rtol=TOL, atol=TOL)
        want = np.maximum(np.maximum(x @ Ws[pick], 0) @ Ws["agg"], 0)
        np.testing.assert_allclose(p, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# examples/storage_pipeline.py, whole


def keeping(mp, engine_cls, submitted):
    """Patch ``engine_cls.submit`` to keep each submitted flow's label,
    compiled entries and future in ``submitted``."""
    submit = engine_cls.submit

    def keeping_submit(self, flow, args):
        fut = submit(self, flow, args)
        submitted.append((flow.label,
                          self._chains[fut.corr_id]["entries"], fut))
        return fut
    mp.setattr(engine_cls, "submit", keeping_submit)


@pytest.fixture(scope="module")
def reference_pipeline(tmp_path_factory):
    """The reference's ``examples/storage_pipeline.py`` run whole, its
    trace exported to a temporary directory, every submitted flow's
    compiled entries and future kept."""
    path = REPO / "examples" / "storage_pipeline.py"
    tmp = tmp_path_factory.mktemp("storage")
    submitted = []
    g = {"__name__": "__main__", "__file__": str(tmp / path.name)}
    with pytest.MonkeyPatch.context() as mp:
        keeping(mp, RFE.FlowEngine, submitted)
        with pytest.raises(SystemExit) as done:
            exec(compile(path.read_text(), str(path), "exec"), g)
    assert done.value.code == 0
    assert (tmp / "storage_trace.json").exists()
    g["submitted"] = submitted
    return g


def test_storage_pipeline_matches_reference(reference_pipeline, lib_dir,
                                            tmp_path):
    """``chip_smoke.storage_pipeline`` (phase 23 (a), (b)) on the port at
    the example's seed against the reference's whole example: every
    submitted flow's descriptor bytes and outcome, every batch's pick and
    result, Act 2's total, Act 3's hop, Act 4's result and wire bytes, and
    both engines' whole state (``same_flow``: per-node stats, dispatchers,
    rings, spans)."""
    ref = reference_pipeline
    submitted = []
    with pytest.MonkeyPatch.context() as mp:
        keeping(mp, PFL.FlowEngine, submitted)
        res = chip_smoke.storage_pipeline(PPKG, np, tmp_path,
                                          lib_dir=lib_dir)
    assert [(label, PFL.pack_chain(PFL.Chain("host", 1, e)))
            for label, e, _ in submitted] == \
        [(label, RFL.pack_chain(RFL.Chain("host", 1, e)))
         for label, e, _ in ref["submitted"]]
    assert [flow_outcome(f) for _, _, f in submitted] == \
        [flow_outcome(f) for _, _, f in ref["submitted"]]
    etl = [(e[1].peer, f.result()) for label, e, f in ref["submitted"]
           if label == "etl"]
    assert [(p, got) for p, got, _ in res["rows"]] == etl
    assert res["total"] == ref["total"] == 980
    bad = [f for label, _, f in ref["submitted"] if label == "bad-probe"]
    assert res["err"].hop == bad[0]._exc.hop == "graph_count@dpu_a"
    assert str(res["err"]) == str(bad[0]._exc)
    assert res["bulk"]["result"] == ref["got"]
    assert res["bulk"]["wire"] == ref["wire"]
    assert res["bulk"]["chunks"] == ref["n_chunks"]
    reng, peng = ref["eng"], res["eng"]
    assert (reng.stats["submitted"], reng.stats["completed"],
            reng.stats["errors"]) == (8, 7, 1)
    same_flow(reng, peng)
    assert reng.origin.dispatcher.stats["sent"] == 11


def test_chip_smoke_phase23_parts_on_cpu():
    """Phase 23 (c) and (e) small on the CPU with the port's own library
    ((d) is ``test_uvm_chain_matches_reference``): the full-size ETL's
    batches (4 of them, at its record count and slots, congestion in
    between) pass Act 1's gates under the host timers, which ``restore``
    takes off again; ``fig_flow`` runs both arms at both stage counts."""
    eng = chip_smoke.flow_engine(PPKG, slot=chip_smoke.ETL_SLOT)
    spent = {}
    restore = chip_smoke.flow_timers(eng, spent)
    try:
        rows = chip_smoke.etl_batches(
            PPKG, np, eng, np.random.default_rng(11), batches=4,
            congest_at=2, records=chip_smoke.ETL_RECORDS)
    finally:
        restore()
    assert len(rows) == 4 and {p for p, _, _ in rows} == {"dpu_a", "dpu_b"}
    assert all(n <= chip_smoke.ETL_RECORDS * 2 for _, _, n in rows)
    assert {"submit", "encode", "decode", "poll@csd", "send@csd",
            "fn csd_decompress@csd", "fn host_aggregate@agg"} <= set(spent)
    from repro_torch.tasks import wire
    assert "submit" not in eng.__dict__ and wire.encode.__name__ == "encode"
    rows = chip_smoke.fig_flow(PPKG, iters=2)
    assert sorted(rows) == [3, 5]
    assert all(v > 0 for r in rows.values() for v in r.values())
