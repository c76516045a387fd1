"""The port's elastic recovery (``repro_torch.runtime.elastic``,
``repro_torch.transport.faults`` and the Dispatcher's ``remove_peer``,
``faults`` and ``pollers``) held against the reference's: the 20 cases of
``tests/test_elastic.py``, each run as the same scenario through both
packages on the same inputs.

Each scenario builds its runtime, controller and flow engine with one
package (the port's contexts at ``device="cpu"``), loading ``ifunc_libs/``
into both registries so PYBC frames (and the manifests' digests) are
equal bit for bit.  Besides the reference test's own assertions, the two
runs must agree on every future's outcome, the runtime and its dispatcher
(``same_runtime``: per-peer stats with no stat left out, slab, ring and
reply-ring bytes, caches, obs counters and the flight recorder), the
controller (``same_elastic``: its stats, the fleet's members and
generation, each control ring's cursors, bytes and beat state, the
warm-cache manifests) and, for the flow cases, the engines
(``same_flow``, with ``repro_torch.flow``).  One more case holds the
recovery's order (manifest snapshot, ``fail_inflight``, ``remove_peer``,
generation, shard moves and ``rebalance``, ``flow.on_peer_death``, the
``on_death`` callbacks) to the reference's.
"""

import struct
import types

import pytest

import repro.runtime as RR
import repro_torch.runtime as PR
from test_torch_flow import PPKG as _PPKG
from test_torch_flow import RPKG as _RPKG
from test_torch_flow import flow_outcome, same_flow
from test_torch_tasks import outcome, same_runtime
from test_torch_transport import _mailbox_bytes, ctx, same_run

RPKG = types.SimpleNamespace(**vars(_RPKG), runtime=RR)
PPKG = types.SimpleNamespace(**vars(_PPKG), runtime=PR)
PKGS = (RPKG, PPKG)
DEADLINE = 0.3


def _mk_rt(pkg, lib_dir, names=("a", "b"), **peer_kw):
    X = pkg.transport
    rt = pkg.tasks.TaskRuntime(
        ctx(pkg, "src", lib_dir),
        engine=X.ProgressEngine(flush_threshold=64, inflight_window="trailer"),
        default_timeout=10.0)
    fabs, ctxs = {}, {}
    for i, name in enumerate(names):
        fabs[name] = X.RdmaFabric() if i % 2 == 0 else X.LoopbackFabric()
        ctxs[name] = ctx(pkg, name, lib_dir, link_mode="remote")
        rt.add_peer(name, fabs[name], ctxs[name], n_slots=4,
                    slot_size=16 << 10, target_args={}, **peer_kw)
    return rt, fabs, ctxs


def _mk_ec(pkg, lib_dir, names=("a", "b"), *, injector=None, placement=None,
           flow=None, auto_poll=False):
    rt, fabs, ctxs = _mk_rt(pkg, lib_dir, names)
    fleet = pkg.runtime.FleetState(list(names), heartbeat_deadline=DEADLINE)
    ec = pkg.runtime.ElasticController(
        rt, fleet, injector=injector, placement=placement, flow=flow,
        lib_dir=lib_dir, auto_poll=auto_poll)
    for name in names:
        ec.watch(name, fabs[name], ctxs[name], now=0.0)
    return rt, ec, fabs, ctxs


def _settle(rt, fut, rounds=80):
    rt.flush()
    for _ in range(rounds):
        rt.progress()
        if fut.done():
            return
    raise AssertionError(f"future never resolved: {fut!r}")


def _until_dead(ec):
    t, dead = 0.0, []
    while not dead:
        t += 0.1
        dead = ec.step(now=t)
        assert t < 10 * DEADLINE
    return t, dead


def _fleet_state(fleet):
    return (fleet.generation, fleet.deadline,
            {w: (i.alive, i.last_heartbeat, i.step_times, i.backup_of)
             for w, i in fleet.workers.items()})


def _targs(targs):
    return {k: v for k, v in targs.items() if k != "relink"}


def same_elastic(ref, port):
    """The two controllers ended in the same observable state."""
    assert port.stats == ref.stats
    assert _fleet_state(port.fleet) == _fleet_state(ref.fleet)
    assert port.beat_interval == ref.beat_interval
    assert list(port.members) == list(ref.members)
    for name, rm in ref.members.items():
        pm = port.members[name]
        assert (pm.tail, pm.seq, pm.folded, pm.last_beat, pm.active,
                pm.manifest) == (rm.tail, rm.seq, rm.folded, rm.last_beat,
                                 rm.active, rm.manifest), name
        assert _mailbox_bytes(pm.mailbox) == _mailbox_bytes(rm.mailbox), name
        assert (pm.mailbox.head, pm.mailbox.consumed) == \
            (rm.mailbox.head, rm.mailbox.consumed), name
        assert _targs(pm.targs) == _targs(rm.targs), name
        assert pm.ctx.stats == rm.ctx.stats, name
    assert len(port.on_death) == len(ref.on_death)


def held(scenario, lib_dir):
    """Run ``scenario`` through both packages: its outcome (``out``) and
    every runtime, dispatcher, controller and flow engine it returns must
    agree."""
    ref, port = (scenario(pkg, lib_dir) for pkg in PKGS)
    assert port["out"] == ref["out"]
    if "rt" in ref:
        same_runtime(ref["rt"], port["rt"])
    if "d" in ref:
        same_run(ref["d"], port["d"])
    if "ec" in ref:
        same_elastic(ref["ec"], port["ec"])
    if "eng" in ref:
        same_flow(ref["eng"], port["eng"])
    return port


# ---------------------------------------------------------------------------
# corr generation bits + FleetState fixes


def _corr_codec(pkg, lib_dir):
    F = pkg.core.frame
    corr = F.make_corr(123, 7)
    assert F.corr_seq(corr) == 123 and F.corr_gen(corr) == 7
    assert F.make_corr(123, 0) == 123          # gen 0 is the legacy corr
    # the sequence wraps under the gen bits instead of spilling into them
    assert F.corr_gen(F.make_corr(F.CORR_SEQ_MASK + 5, 3)) == 3
    return {"out": (corr, F.make_corr(F.CORR_SEQ_MASK + 5, 3),
                    F.CORR_SEQ_MASK)}


def test_corr_generation_codec(lib_dir):
    held(_corr_codec, lib_dir)


def _revival(pkg, lib_dir):
    fl = pkg.runtime.FleetState(["w0", "w1"], heartbeat_deadline=1.0)
    fl.workers["w0"].step_times.append(9.9)
    fl.workers["w0"].backup_of = "w1"
    fl.heartbeat("w0", 0.0)
    fl.heartbeat("w1", 0.0)
    assert fl.sweep_dead(2.0) == ["w0", "w1"] and fl.generation == 1
    gen = fl.generation
    fl.heartbeat("w0", 3.0)                    # revival
    w = fl.workers["w0"]
    assert w.alive and w.step_times == [] and w.backup_of is None
    assert fl.generation == gen + 1
    fl.heartbeat("late", 3.0)                  # late join: also a fresh info
    assert fl.generation == gen + 2 and fl.workers["late"].alive
    return {"out": (_fleet_state(fl), fl.alive(), fl.shard_assignment(5))}


def test_fleet_revival_gets_fresh_workerinfo(lib_dir):
    held(_revival, lib_dir)


# ---------------------------------------------------------------------------
# the fault injector


def _injector(pkg, lib_dir):
    inj = pkg.transport.FaultInjector()
    seen = []
    inj.kill_peer("a", after_delivered=3)
    seen.append(inj.is_down("a", delivered=2))
    seen.append(inj.is_down("a", delivered=3))   # threshold: latches
    seen.append(inj.is_down("a", delivered=0))   # ... even if it rewinds
    assert seen == [False, True, True]
    assert inj.stats["kills"] == 1
    inj.revive("a")
    assert not inj.is_down("a", delivered=99)
    inj.drop_put("b", kth=2)
    drops = [inj.should_drop_put("b") for _ in range(3)]
    assert drops == [False, True, False]       # the 2nd, one-shot
    inj.delay_heartbeats("c", beats=2)
    beats = [inj.should_drop_beat("c") for _ in range(3)]
    assert beats == [True, True, False]
    return {"out": (seen, drops, beats, inj.stats,
                    {n: vars(p) for n, p in inj._peers.items()})}


def test_fault_injector_semantics(lib_dir):
    held(_injector, lib_dir)


def _drop_kth_put(pkg, lib_dir):
    """A dropped put is bookkept as sent at the source but never lands:
    the future only resolves through the liveness deadline."""
    rt, fabs, ctxs = _mk_rt(pkg, lib_dir, names=("a",))
    inj = pkg.transport.FaultInjector()
    rt.dispatcher.faults = inj
    h = pkg.core.register_ifunc(rt.ctx, "task_sum", lib_dir)
    inj.drop_put("a", kth=1)
    fut = rt.submit("a", h, b"\x01\x02")
    rt.flush()
    for _ in range(10):
        rt.progress()
    assert not fut.done()                      # the frame is genuinely gone
    peer = rt.dispatcher.peers["a"]
    assert peer.stats["dropped_puts"] == 1
    assert inj.stats["dropped_puts"] == 1
    dropped_stats = dict(peer.stats)
    assert rt.dispatcher.fail_inflight("deadline") == 1
    with pytest.raises(pkg.transport.TransportError):
        fut.result()
    # a lost put wedges the in-order ring: recovery recycles the peer, and
    # the one-shot injector lets traffic through again
    rt.dispatcher.remove_peer("a")
    rt.add_peer("a", fabs["a"], ctx(pkg, "a", lib_dir, link_mode="remote"),
                n_slots=4, slot_size=16 << 10, target_args={})
    f2 = rt.submit("a", h, b"\x01\x02\x03")
    _settle(rt, f2)
    assert f2.result() == 6
    return {"rt": rt, "out": (outcome(fut), outcome(f2), dropped_stats,
                              inj.stats)}


def test_drop_kth_put_loses_the_frame(lib_dir):
    held(_drop_kth_put, lib_dir)


def test_drop_put_flight_recorded(lib_dir):
    """With ``obs`` on, the dropped put leaves the reference's ``drop_put``
    entry in the flight recorder, after its ``put``."""
    events = []
    for pkg in PKGS:
        rt, _, _ = _mk_rt(pkg, lib_dir, names=("a",))
        inj = pkg.transport.FaultInjector()
        rt.dispatcher.faults = inj
        h = pkg.core.register_ifunc(rt.ctx, "task_sum", lib_dir)
        inj.drop_put("a", kth=2)
        for payload in (b"\x01", b"\x02"):
            rt.submit("a", h, payload)
        rt.flush()
        ev = [e[1:] for e in rt.dispatcher.obs.recorder.events()]
        assert ("drop_put", "a", "task_sum slot=1") in [
            tuple(e[:3]) for e in ev]
        events.append(ev)
    assert events[1] == events[0]


# ---------------------------------------------------------------------------
# remove_peer: full + idempotent


def _remove_peer(pkg, lib_dir):
    rt, fabs, ctxs = _mk_rt(pkg, lib_dir)
    h = pkg.core.register_ifunc(rt.ctx, "task_sum", lib_dir)
    fut = rt.submit("a", h, b"\x01")
    _settle(rt, fut)
    assert fut.result() == 1
    d = rt.dispatcher
    assert "peer.a" in d.obs.metrics._dicts
    d.remove_peer("a")
    assert "a" not in d.peers
    assert "peer.a" not in d.obs.metrics._dicts   # obs alias released
    assert all(tx.peer.name != "a" for tx in d._active_streams)
    d.remove_peer("a")                         # second call: clean no-op
    d.remove_peer("never-was")                 # unknown peer: no-op too
    f2 = rt.submit("b", h, b"\x02\x03")        # survivor unaffected
    _settle(rt, f2)
    assert f2.result() == 5
    return {"rt": rt, "out": (outcome(fut), outcome(f2),
                              sorted(d.obs.metrics._dicts), d._rr,
                              len(d.engine._slabs))}


def test_remove_peer_full_and_idempotent(lib_dir):
    held(_remove_peer, lib_dir)


def _kill_mid_stream(pkg, lib_dir):
    """A peer dying with a stream half-posted: fail_inflight resolves the
    stream's future, remove_peer drops its _StreamTx from the pump."""
    X = pkg.transport
    src = ctx(pkg, "src", lib_dir)
    d = X.Dispatcher(src, X.ProgressEngine(flush_threshold=64))
    d.add_peer("p", X.RdmaFabric(), ctx(pkg, "p", lib_dir, link_mode="remote"),
               n_slots=4, slot_size=32 << 10, target_args={"db": []})
    inj = X.FaultInjector()
    d.faults = inj
    replies = []
    d.reply_router = lambda corr, name, value, is_err, decoded: \
        replies.append((corr, is_err))
    h = pkg.core.register_ifunc(src, "host_aggregate", lib_dir)
    assert d.send_stream("p", h, bytes(20000), corr_id=5,
                         chunk_bytes=2048, window=2)
    inj.kill_peer("p")                         # mid-stream: chunks remain
    assert d._active_streams
    for _ in range(5):
        d.poll()                               # down peer: nothing executes
    assert replies == []
    peer = d.peers["p"]
    posted = dict(peer.stats)
    failed = d.fail_inflight("peer 'p' missed its deadline", peers={"p"})
    assert failed >= 1
    d.remove_peer("p")
    assert replies == [(5, True)]
    assert not d._active_streams               # the pump never touches it
    return {"d": d, "out": (failed, replies, posted, dict(peer.stats),
                            inj.stats)}


def test_kill_mid_stream_resolves_and_cleans(lib_dir):
    held(_kill_mid_stream, lib_dir)


# ---------------------------------------------------------------------------
# heartbeat-driven death + recovery


def _heartbeats(pkg, lib_dir):
    rt, ec, fabs, ctxs = _mk_ec(pkg, lib_dir)
    t = 0.0
    for _ in range(12):                        # 4 deadline windows
        t += 0.1
        assert ec.step(now=t) == []
    assert ec.fleet.alive() == ["a", "b"]
    assert ec.stats["beats_sent"] >= 8
    assert ec.stats["beats_folded"] >= 8       # executed beats, not sends
    return {"rt": rt, "ec": ec, "out": ec.fleet.alive()}


def test_heartbeats_keep_fleet_alive(lib_dir):
    held(_heartbeats, lib_dir)


def _death(pkg, lib_dir):
    X = pkg.transport
    rt, ec, fabs, ctxs = _mk_ec(pkg, lib_dir, injector=X.FaultInjector())
    h = pkg.core.register_ifunc(rt.ctx, "task_sum", lib_dir)
    warm = rt.submit("a", h, b"\x01\x02\x03")
    _settle(rt, warm)
    assert warm.result() == 6                  # peer a's link cache is warm
    ec.injector.kill_peer("a")
    doomed = rt.submit("a", h, b"\x05")        # in flight at death
    ok = rt.submit("b", h, b"\x01" * 4)        # other peer: must survive
    rt.flush()
    gen0 = ec.fleet.generation
    t, dead = _until_dead(ec)
    assert dead == ["a"]
    assert ec.fleet.alive() == ["b"]
    assert "a" not in rt.dispatcher.peers      # retired everywhere
    assert not ec.members["a"].active          # control ring stops too
    assert rt.generation == ec.fleet.generation > gen0
    with pytest.raises(X.TransportError):      # scoped: only a's futures
        doomed.result()
    _settle(rt, ok)
    assert ok.result() == 4
    assert ec.members["a"].manifest            # warm-cache snapshot taken
    assert ec.stats["deaths"] == 1 and ec.stats["futures_failed"] == 1
    return {"rt": rt, "ec": ec,
            "out": (t, dead, rt.generation, outcome(warm), outcome(doomed),
                    outcome(ok), ec.injector.stats)}


def test_death_fires_scoped_recovery(lib_dir):
    held(_death, lib_dir)


def _delayed(pkg, lib_dir):
    """Beats dropped by the injector age the worker toward the deadline;
    once the delay window passes, beats resume and the fleet holds."""
    inj = pkg.transport.FaultInjector()
    rt, ec, fabs, ctxs = _mk_ec(pkg, lib_dir, injector=inj)
    inj.delay_heartbeats("a", beats=2)
    t = 0.0
    for _ in range(2):
        t += 0.11
        assert ec.step(now=t) == []
    assert ec.stats["beats_skipped"] == 2
    for _ in range(6):
        t += 0.11
        assert ec.step(now=t) == []            # resumed beats beat the clock
    assert ec.fleet.alive() == ["a", "b"]
    return {"rt": rt, "ec": ec, "out": (ec.fleet.alive(), inj.stats)}


def test_delayed_heartbeats_then_recovery(lib_dir):
    held(_delayed, lib_dir)


# ---------------------------------------------------------------------------
# generation fencing


def _fenced(pkg, lib_dir):
    """A reply minted by a peer's previous life (gen bits below the fence)
    is dropped as fenced_orphans — it must not resolve anything."""
    F = pkg.core.frame
    rt, fabs, ctxs = _mk_rt(pkg, lib_dir, names=("a",))
    h = pkg.core.register_ifunc(rt.ctx, "task_sum", lib_dir)
    fut = rt.submit("a", h, b"\x01\x02")       # corr carries gen 0
    rt.flush()
    peer = rt.dispatcher.peers["a"]
    peer.fence = 1                             # re-admission happened: epoch 1
    for _ in range(40):
        rt.progress()
    assert not fut.done()                      # the stale reply was dropped
    assert peer.stats["fenced_orphans"] == 1
    assert rt.stats["orphan_replies"] == 0     # fenced != orphan
    rt.generation = 1                          # post-fence epoch resolves
    f2 = rt.submit("a", h, b"\x03\x04")
    assert F.corr_gen(f2.corr_id) == 1
    _settle(rt, f2)
    assert f2.result() == 7
    assert peer.stats["fenced_orphans"] == 1
    return {"rt": rt, "out": (outcome(fut), outcome(f2), f2.corr_id,
                              fut.corr_id)}


def test_stale_generation_reply_is_fenced(lib_dir):
    held(_fenced, lib_dir)


def _readmit(pkg, lib_dir):
    X = pkg.transport
    inj = X.FaultInjector()
    rt, ec, fabs, ctxs = _mk_ec(pkg, lib_dir, injector=inj)
    inj.kill_peer("a")
    t, dead = _until_dead(ec)
    ec.fleet.workers["a"].step_times = [1.0]   # stale-life residue
    ctx2 = ctx(pkg, "a", lib_dir, link_mode="remote")
    peer = ec.readmit("a", X.RdmaFabric(), ctx2, target_args={}, now=t,
                      n_slots=4, slot_size=16 << 10)
    assert peer.fence == ec.fleet.generation > 0
    assert rt.generation == ec.fleet.generation
    w = ec.fleet.workers["a"]
    assert w.alive and w.step_times == []      # fresh WorkerInfo
    assert ec.fleet.alive() == ["a", "b"]
    assert ec.members["a"].active
    for _ in range(3):                         # control ring beats again
        t += 0.11
        assert ec.step(now=t) == []
    return {"rt": rt, "ec": ec, "out": (peer.fence, rt.generation, dead)}


def test_readmit_stamps_fence_and_fresh_workerinfo(lib_dir):
    held(_readmit, lib_dir)


# ---------------------------------------------------------------------------
# warm LinkCache restore


def _kill_warm_a(pkg, lib_dir):
    inj = pkg.transport.FaultInjector()
    rt, ec, fabs, ctxs = _mk_ec(pkg, lib_dir, injector=inj)
    h = pkg.core.register_ifunc(rt.ctx, "task_sum", lib_dir)
    warm = rt.submit("a", h, b"\x01\x02\x03")
    _settle(rt, warm)
    inj.kill_peer("a")
    t, _ = _until_dead(ec)
    return rt, ec, h, t


def _warm_restore(pkg, lib_dir):
    rt, ec, h, t = _kill_warm_a(pkg, lib_dir)
    manifest = ec.members["a"].manifest
    assert manifest and manifest[0][0] == "task_sum"
    # restart = a brand-new context (empty LinkCache), warm restore on
    ctx2 = ctx(pkg, "a", lib_dir, link_mode="remote")
    peer = ec.readmit("a", pkg.transport.RdmaFabric(), ctx2, target_args={},
                      now=t, n_slots=4, slot_size=16 << 10)
    assert (manifest[0][0], manifest[0][1]) in ctx2.link_cache.entries
    assert manifest[0][1] in peer.cached       # source resumes SLIM at once
    f2 = rt.submit("a", h, b"\x02" * 5)
    _settle(rt, f2)
    assert f2.result() == 10
    assert peer.stats["nacks"] == 0            # zero NACK_UNCACHED
    assert peer.stats["slim_sent"] >= 1        # and it WAS the slim path
    return {"rt": rt, "ec": ec,
            "out": (manifest, sorted(ctx2.link_cache.entries),
                    ctx2.stats, outcome(f2))}


def test_warm_restore_zero_nacks(lib_dir):
    held(_warm_restore, lib_dir)


def _cold_restart(pkg, lib_dir):
    """The contrast case: same restart, warm=False, but the source still
    believes the cache is hot -> SLIM -> NACK_UNCACHED -> FULL rebuild."""
    rt, ec, h, t = _kill_warm_a(pkg, lib_dir)
    manifest = ec.members["a"].manifest
    ctx2 = ctx(pkg, "a", lib_dir, link_mode="remote")
    peer = ec.readmit("a", pkg.transport.RdmaFabric(), ctx2, target_args={},
                      warm=False, now=t, n_slots=4, slot_size=16 << 10)
    peer.cached.update(dg for _, dg in manifest)   # stale source belief
    f2 = rt.submit("a", h, b"\x02" * 5)
    _settle(rt, f2)
    assert f2.result() == 10                   # FULL rebuild saves the task
    assert peer.stats["nacks"] >= 1            # ... but the storm happened
    return {"rt": rt, "ec": ec, "out": (manifest, outcome(f2))}


def test_cold_restart_nack_storm_is_the_alternative(lib_dir):
    held(_cold_restart, lib_dir)


# ---------------------------------------------------------------------------
# deterministic shard reassignment


def _reassign(pkg, lib_dir):
    inj = pkg.transport.FaultInjector()
    rt, fabs, ctxs = _mk_rt(pkg, lib_dir, names=("a", "b", "c"))
    fleet = pkg.runtime.FleetState(["a", "b", "c"],
                                   heartbeat_deadline=DEADLINE)
    dirx = pkg.tasks.DataDirectory()
    for sid in range(7):
        dirx.register(sid, ("a", "b", "c")[sid % 3], nbytes=1024)
    pl = pkg.tasks.PlacementEngine(dirx, rt.dispatcher)
    ec = pkg.runtime.ElasticController(rt, fleet, injector=inj, placement=pl,
                                       lib_dir=lib_dir, auto_poll=False)
    for name in ("a", "b", "c"):
        ec.watch(name, fabs[name], ctxs[name], now=0.0)
    inj.kill_peer("b")
    _, dead = _until_dead(ec)
    assert dead == ["b"]
    owners = {sid: dirx.owner(sid) for sid in dirx.shards}
    return {"rt": rt, "ec": ec, "out": (owners, pl.stats)}


def test_shard_reassignment_is_deterministic(lib_dir):
    ref, port = (_reassign(pkg, lib_dir) for pkg in PKGS)
    again = _reassign(PPKG, lib_dir)
    assert port["out"] == ref["out"] == again["out"]
    same_runtime(ref["rt"], port["rt"])
    same_elastic(ref["ec"], port["ec"])
    owners1 = port["out"][0]
    assert "b" not in owners1.values()         # dead peer owns nothing
    assert port["ec"].stats["shards_moved"] == 2   # shards 1 and 4 moved
    # round-robin over sorted survivors: sid 1 -> a, sid 4 -> c
    assert owners1[1] == "a" and owners1[4] == "c"


# ---------------------------------------------------------------------------
# flow re-route / replay


def _blob(runs):
    return struct.pack("<I", len(runs)) + b"".join(
        struct.pack("<II", v, c) for v, c in runs)


_ETL_OUT = {"count": 5, "sum": 500, "min": 100, "max": 100}
_ETL_BLOB = _blob([(7, 10), (100, 5), (7, 3)])


def _mk_flow(pkg, lib_dir, peers=("csd", "dpu", "dpu2", "agg")):
    X = pkg.transport
    eng = pkg.flow.FlowEngine(ctx(pkg, "host", lib_dir), default_timeout=20.0)
    fabs = {"csd": X.LoopbackFabric()}
    for p in peers:
        eng.add_node(p, fabs.get(p, X.RdmaFabric()))
    return eng


def _etl(fl, candidates=("dpu", "dpu2")):
    return (fl.Flow("etl")
            .stage("csd_decompress", at="csd")
            .then("dpu_filter", at=list(candidates),
                  bind={"mode": "kw", "key": "data",
                        "static": {"threshold": 50}})
            .then("host_aggregate", at="agg"))


def _reroute(pkg, lib_dir):
    eng = _mk_flow(pkg, lib_dir)
    fut = eng.submit(_etl(pkg.flow), _ETL_BLOB)
    picked = eng._chains[fut.corr_id]["entries"][1].peer
    assert eng.on_peer_death(picked) == 1      # in flight: replays
    assert picked not in eng.nodes
    assert fut.result() == _ETL_OUT
    assert eng.stats["replays"] == 1 and eng.stats["errors"] == 0
    assert eng.pending() == 0
    return {"eng": eng, "out": (picked, flow_outcome(fut))}


def test_flow_reroutes_multi_candidate_stage(lib_dir):
    held(_reroute, lib_dir)


def _kill_mid_chain(pkg, lib_dir):
    """Stage 1 completes, the stage-2 peer dies holding the forward: the
    replay resumes from the recorded stage-1 value, not from scratch."""
    eng = _mk_flow(pkg, lib_dir)
    inj = pkg.transport.FaultInjector()
    fut = eng.submit(_etl(pkg.flow), _ETL_BLOB)
    picked = eng._chains[fut.corr_id]["entries"][1].peer
    inj.kill_peer(picked)
    for nd in eng.nodes.values():              # the whole mesh sees the kill
        nd.dispatcher.faults = inj
    for _ in range(6):
        eng.progress()                         # stage 1 runs; stage 2 wedged
    st = eng._chains[fut.corr_id]
    assert st["node"] == "csd"                 # progress recorded at stage 1
    assert len(st["remaining"]) == 2
    wedged = (st["node"], len(st["remaining"]), bytes(st["value"]))
    assert eng.on_peer_death(picked) == 1
    assert fut.result() == _ETL_OUT
    assert eng.nodes["csd"].ctx.stats["executed"] == 1   # no re-run
    return {"eng": eng, "out": (picked, wedged, flow_outcome(fut),
                                inj.stats)}


def test_flow_kill_mid_chain_replays_from_progress(lib_dir):
    held(_kill_mid_chain, lib_dir)


def _pinned(pkg, lib_dir):
    eng = _mk_flow(pkg, lib_dir)
    fut = eng.submit(pkg.flow.Flow("pinned")
                     .stage("csd_decompress", at="csd")
                     .then("host_aggregate", at="dpu"),
                     _blob([(1, 2)]))
    eng.on_peer_death("dpu")
    with pytest.raises(pkg.transport.TransportError,
                       match="cannot be rebuilt"):
        fut.result()
    assert eng.stats["replay_failed"] == 1
    assert eng.pending() == 0
    return {"eng": eng, "out": flow_outcome(fut)}


def test_flow_pinned_stage_fails_future(lib_dir):
    held(_pinned, lib_dir)


def _untouched(pkg, lib_dir):
    eng = _mk_flow(pkg, lib_dir)
    fut = eng.submit(pkg.flow.Flow("other").stage("csd_decompress", at="csd")
                     .then("host_aggregate", at="agg"), _blob([(3, 4)]))
    assert eng.on_peer_death("dpu2") == 0      # dpu2 never touched this chain
    assert fut.result()["count"] == 4
    assert eng.stats["replays"] == 0
    return {"eng": eng, "out": flow_outcome(fut)}


def test_flow_untouched_chains_not_replayed(lib_dir):
    held(_untouched, lib_dir)


def _scatter_death(pkg, lib_dir):
    """Scatter branches are semantic placement (the shard lives there):
    a branch peer dying fails the chain instead of running elsewhere."""
    eng = _mk_flow(pkg, lib_dir)
    for (peer, sid), es in {("csd", 0): [(0, 1, 0.9)],
                            ("dpu", 1): [(2, 3, 0.8)]}.items():
        eng.nodes[peer].target_args.setdefault("shards", {})[sid] = \
            pkg.graph.pack_csr_shard(sid * 2, 2, es)
    fl = pkg.flow
    q = (fl.Flow("count")
         .scatter("graph_count", at=["csd", "dpu"],
                  binds=[{"mode": "static", "static": {"sid": 0, "wmin": 0.0}},
                         {"mode": "static", "static": {"sid": 1, "wmin": 0.0}}])
         .gather("flow_reduce", at="agg"))
    fut = eng.submit(q, None)
    eng.on_peer_death("dpu")
    with pytest.raises(pkg.transport.TransportError):
        fut.result()
    # no stale rendezvous state survives the failure
    assert not any(eng.nodes[n].gathers for n in eng.nodes)
    return {"eng": eng, "out": flow_outcome(fut)}


def test_flow_scatter_branch_death_fails_future(lib_dir):
    held(_scatter_death, lib_dir)


def _controller_flow(pkg, lib_dir):
    """End to end: the heartbeat deadline (not a manual call) triggers the
    flow's re-route, through ElasticController._on_death."""
    eng = _mk_flow(pkg, lib_dir)
    inj = pkg.transport.FaultInjector()
    rt, fabs, ctxs = _mk_rt(pkg, lib_dir, names=())
    fleet = pkg.runtime.FleetState(["dpu"], heartbeat_deadline=DEADLINE)
    ec = pkg.runtime.ElasticController(rt, fleet, injector=inj, flow=eng,
                                       lib_dir=lib_dir, auto_poll=False)
    ec.watch("dpu", eng.nodes["dpu"].fabric, eng.nodes["dpu"].ctx, now=0.0)
    fut = eng.submit(_etl(pkg.flow, candidates=("dpu",)), _ETL_BLOB)
    # the compiler picked dpu, but the op list holds both candidates
    eng._chains[fut.corr_id]["entry_ops"] = (
        ("stage", "csd_decompress", "csd", None, 4096),
        ("stage", "dpu_filter", ["dpu", "dpu2"],
         {"mode": "kw", "key": "data", "static": {"threshold": 50}}, 4096),
        ("stage", "host_aggregate", "agg", None, 4096))
    inj.kill_peer("dpu")
    _, dead = _until_dead(ec)
    assert dead == ["dpu"] and "dpu" not in eng.nodes
    assert fut.result() == _ETL_OUT
    assert eng.stats["replays"] == 1
    return {"rt": rt, "ec": ec, "eng": eng, "out": (dead, flow_outcome(fut))}


def test_controller_drives_flow_replay(lib_dir):
    held(_controller_flow, lib_dir)


# ---------------------------------------------------------------------------
# the recovery's order


def _recovery_order(pkg, lib_dir):
    """Record each recovery step of a heartbeat death as it runs, with the
    state it sees: the manifest snapshot, whether the peer is still
    attached, the runtime's generation and the directory's owner."""
    inj = pkg.transport.FaultInjector()
    rt, fabs, ctxs = _mk_rt(pkg, lib_dir, names=("a", "b", "c"))
    fleet = pkg.runtime.FleetState(["a", "b", "c"],
                                   heartbeat_deadline=DEADLINE)
    dirx = pkg.tasks.DataDirectory()
    for sid in range(4):
        dirx.register(sid, ("a", "b", "c")[sid % 3], nbytes=1024)
    pl = pkg.tasks.PlacementEngine(dirx, rt.dispatcher)
    log = []
    d = rt.dispatcher

    def seen(step, name):
        m = ec.members.get(name)
        log.append((step, name, name in d.peers, rt.generation,
                    dirx.owner(1), bool(m and m.manifest)))

    def wrap(obj, attr, step, arg=lambda a, k: a[0]):
        fn = getattr(obj, attr)

        def recorded(*a, **k):
            seen(step, arg(a, k))
            return fn(*a, **k)
        setattr(obj, attr, recorded)

    flow = types.SimpleNamespace(
        on_peer_death=lambda name: seen("flow.on_peer_death", name))
    ec = pkg.runtime.ElasticController(rt, fleet, injector=inj, placement=pl,
                                       flow=flow, lib_dir=lib_dir,
                                       auto_poll=False)
    for name in ("a", "b", "c"):
        ec.watch(name, fabs[name], ctxs[name], now=0.0)
    h = pkg.core.register_ifunc(rt.ctx, "task_sum", lib_dir)
    _settle(rt, rt.submit("b", h, b"\x01"))    # b's cache is warm
    wrap(d, "fail_inflight", "fail_inflight",
         lambda a, k: next(iter(k["peers"])))
    wrap(d, "remove_peer", "remove_peer")
    wrap(pl, "rebalance", "rebalance", lambda a, k: "b")
    ec.on_death.append(lambda name: seen("on_death", name))
    inj.kill_peer("b")
    doomed = rt.submit("b", h, b"\x02")
    rt.flush()
    _, dead = _until_dead(ec)
    return {"rt": rt, "ec": ec,
            "out": (dead, log, outcome(doomed), ec.members["b"].manifest)}


def test_recovery_order_matches_reference(lib_dir):
    """The reference's order: snapshot the manifest, fail the dead peer's
    futures, retire it, take the new generation, move its shards and
    rebalance, re-route flows, then the ``on_death`` callbacks."""
    port = held(_recovery_order, lib_dir)
    dead, log, doomed, manifest = port["out"]
    assert dead == ["b"] and manifest
    assert [step for step, *_ in log] == [
        "fail_inflight", "remove_peer", "rebalance", "flow.on_peer_death",
        "on_death"]
    gens = [g for _, _, _, g, _, _ in log]
    assert gens[0] == gens[1] == 0 and all(g > 0 for g in gens[2:])
    attached = [a for _, _, a, _, _, _ in log]
    assert attached == [True, True, False, False, False]
    owners = [o for _, _, _, _, o, _ in log]
    assert owners[:2] == ["b", "b"] and "b" not in owners[2:]
    assert all(snap for *_, snap in log)     # the manifest came first
    assert doomed[:2] == ("ERROR", "TransportError")
