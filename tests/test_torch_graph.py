"""Placement and the sharded-graph workload on the port
(``repro_torch.tasks.{placement,graph}`` and the ``graph_*`` verbs) held
against the reference's.

* The five graph and placement cases of ``tests/test_tasks.py`` run as
  the same scenario through both packages on the same dispatcher state,
  loading ``ifunc_libs/`` into both registries so PYBC frames (and the
  code lengths the cost model prices) are equal.  Besides the reference
  test's own assertions, the futures' outcomes, reply bytes, runtime and
  dispatcher state (``same_runtime``), every ``Placement`` (decision,
  shard, peer, costs as floats, stolen), ``engine.stats`` and the
  directory (owners, replicas, hotness, ``moves``) must be equal.
* The CSR codec's bytes at the three ``fig_graph`` sizes, the pure hop
  pricer ``PlacementEngine(None, d)`` on every fabric kind (``inf`` for
  an unknown peer), ``graph_count`` on a host target and a
  ``graph_degree`` device future: all equal, exactly.
* ``examples/graph_analysis.py`` at its own size: the reference's whole
  example (its device lane's μVM through a traceable jnp interpreter,
  since its Pallas interpreter needs ``pl.load``) against
  ``chip_smoke.graph_workload`` with no device peer, one device shard
  (the reference's, at this process's one jax device) and two: the
  decisions of every round, ``moves``, ``dist`` bit for bit,
  ``engine.stats`` and the host peers' state equal in all three, the
  device futures' counts and the device peer too at one shard; and the
  port's two-shard run passes ``chip_smoke.graph_gates``.  With
  ``--kill-peer`` (one device shard), the same plus the recovery: the
  round of the death and of the re-admission, the controller's stats
  (the wall-clock-paced beat counts left out), the relaxes re-run, the
  fence, the warm manifest and the post-readmit relax, and the port's
  run passes the ELASTIC_OK gates.
"""

import pathlib
import struct
import sys
import types

import numpy as np
import pytest
import torch

import chip_smoke
import repro.core.device_mailbox as RDM
import repro.tasks as RTK
import repro.tasks.graph as RG
import repro.tasks.placement as RPL
import repro_torch.tasks as PTK
import repro_torch.tasks.graph as PG
from repro.core.codegen import OPS
from repro.core.codegen import deserialize_uvm as ref_deserialize_uvm
from repro.kernels.ref import ifunc_vm_ref
from test_torch_tasks import (PPKG, RPKG, _mk_runtime, _rt, outcome,
                              same_runtime)
from test_torch_transport import _mailbox_bytes

REPO = pathlib.Path(__file__).resolve().parents[1]
RPKG = types.SimpleNamespace(**vars(RPKG), graph=RG)
PPKG = types.SimpleNamespace(**vars(PPKG), graph=PG)
PKGS = (RPKG, PPKG)
T = 128


def both(scenario, lib_dir, **kw):
    return tuple(scenario(pkg, lib_dir, **kw) for pkg in PKGS)


def held(scenario, lib_dir):
    """Run through both packages; what the scenario returns beside its
    runtime, and the runtimes, must agree."""
    (rrt, rout), (prt, pout) = both(scenario, lib_dir)
    assert pout == rout
    same_runtime(rrt, prt)
    return pout


def placed(p):
    return (p.decision.value, p.shard, p.peer, p.costs, p.stolen)


def directory_state(directory):
    return ({sid: (sh.owner, sh.nbytes, sorted(sh.replicas), sh.hotness)
             for sid, sh in directory.shards.items()}, list(directory.moves))


# ---------------------------------------------------------------------------
# graph verbs over futures (host tier)


def _relax_roundtrip(pkg, lib_dir):
    rt = _rt(pkg, lib_dir)
    h = pkg.core.register_ifunc(rt.ctx, "graph_relax", lib_dir)
    edges = [(0, 1, 0.5), (0, 2, 2.0), (1, 2, 0.25), (3, 0, 1.0)]
    packed = pkg.graph.pack_csr_shard(0, 4, edges)
    rt.dispatcher.peers["rdma"].target_args["shards"] = {7: packed}
    frontier = [(0, 0.0), (1, 0.5)]
    fut = rt.submit("rdma", h, {"sid": 7, "frontier": frontier})
    reply = fut.result()
    upd = pkg.graph.decode_updates(reply)
    assert upd == {1: 0.5, 2: pytest.approx(0.75)}
    # the shipped main and the source-side mirror agree exactly
    assert upd == pytest.approx(pkg.graph.local_relax(packed, frontier))
    # unknown shard -> exception future, not a wedged ring
    bad = rt.submit("rdma", h, {"sid": 99, "frontier": [(0, 0.0)]})
    with pytest.raises(pkg.tasks.RemoteExecutionError):
        bad.result()
    return rt, [outcome(fut), outcome(bad), bytes(reply), packed]


def test_graph_relax_future_roundtrip(lib_dir):
    """The relax verb's reply bytes, the exception future of an unknown
    shard and the runtimes equal between the packages."""
    held(_relax_roundtrip, lib_dir)


def _fetch(pkg, lib_dir):
    rt = _rt(pkg, lib_dir)
    h = pkg.core.register_ifunc(rt.ctx, "graph_fetch", lib_dir)
    blob = struct.pack("<IIf", 1, 2, 3.0) * 50
    rt.dispatcher.peers["loop"].target_args["shards"] = {0: blob}
    fut = rt.submit("loop", h, {"sid": 0})
    assert fut.result() == blob
    return rt, [outcome(fut), bytes(fut.result())]


def test_graph_fetch_returns_shard_bytes(lib_dir):
    held(_fetch, lib_dir)


def _count(pkg, lib_dir):
    rt = _rt(pkg, lib_dir)
    h = pkg.core.register_ifunc(rt.ctx, "graph_count", lib_dir)
    rng = np.random.default_rng(11)
    edges = [(u, int(rng.integers(0, 64)), float(rng.uniform(0.1, 1.0)))
             for u in range(16) for _ in range(8)]
    packed = pkg.graph.pack_csr_shard(0, 16, edges)
    rt.dispatcher.peers["rdma"].target_args["shards"] = {3: packed}
    futs = [rt.submit("rdma", h, {"sid": 3, "wmin": wmin})
            for wmin in (0.0, 0.5, 0.9, 2.0)]
    futs.append(rt.submit("rdma", h, {"sid": 4, "wmin": 0.5}))
    for f, wmin in zip(futs, (0.0, 0.5, 0.9, 2.0)):
        # the payload carries wmin as f32, the shard each w as f32
        want = sum(np.float32(w) >= np.float32(wmin) for _, _, w in edges)
        assert f.result() == want
    with pytest.raises(pkg.tasks.RemoteExecutionError, match="not resident"):
        futs[-1].result()
    return rt, [outcome(f) for f in futs]


def test_graph_count_on_a_host_target(lib_dir):
    """``graph_count`` (flow's scatter verb, item 4(b)) as a plain
    host-target future: counts equal to numpy's and to the reference's,
    an unknown shard an error future in both."""
    held(_count, lib_dir)


# ---------------------------------------------------------------------------
# the CSR codec and the hop pricer


def _fig_graph_edges(ne, seed=3):
    """``bench_graph_placement``'s shard of ``ne`` edges at out-degree 16."""
    rng = np.random.default_rng(seed)
    nv = ne // 16
    return nv, [(u, int(rng.integers(0, 1 << 20)), float(rng.uniform(0.1, 1)))
                for u in range(nv) for _ in range(16)]


@pytest.mark.parametrize("ne", [1024, 8192, 65536])
def test_csr_shard_bytes_equal_reference(ne):
    """``pack_csr_shard`` bytes equal at the three ``fig_graph`` sizes;
    ``local_relax`` and ``decode_updates`` equal on them; a source vertex
    outside the shard raises in both."""
    nv, edges = _fig_graph_edges(ne)
    packed = PG.pack_csr_shard(0, nv, edges)
    assert packed == RG.pack_csr_shard(0, nv, edges)
    assert len(packed) == 8 + 4 * (nv + 1) + 8 * ne
    frontier = [(int(i), 0.5) for i in range(16)] + [(nv + 3, 0.0)]
    relaxed = PG.local_relax(packed, frontier)
    assert relaxed == RG.local_relax(packed, frontier) and relaxed
    reply = struct.pack("<I", len(relaxed)) + b"".join(
        struct.pack("<If", v, d) for v, d in sorted(relaxed.items()))
    assert PG.decode_updates(reply) == RG.decode_updates(reply)
    for G in (PG, RG):
        with pytest.raises(ValueError, match="outside shard"):
            G.pack_csr_shard(4, 2, [(1, 0, 1.0)])


def _pricer(pkg, lib_dir):
    """Peers on every fabric kind, congested unevenly; the pure hop pricer
    over them."""
    from repro.parallel.sharding import make_mesh
    from repro.transport.device_fabric import DeviceMeshFabric

    rt = _mk_runtime(pkg, lib_dir, [("rdma", "rdma"), ("loop", "loopback")])
    d = rt.dispatcher
    if pkg is RPKG:
        fabric = DeviceMeshFabric(make_mesh((1,), ("model",)), "model",
                                  shift=0)
    else:
        fabric = pkg.transport.DeviceMeshFabric(1, shift=0, device="cpu")
    h_deg = pkg.core.register_ifunc(rt.ctx, "graph_degree",
                                    lib_dir if pkg is RPKG else None)
    rt.add_peer("dev", fabric, None, n_slots=4, slot_size=128 << 10,
                prog=pkg.core.codegen.deserialize_uvm(h_deg.lib.code),
                externals=np.zeros((1, 1, T, T), np.float32))
    h = pkg.core.register_ifunc(rt.ctx, "task_sum", lib_dir)
    for peer, n in (("rdma", 3), ("loop", 1)):
        for _ in range(n):
            assert d.send(peer, pkg.core.ifunc_msg_create(h, b"x"))
    eng = pkg.tasks.PlacementEngine(None, d, service_s=40e-6,
                                    fabric_bw={"loopback": 4e9})
    prices = {(p, nb): eng.hop_cost(p, nb)
              for p in ("rdma", "loop", "dev", "gone")
              for nb in (0, 256, 1 << 20)}
    depths = {p: eng.queue_depth(p) for p in ("rdma", "loop", "dev")}
    relax = pkg.core.register_ifunc(rt.ctx, "graph_relax", lib_dir)
    code = {p: eng._code_bytes(p, relax) for p in ("rdma", "loop", "dev")}
    return prices, depths, code, eng.stats


def test_hop_cost_equal_reference(lib_dir):
    """``PlacementEngine(None, d)``, the flow layer's hop pricer: queue
    depths, code bytes and every hop's cost equal (as floats) on RDMA,
    loopback and device peers, an unknown peer at ``inf`` in both."""
    ref, port = both(_pricer, lib_dir)
    assert port == ref
    prices, depths, code, _ = port
    assert depths == {"rdma": 3, "loop": 1, "dev": 0}
    assert code["dev"] == 0 and code["rdma"] == code["loop"] > 0
    assert all(prices[("gone", nb)] == float("inf") for nb in (0, 256))
    assert prices[("rdma", 256)] > prices[("loop", 256)]


# ---------------------------------------------------------------------------
# placement engine


def _mk_placement(pkg, lib_dir, *, shard_bytes, code_confirmed=False):
    rt = _mk_runtime(pkg, lib_dir, [("owner", "loopback"),
                                    ("idle", "loopback")])
    h = pkg.core.register_ifunc(rt.ctx, "graph_relax", lib_dir)
    directory = pkg.tasks.DataDirectory()
    directory.register(0, "owner", shard_bytes)
    eng = pkg.tasks.PlacementEngine(directory, rt.dispatcher)
    if code_confirmed:
        rt.dispatcher.peers["owner"].cached.add(h.lib.code_digest)
    return rt, h, directory, eng


def _migrate_fetch_local(pkg, lib_dir):
    D = pkg.tasks.Decision
    out = []
    # big shard, confirmed code: shipping the frontier is cheap -> MIGRATE
    rt, h, directory, eng = _mk_placement(pkg, lib_dir, shard_bytes=1 << 20,
                                          code_confirmed=True)
    p = eng.decide(0, h, arg_bytes=128)
    assert p.decision is D.MIGRATE and p.peer == "owner"
    assert p.costs["migrate"] < p.costs["fetch"]
    assert eng.stats["migrate"] == 1
    out += [placed(p), dict(eng.stats), directory_state(directory)]
    # tiny shard, cold code cache: pulling the data beats shipping code
    rt, h, directory, eng = _mk_placement(pkg, lib_dir, shard_bytes=64)
    p = eng.decide(0, h, arg_bytes=128)
    assert p.decision is D.FETCH
    out.append(placed(p))
    # a local replica wins outright
    directory.add_replica(0, pkg.tasks.LOCAL_SITE)
    p = eng.decide(0, h, arg_bytes=128)
    assert p.decision is D.LOCAL and p.peer is None
    assert eng.stats["fetch"] == 1 and eng.stats["local"] == 1
    out += [placed(p), dict(eng.stats), directory_state(directory)]
    return rt, out


def test_placement_migrate_vs_fetch_vs_local(lib_dir):
    held(_migrate_fetch_local, lib_dir)


def _steal(pkg, lib_dir):
    rt, h, directory, eng = _mk_placement(pkg, lib_dir, shard_bytes=1 << 20,
                                          code_confirmed=True)
    directory.add_replica(0, "idle")
    hb = pkg.core.register_ifunc(rt.ctx, "task_sum", lib_dir)
    for _ in range(4):                      # fill the ring, never drain
        assert rt.dispatcher.send("owner",
                                  pkg.core.ifunc_msg_create(hb, b"x"))
    assert eng.queue_depth("owner") == 4
    p = eng.decide(0, h, arg_bytes=128)
    assert p.decision is pkg.tasks.Decision.FETCH and p.stolen
    assert p.peer == "idle"                 # sourced around the congestion
    assert eng.stats["stolen"] == 1
    return rt, [placed(p), dict(eng.stats), directory_state(directory)]


def test_placement_queue_pressure_steals(lib_dir):
    """Locality says migrate; a backlogged owner flips the decision to a
    fetch from an uncongested replica holder, in both packages."""
    held(_steal, lib_dir)


def _rebalance(pkg, lib_dir):
    rt, h, directory, eng = _mk_placement(pkg, lib_dir, shard_bytes=4 << 10,
                                          code_confirmed=True)
    hb = pkg.core.register_ifunc(rt.ctx, "task_sum", lib_dir)
    assert eng.rebalance() == []            # no divergence yet
    for _ in range(4):
        assert rt.dispatcher.send("owner",
                                  pkg.core.ifunc_msg_create(hb, b"x"))
    directory.touch(0, 5.0)
    moves = eng.rebalance(eligible=["owner", "idle"])
    assert moves == [(0, "owner", "idle")]
    assert directory.owner(0) == "idle"
    assert "idle" in directory.lookup(0).replicas
    assert eng.stats["rebalances"] == 1
    return rt, [moves, dict(eng.stats), directory_state(directory)]


def test_placement_rebalance_moves_hot_shard(lib_dir):
    held(_rebalance, lib_dir)


# ---------------------------------------------------------------------------
# graph_degree on the device lane


def test_graph_degree_device_future_exact(lib_dir):
    """``graph_degree`` futures on ``DeviceMeshFabric(2, device="cpu")``
    with the adjacency column-sharded into the externals: each shard's
    counts equal ``f_ind @ A_dev[d, 0]`` and the reference's
    ``ifunc_vm_ref`` of its own program exactly, every row."""
    from repro.core import Context as RContext
    from repro.core import register_ifunc as ref_register
    from repro_torch.core import Context, register_ifunc
    from repro_torch.core.codegen import deserialize_uvm
    from repro_torch.transport import (DeviceMeshFabric, Dispatcher,
                                       ProgressEngine)

    rng = np.random.default_rng(5)
    A = (rng.random((T, T)) < 0.2).astype(np.float32)
    A_dev = np.zeros((2, 1, T, T), np.float32)
    for s in range(2):
        A_dev[s, 0, :, s * 64:(s + 1) * 64] = A[:, s * 64:(s + 1) * 64]
    src = Context("src", device="cpu")
    rt = PTK.TaskRuntime(src, Dispatcher(src, ProgressEngine(
        inflight_window="trailer")), default_timeout=60.0)
    h = register_ifunc(src, "graph_degree")
    ref_h = ref_register(RContext("ref", lib_dir=lib_dir), "graph_degree",
                         lib_dir)
    assert h.lib.code == ref_h.lib.code     # the same μVM program bytes
    rt.add_peer("gpu", DeviceMeshFabric(2, shift=0, device="cpu"), None,
                n_slots=2, slot_size=128 << 10,
                prog=deserialize_uvm(h.lib.code), n_tiles=1,
                externals=torch.from_numpy(A_dev))
    lane = rt.dispatcher.peers["gpu"].rings[0]
    f_ind = (rng.random(T) < 0.3).astype(np.float32)
    tile = np.broadcast_to(f_ind, (T, T)).reshape(1, T, T).copy()
    futs = [(lane.mailbox.slot_coords(lane.tail)[0],
             rt.submit("gpu", h, tile)) for _ in range(2)]
    assert [s for s, _ in futs] == [0, 1]
    prog = ref_deserialize_uvm(ref_h.lib.code)
    for s, fut in futs:
        got = fut.result().cpu().numpy()
        assert got.shape == (1, T, T)
        assert (got == f_ind @ A_dev[s, 0]).all()
        assert (got == ifunc_vm_ref(prog, tile, A_dev[s])).all()
    assert rt.pending() == 0


# ---------------------------------------------------------------------------
# examples/graph_analysis.py at its own size


_INV_OPS = {v: k for k, v in OPS.items()}


def _jnp_uvm(prog, tiles, ext, interpret=True):
    """A traceable jnp μVM interpreter for the opcodes the graph and affine
    programs use (the reference's Pallas one needs ``pl.load``)."""
    import jax.numpy as jnp

    regs, out = {}, jnp.zeros_like(tiles)
    for pc in range(len(prog.opcode)):
        op = _INV_OPS[int(prog.opcode[pc])]
        d, a, b = int(prog.dst[pc]), int(prog.a[pc]), int(prog.b[pc])
        if op == "loadp":
            regs[d] = tiles
        elif op == "loade":
            regs[d] = jnp.broadcast_to(ext[min(a, ext.shape[0] - 1)],
                                       tiles.shape)
        elif op == "matmul":
            regs[d] = jnp.einsum("nij,njk->nik", regs[a], regs[b],
                                 precision="highest")
        elif op == "relu":
            regs[d] = jnp.maximum(regs[a], 0.0)
        elif op == "store":
            out = regs[a]
        else:
            raise NotImplementedError(op)
    return out


def _run_reference_example(*argv):
    """The reference's ``examples/graph_analysis.py`` with ``argv``, run
    whole at this process's one jax device: every ``decide`` recorded by
    round (a ``DataDirectory.decay`` closes one), every device future
    kept.  Returns the example's globals."""
    path = REPO / "examples" / "graph_analysis.py"
    rounds, current, device_futs = [], [], []
    decide, decay = RPL.PlacementEngine.decide, RPL.DataDirectory.decay
    submit = RTK.TaskRuntime.submit

    def recording_decide(self, *a, **k):
        p = decide(self, *a, **k)
        current.append(placed(p))
        return p

    def closing_decay(self, *a, **k):
        rounds.append(list(current))
        current.clear()
        return decay(self, *a, **k)

    def keeping_submit(self, peer, *a, **k):
        fut = submit(self, peer, *a, **k)
        if peer == "tpu":
            device_futs.append(fut)
        return fut

    g = {"__name__": "__main__", "__file__": str(path)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [str(path), *argv])
        mp.setattr(RDM, "ifunc_vm", _jnp_uvm)
        mp.setattr(RPL.PlacementEngine, "decide", recording_decide)
        mp.setattr(RPL.DataDirectory, "decay", closing_decay)
        mp.setattr(RTK.TaskRuntime, "submit", keeping_submit)
        if "--kill-peer" not in argv:
            with pytest.raises(SystemExit) as done:
                exec(compile(path.read_text(), str(path), "exec"), g)
            assert done.value.code == 0
        else:
            # the example asserts that the re-admitted peer served a relax
            # before its post-readmit one (graph_analysis.py:374), but the
            # placement keeps shard 1 local after the re-admission; every
            # assertion before that one held.  The example's remaining
            # lines run here: the post-readmit relax.
            with pytest.raises(AssertionError) as done:
                exec(compile(path.read_text(), str(path), "exec"), g)
            tb = done.tb
            while tb.tb_next is not None:
                tb = tb.tb_next
            assert tb.tb_lineno == 374
            assert g["re_peer"].stats["replies"] == 0
            rt, fr = g["rt"], g["FR"]
            g["rounds_stats"] = dict(g["re_peer"].stats)
            post = rt.submit("rdma_b", g["relax_h"], {"sid": 1,
                                                      "frontier": []})
            assert fr.corr_gen(post.corr_id) == g["fence_gen"]
            rt.flush()
            rt.drain()
            assert g["decode_updates"](post.result()) == {}
    g["placements"] = rounds
    g["device_counts"] = [np.asarray(f.result()) for f in device_futs]
    return g


@pytest.fixture(scope="module")
def reference_example():
    return _run_reference_example()


@pytest.fixture(scope="module")
def reference_kill_example():
    return _run_reference_example("--kill-peer")


#: the controller's stats paced by the wall clock (a beat every deadline/3)
_PACED = ("beats_sent", "beats_folded", "beats_skipped")


@pytest.mark.parametrize("shards,kill", [
    pytest.param(0, False, id="0"), pytest.param(1, False, id="1"),
    pytest.param(2, False, id="2"), pytest.param(1, True, id="1-kill-peer")])
def test_graph_example_matches_reference(request, lib_dir, shards, kill):
    """The port's graph workload against the reference's whole example on
    the same seeds: the graph and its shards, every round's placements
    (decision, shard, peer, costs, stolen), ``moves``, ``dist`` bit for
    bit, ``engine.stats``, the runtime's stats and the host peers' stats,
    caches, target state and ring bytes are equal with no device peer and
    with one or two device shards (so no decision depends on the device
    peer); at one shard, as the reference's, the device peer's stats and
    each device future's counts are equal too (exactly)."""
    ref = request.getfixturevalue("reference_kill_example" if kill
                                  else "reference_example")
    res = chip_smoke.graph_workload(np, torch, torch.device("cpu"),
                                    shards=shards, dev_slots=4,
                                    lib_dir=lib_dir, kill=kill)
    assert res["edges"] == ref["edges"]
    assert res["shard_bytes"] == ref["shard_bytes"]
    assert res["placements"] == ref["placements"]
    assert res["moves"] == ref["moves"] == [(0, "rdma_a", "rdma_b")]
    if kill:
        el, ec = res["elastic"], ref["ec"]
        assert el["killed"] and el["readmitted"] == el["killed"] + 1
        assert ref["killed"] and ref["readmitted"]
        assert el["fence"] == el["fence_gen"] == ref["fence_gen"] > 0
        assert el["generation"] == ref["fleet"].generation
        assert el["alive"] == ref["fleet"].alive() == ["csd", "rdma_a",
                                                       "rdma_b"]
        assert el["recovered"] == ref["recovered_tasks"] >= 1
        assert el["manifest"] == ref["ec"].members["rdma_b"].manifest
        assert {k: v for k, v in el["stats"].items() if k not in _PACED} \
            == {k: v for k, v in ec.stats.items() if k not in _PACED}
        assert el["post_gen"] == el["fence_gen"]
        assert el["post_updates"] == {}
        assert el["injector"] == ref["injector"].stats
        assert el["rounds_stats"] == ref["rounds_stats"]
        assert el["peer_stats"]["replies"] == 1
        assert el["kill_to_recovery_s"] >= chip_smoke.GRAPH_DEADLINE
    assert res["rounds"] == ref["rounds"]
    assert res["dist"].dtype == ref["dist"].dtype
    assert res["dist"].tobytes() == ref["dist"].tobytes()
    assert res["engine_stats"] == ref["engine"].stats
    assert res["decisions"] == ref["decisions"]
    assert directory_state(res["directory"]) == \
        directory_state(ref["directory"])
    rrt, prt = ref["rt"], res["rt"]
    assert (res["orphan_replies"], res["pending"]) == \
        (rrt.stats["orphan_replies"], rrt.pending()) == (0, 0)
    rd, pd = rrt.dispatcher, prt.dispatcher
    for name, _ in chip_smoke.GRAPH_HOSTS:
        rp, pp = rd.peers[name], pd.peers[name]
        assert res["peer_stats"][name] == {
            **rd.per_peer_stats()[name],
            "oldest_inflight_s": res["peer_stats"][name]["oldest_inflight_s"]}
        assert pp.cached == rp.cached and not pp.resend and not rp.resend
        # under --kill-peer the context also runs the wall-clock-paced beats
        paced = ("executed", "bytes_in") if kill else ()
        assert {k: v for k, v in pp.target_ctx.stats.items()
                if k not in paced} == {k: v for k, v in
                                       rp.target_ctx.stats.items()
                                       if k not in paced}, name
        assert pp.target_args.get("shards") == rp.target_args.get("shards")
        assert pp.target_args.get("count") == rp.target_args.get("count")
        for mb_r, mb_p in ((rp.rings[0].mailbox, pp.rings[0].mailbox),
                           (rp.reply_mailbox, pp.reply_mailbox)):
            assert _mailbox_bytes(mb_p) == _mailbox_bytes(mb_r), name
            assert (mb_p.head, mb_p.consumed) == (mb_r.head, mb_r.consumed)
    if shards == 1 and not kill:
        assert prt.stats == rrt.stats
        assert pd.stats == rd.stats and pd.engine.stats == rd.engine.stats
        ps, rs = pd.per_peer_stats()["gpu"], rd.per_peer_stats()["tpu"]
        assert ps | {"oldest_inflight_s": 0} == rs | {"oldest_inflight_s": 0}
        got = [c for _, dev in res["degrees"] for _, c in dev]
        assert len(got) == len(ref["device_counts"]) == res["rounds"]
        for g, r in zip(got, ref["device_counts"]):
            assert g.shape == r.shape and (g == r).all()
        chip_smoke.graph_gates(np, res)


def test_graph_example_two_device_shards_passes_gates():
    """The port's example on ``DeviceMeshFabric(2, device="cpu")`` with its
    own library passes the example's GRAPH_OK gates (``graph_gates``)."""
    res = chip_smoke.graph_workload(np, torch, torch.device("cpu"),
                                    shards=2, dev_slots=4)
    chip_smoke.graph_gates(np, res)
    assert all(len(got) == 2 for _, got in res["degrees"])
    assert res["congestion"][:3] == (2, "rdma_a", 6.0)


def test_chip_smoke_phase21_parts_on_cpu():
    """Phase 21's parts (b) and (c) at a small size on the CPU: the
    ``fig_graph`` ways at two shard sizes (their warm-ups held against
    ``local_relax`` and the packed bytes inside), and a host-target
    ``graph_degree`` future equal to the device lane's result for the
    same frontier and shard."""
    dev = torch.device("cpu")
    rows = chip_smoke.fig_graph(np, torch, dev, sizes=(1024, 8192),
                                iters=2, repeats=1)
    assert sorted(rows) == [8 + 4 * 65 + 8 * 1024, 8 + 4 * 513 + 8 * 8192]
    assert all(set(r) == {"migrate", "fetch", "local"}
               and all(v > 0 for v in r.values()) for r in rows.values())
    res = chip_smoke.graph_workload(np, torch, dev, shards=2, dev_slots=4)
    f_ind, got = res["degrees"][1]
    for shard, lane_out in got:
        out, _ = chip_smoke.host_degree(
            np, torch, dev, res["A_dev"][shard, 0],
            np.broadcast_to(f_ind, (T, T)).reshape(1, T, T).copy())
        assert out.shape == lane_out.shape and (out == lane_out).all()
