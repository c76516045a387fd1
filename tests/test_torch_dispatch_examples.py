"""``examples/multi_peer.py`` and ``examples/offload_compress.py`` on the
port, at the examples' own sizes on the CPU.

* The multi-peer fan-out over the host peers (two RDMA, one loopback) runs
  through both packages on the same inputs: statuses, ``per_peer_stats()``,
  dispatcher, engine and target stats, slot and slab bytes and the obs
  counters must be equal (``same_run``).  The reference's μVM path needs
  ``pl.load``, which this jax lacks, so its ``uvm_execute`` is swapped for
  ``repro.kernels.ref.ifunc_vm_ref`` here; every μVM result of both is
  held against numpy's relu(x @ W) within rtol 1e-4, atol 1e-5.
* With the device peer (``DeviceMeshFabric(2, device="cpu")``) the port
  alone runs the whole example, passing the example's MULTI_PEER, AGG_OK
  and OBS_OK gates (``chip_smoke.multi_peer_gates``).
* The codec hot swap runs through both packages from one library file,
  and through the port's own ``rle_insert`` as ``chip_smoke.py`` phase 19
  runs it; the counted paths of phase 19 and of phase 20 (result
  futures over the reply path) run here at a small size.
"""

import shutil

import numpy as np
import pytest
import torch

import chip_smoke
import repro.kernels.ops as RK
from repro.core.codegen import deserialize_uvm as ref_deserialize_uvm
from repro.kernels.ref import ifunc_vm_ref
from test_torch_transport import PKGS, PORT, REF, ctx, same_run

T, N_MSGS = 128, 6
SLOT = 128 << 10
BURST = 48
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture()
def ref_uvm_oracle(monkeypatch):
    """The reference's host μVM execution through its numpy oracle."""
    monkeypatch.setattr(RK, "uvm_execute", lambda prog, tiles, ext:
                        ifunc_vm_ref(prog, tiles, np.stack(ext)))


def _multi_peer(pkg, lib_dir, *, device_peer):
    """``examples/multi_peer.py`` through ``pkg``: returns (dispatcher,
    obs, payloads, W, backpressure retries)."""
    core, T_ = pkg.core, pkg.transport
    source = ctx(pkg, "source", lib_dir)
    handle = core.register_ifunc(source, "uvm_affine", lib_dir)
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((T, T)) * 0.05).astype(np.float32)
    obs = pkg.obs.Obs("multi_peer", trace=True)
    d = T_.Dispatcher(source, T_.ProgressEngine(flush_threshold=8,
                                                inflight_window="trailer"),
                      obs=obs)
    d.set_coalescing(True, max_subs=16)
    for name in ("rdma_a", "rdma_b"):
        d.add_peer(name, T_.RdmaFabric(),
                   ctx(pkg, name, lib_dir, link_mode="remote"),
                   n_slots=4, slot_size=SLOT,
                   target_args={"externals": {"W": W}, "results": []})
    d.add_peer("csd", T_.LoopbackFabric(),
               ctx(pkg, "csd", lib_dir, link_mode="remote"),
               n_slots=4, slot_size=SLOT,
               target_args={"externals": {"W": W}, "results": []})
    if device_peer:
        d.add_peer("gpu", T_.DeviceMeshFabric(2, shift=0, device="cpu"),
                   None, n_slots=4, slot_size=SLOT,
                   prog=PORT.core.codegen.deserialize_uvm(handle.lib.code),
                   externals=np.broadcast_to(W[None, None], (2, 1, T, T)))
    payloads = rng.standard_normal((N_MSGS, 1, T, T)).astype(np.float32)
    retries = 0
    for i in range(N_MSGS):
        for peer in list(d.peers):
            while not d.send_ifunc(peer, handle, payloads[i]):
                retries += 1
                d.drain()
    d.drain()
    # act two: a small-message burst through the coalescing queues
    h_bump = core.register_ifunc(source, "counter_bump", lib_dir)
    hosts = [n for n, p in d.peers.items() if p.fabric.kind != "device"]
    for name in hosts:
        d.send_ifunc(name, h_bump, b"warm")
    d.drain()
    burst = [bytes([i & 0x7F]) * 8 for i in range(BURST)]
    for name in hosts:
        assert d.send_ifunc_many(name, h_bump, burst) == BURST
    d.drain()
    for name in hosts:
        assert d.peers[name].target_args["count"] == BURST + 1
    return d, obs, payloads, W, retries


def _results(peer):
    return [np.asarray(r).reshape(T, T) for r in peer.target_args["results"]]


def test_multi_peer_host_lanes_match_reference(lib_dir, ref_uvm_oracle):
    """The example's host peers, port against reference: the same sends,
    SLIM switches, backpressure, coalesced containers, stats, bytes and
    obs counters; every result relu(x @ W) in send order."""
    (rd, _, pays, W, rr), (pd, pobs, _, _, pr) = (
        _multi_peer(pkg, lib_dir, device_peer=False) for pkg in PKGS)
    assert pr == rr > 0
    expect = [np.maximum(p[0] @ W, 0) for p in pays]
    for name in pd.peers:
        for got in (_results(pd.peers[name]), _results(rd.peers[name])):
            assert len(got) == N_MSGS
            for g, e in zip(got, expect):
                np.testing.assert_allclose(g, e, **TOL)
    same_run(rd, pd)
    st = pd.per_peer_stats()
    assert all(s["slim_sent"] > 0 and s["agg_sent"] > 0 for s in st.values())
    assert pobs.tracer.open_count() == 0


def test_multi_peer_example_with_device_peer(lib_dir, tmp_path):
    """The whole example on the port: four peers on three fabric kinds,
    every result within 1e-4 of relu(x @ W) (the device shards may
    reorder), the gates passed."""
    d, obs, pays, W, retries = _multi_peer(PORT, lib_dir, device_peer=True)
    expect = [np.maximum(p[0] @ W, 0) for p in pays]
    prog = ref_deserialize_uvm(d.src_ctx.handles["uvm_affine"].lib.code)
    for name, peer in d.peers.items():
        results = _results(peer)
        assert len(results) == N_MSGS, name
        matched = set()
        for r in results:
            j = next(j for j, e in enumerate(expect)
                     if j not in matched and np.allclose(r, e, **TOL))
            matched.add(j)
            np.testing.assert_allclose(
                r, ifunc_vm_ref(prog, pays[j], W[None])[0], **TOL)
    gpu = d.peers["gpu"].stats
    assert gpu["slim_sent"] == gpu["sent"] == gpu["delivered"] == N_MSGS
    assert retries > 0
    chip_smoke.multi_peer_gates(d, obs, tmp_path / "trace.json")
    assert (tmp_path / "trace.json").stat().st_size > 0


def _offload(pkg, lib_dir, stage):
    """``examples/offload_compress.py`` through ``pkg``, the codec staged
    from ``lib_dir`` into ``stage``."""
    core, T_ = pkg.core, pkg.transport
    shutil.copy(lib_dir / "rle_insert.py", stage / "rle_insert.py")
    storage = ctx(pkg, "storage", stage, link_mode="remote")
    db = {"db": []}
    records = [bytes([i % 7]) * 400 for i in range(64)]
    stats = []

    def ingest(name, recs):
        d = T_.Dispatcher(ctx(pkg, name, stage),
                          T_.ProgressEngine(flush_threshold=4))
        d.add_peer("storage", T_.RdmaFabric(), storage, n_slots=8,
                   slot_size=8 << 10, target_args=db)
        h = core.register_ifunc(d.src_ctx, "rle_insert")
        for r in recs:
            while not d.send("storage", core.ifunc_msg_create(h, r)):
                d.drain()
        d.drain()
        stats.append((d.per_peer_stats()["storage"], dict(d.stats),
                      dict(d.engine.stats)))

    ingest("ingest", records[:32])
    v1_links = storage.stats["links"]
    v2 = (stage / "rle_insert.py").read_text().replace(
        'target_args["db"].append(record)',
        'target_args["db"].append(record)\n    target_args["v2_count"] = '
        'target_args.get("v2_count", 0) + 1')
    (stage / "rle_insert.py").write_text(v2)
    ingest("ingest2", records[32:])
    assert db["db"] == records and db["v2_count"] == 32
    assert (v1_links, storage.stats["links"]) == (1, 2)
    return db, dict(storage.stats), stats


def test_offload_compress_matches_reference(lib_dir, tmp_path):
    """The hot codec swap under the same name, storage never restarted:
    the same records, links, ring stats and backpressure in both."""
    out = []
    stage = tmp_path / "stage"      # one path: co_filename is in the code
    for pkg in (REF, PORT):
        shutil.rmtree(stage, ignore_errors=True)
        stage.mkdir()
        out.append(_offload(pkg, lib_dir, stage))
    (rdb, rst, rstats), (pdb, pst, pstats) = out
    assert pdb == rdb and pst == rst
    drop = lambda s: {k: v for k, v in s.items()  # noqa: E731
                      if k != "oldest_inflight_s"}
    assert [tuple(drop(x) for x in s) for s in pstats] == \
        [tuple(drop(x) for x in s) for s in rstats]


def test_offload_compress_port_library(tmp_path):
    """Phase 19's hot swap, from the port's own ``rle_insert``."""
    db = chip_smoke.offload_compress(tmp_path)
    assert len(db["db"]) == 64 and db["v2_count"] == 32


def test_chip_smoke_phase19_path_on_cpu(tmp_path):
    """``chip_smoke.py`` phase 19's counted path at a small size on the CPU:
    the four peers over three generations (the mid-generation eviction on
    rdma_b NACKs and resends in ring order), the coalesced burst at 64
    records a container, and the gates."""
    d, _, _, _, res = chip_smoke.multi_peer_path(
        np, torch, torch.device("cpu"), tmp_path, shards=2, dev_slots=2,
        host_slots=4, gens=3, burst=128)
    assert res["occupancy"] == chip_smoke.MP_AGG
    assert res["host_frames"] == 3 * 4 * 3 and res["sweeps"] >= 3
    assert d.peers["rdma_b"].stats["resent"] == 2
    for q in (res["act_one"], res["act_two"]):
        assert {"transport.deliver_us", "target.sweep_us",
                "target.exec_us"} <= set(q)


def test_chip_smoke_phase20_path_on_cpu():
    """``chip_smoke.py`` phase 20's counted path at a small size on the CPU:
    μVM futures to the two host peers (through their reply rings) and the
    device peer over three generations, the coalesced task_sum burst with
    its poisoned records, the aggregate device lane's futures, and the
    liveness checks on a wedged csd."""
    rt, _, _, _, res = chip_smoke.futures_path(
        np, torch, torch.device("cpu"), shards=2, dev_slots=2, host_slots=8,
        gens=3, burst=128, agg_slots=2, agg_k=4, live=2)
    d = rt.dispatcher
    assert res["host_futures"] == 3 * 4 * 2 and res["failed"] == 4
    assert len(res["gen_s"]) == 3 and rt.pending() == 0
    assert {"task.reply_us", "transport.deliver_us", "target.sweep_us",
            "target.exec_us"} <= set(res["lat"])
    assert res["lat"]["task.reply_us"][2] == 3 * 4 * 3   # one a μVM future
    for name in ("rdma", "csd"):
        s = d.peers[name].stats
        assert s["agg_replies"] >= 2 and s["nacks"] == s["rejected"] == 0
    assert d.stats["reply_dropped"] == 0
    assert rt.stats["orphan_replies"] == 4               # the dead's replies
    assert d.obs.tracer.open_count() == 0
