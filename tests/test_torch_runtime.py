"""The port's runtime (``repro_torch.runtime``: checkpoints, fleet state,
stragglers, the control plane) held against the reference's
``repro.runtime`` on the same inputs.

* The checkpoint, elastic and file-backed data cases of
  ``tests/test_runtime.py``, each run through both packages: the two
  checkpoints of the same state are equal file for file
  (``manifest.json`` included), and every outcome is equal.  Its
  ``test_data_determinism_and_disjoint_streams`` and
  ``test_loader_prefetch`` are covered by
  ``tests/test_torch_train.py::test_data_pipeline_matches_reference``.
* A cross-package checkpoint of a small bf16 SmolLM-shaped train state
  (the reference's parameters carried across with
  ``convert.params_from_numpy``), in both directions: the two saves are
  equal file for file and each package restores the other's bit for bit.
* ``tests/test_transport.py::test_controller_inject_flushes_despite_refusal``
  and ``tests/test_system.py::test_control_plane_drives_training`` (f32,
  the reference's parameters carried across, each step's loss within
  ``tests/test_torch_train.py``'s tolerance).
"""

import filecmp
import json
import struct
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as RD
import repro.runtime as RR
import repro_torch.data as PD
import repro_torch.runtime as PR
from repro import configs as RC
from repro.models import transformer as RT
from repro.models.config import ModelConfig as RModelConfig
from repro.train import optim as RO
from repro.train import step as RS
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.config import ModelConfig as PModelConfig
from repro_torch.train import optim as PO
from repro_torch.train import step as PS
from test_models import reduced
from test_torch_train import TINY_KW, TOL, _port_cfg
from test_torch_transport import PORT, REF, ctx, same_run

RPKG = types.SimpleNamespace(**vars(REF), runtime=RR, data=RD)
PPKG = types.SimpleNamespace(**vars(PORT), runtime=PR, data=PD)
PKGS = (RPKG, PPKG)


def _bits(x) -> bytes:
    """A leaf's bytes (bf16 as its 16-bit patterns, ints as int32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.contiguous().numpy().tobytes()
    if isinstance(x, int):
        return np.int32(x).tobytes()
    return np.asarray(x).tobytes()


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {"/".join(map(str, path)): tree}


def same_bits(a, b):
    fa, fb = _flat(a), _flat(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert _bits(fa[k]) == _bits(fb[k]), k


def same_dirs(a, b):
    """Two checkpoint directories hold the same files, byte for byte."""
    na = sorted(p.name for p in a.iterdir())
    assert na == sorted(p.name for p in b.iterdir())
    for name in na:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


def _meta(tree):
    """A restore template: every tensor leaf on the meta device."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def _sds(tree):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)


def _state(pkg, seed=0):
    """``tests/test_runtime.py``'s state, from numpy draws."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    if pkg is RPKG:
        return {"params": {"w": jnp.asarray(w), "b": jnp.arange(4.0)},
                "opt": {"m": {"w": jnp.zeros((8, 8)), "b": jnp.zeros(4)}},
                "step": jnp.int32(7)}
    return {"params": {"w": torch.from_numpy(w), "b": torch.arange(4.0)},
            "opt": {"m": {"w": torch.zeros(8, 8), "b": torch.zeros(4)}},
            "step": 7}


def _like(pkg, st):
    return _sds(st) if pkg is RPKG else _meta(st)


def _restore(pkg, cm, like, **kw):
    if pkg is PPKG:
        kw["device"] = "cpu"
    return cm.restore(like, **kw)


# ---------------------------------------------------------------------------
# checkpoints


def _roundtrip(pkg, d):
    cm = pkg.runtime.CheckpointManager(d)
    st = _state(pkg)
    cm.save(7, st)
    back = _restore(pkg, cm, _like(pkg, st))
    same_bits(back, st) if pkg is PPKG else jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)), st, back)
    return cm


def test_checkpoint_roundtrip(tmp_path):
    for pkg in PKGS:
        _roundtrip(pkg, tmp_path / pkg.name)
    same_dirs(tmp_path / "ref" / "step_7", tmp_path / "port" / "step_7")
    back = PR.CheckpointManager(tmp_path / "ref").restore(
        _meta(_state(PPKG)), device="cpu", verify=True)
    same_bits(back, _state(PPKG))
    assert isinstance(back["step"], int) and back["step"] == 7


def test_checkpoint_async_and_retention(tmp_path):
    for pkg in PKGS:
        cm = pkg.runtime.CheckpointManager(tmp_path / pkg.name, keep=2)
        st = _state(pkg)
        for s in (1, 2, 3):
            cm.save(s, st, blocking=False)
            cm.wait()
        assert cm.steps() == [2, 3] and cm.latest_step() == 3
    for s in (2, 3):
        same_dirs(tmp_path / "ref" / f"step_{s}",
                  tmp_path / "port" / f"step_{s}")
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        ["step_2", "step_3"]
    assert [h["step"] for h in cm.history] == [1, 2, 3]
    assert all(h["bytes"] == 8 * 8 * 4 + 4 * 4 * 2 + 8 * 8 * 4 + 4
               for h in cm.history)


def test_checkpoint_corruption_detected(tmp_path):
    msgs = []
    for pkg in PKGS:
        cm = pkg.runtime.CheckpointManager(tmp_path / pkg.name)
        st = _state(pkg)
        cm.save(1, st)
        target = next((tmp_path / pkg.name / "step_1").glob("params__w.npy"))
        raw = bytearray(target.read_bytes())
        raw[-1] ^= 0xFF
        target.write_bytes(raw)
        with pytest.raises(IOError) as e:
            _restore(pkg, cm, _like(pkg, st), verify=True)
        msgs.append(str(e.value))
        _restore(pkg, cm, _like(pkg, st))      # unverified: reads through
    assert msgs[1] == msgs[0] == "checkpoint corruption in params/w"


def test_checkpoint_missing_leaf_init(tmp_path):
    outs = []
    for pkg in PKGS:
        cm = pkg.runtime.CheckpointManager(tmp_path / pkg.name)
        st = _state(pkg)
        cm.save(1, st)
        like = _like(pkg, st)
        like["params"]["new"] = (
            jax.ShapeDtypeStruct((2,), jnp.float32) if pkg is RPKG
            else torch.empty(2, device="meta"))
        with pytest.raises(KeyError) as e:
            _restore(pkg, cm, like)
        out = _restore(pkg, cm, like, init_missing=lambda key, sds: np.ones(
            sds.shape, np.float32))
        np.testing.assert_allclose(np.asarray(out["params"]["new"]), [1, 1])
        outs.append((str(e.value), np.asarray(out["params"]["new"]).dtype))
    assert outs[1] == outs[0]
    assert isinstance(out["params"]["new"], torch.Tensor)


def test_torn_write_never_visible(tmp_path):
    for pkg in PKGS:
        d = tmp_path / pkg.name
        cm = pkg.runtime.CheckpointManager(d)
        cm.save(1, _state(pkg))
        (d / "step_2").mkdir()
        (d / "step_2" / "params__w.npy").write_bytes(b"junk")
        assert cm.latest_step() == 1 and cm.steps() == [1]
        with pytest.raises(FileNotFoundError):
            pkg.runtime.CheckpointManager(d / "empty").restore(
                _like(pkg, _state(pkg)))


# ---------------------------------------------------------------------------
# a train state across packages


def _train_states(seed=3):
    """A bf16 SmolLM-shaped train state (reduced width) of the reference,
    its AdamW moments drawn from numpy, and the same state in the port."""
    cfg_r = reduced(RC.get_config("smollm_360m"))
    cfg_p = _port_cfg(cfg_r)
    assert cfg_r.param_dtype == "bfloat16"
    params = RT.init_params(cfg_r, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    mv = {k: {n: rng.standard_normal(params[n].shape).astype(np.float32)
              for n in params} for k in ("m", "v")}
    ref = {"params": params,
           "opt": {"m": {n: jnp.asarray(a) for n, a in mv["m"].items()},
                   "v": {n: jnp.asarray(a) for n, a in mv["v"].items()},
                   "count": jnp.int32(3)},
           "step": jnp.int32(3)}
    port = {"params": params_from_numpy(cfg_p, {k: np.asarray(v) for k, v in
                                                params.items()}, "cpu"),
            "opt": {k: {n: tensor_from_numpy(a, "cpu")
                        for n, a in mv[k].items()} for k in ("m", "v")}
            | {"count": 3},
            "step": 3}
    assert port["params"]["tok_embed"].dtype == torch.bfloat16
    return ref, port


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference",
                                       "reference_to_port_placed"])
def test_train_state_checkpoint_across_packages(tmp_path, direction):
    """Both packages save the same bf16 train state into equal files; the
    port restores the reference's checkpoint, and the reference the
    port's, each bit for bit; with ``placements=`` (a one-rank gloo mesh)
    the port's leaves come back as DTensors with the rules' placements,
    whole bit for bit."""
    ref, port = _train_states()
    RR.CheckpointManager(tmp_path / "ref").save(3, ref)
    cm = PR.CheckpointManager(tmp_path / "port")
    cm.save(3, port, blocking=False)
    cm.wait()
    same_dirs(tmp_path / "ref" / "step_3", tmp_path / "port" / "step_3")
    manifest = json.loads((tmp_path / "port" / "step_3" / "manifest.json")
                          .read_text())["leaves"]
    assert manifest["step"]["dtype"] == "int32" and \
        manifest["step"]["shape"] == []
    assert manifest["params/tok_embed"]["dtype"] == "bfloat16"
    assert list(manifest) == sorted(manifest)
    if direction == "reference_to_port":
        back = PR.CheckpointManager(tmp_path / "ref").restore(
            _meta(port), device="cpu", verify=True)
        same_bits(back, port)
        assert back["step"] == 3 and back["opt"]["count"] == 3
    elif direction == "reference_to_port_placed":
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor

        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.parallel import sharding as SH

        cfg_p = _port_cfg(reduced(RC.get_config("smollm_360m")))
        shapes, axes = PS.train_state_specs(cfg_p, PO.OptConfig())
        try:
            mesh = make_host_mesh("cpu")
            sh = SH.tree_shardings(axes, shapes, mesh)
            back = PR.CheckpointManager(tmp_path / "ref").restore(
                _meta(port), placements=sh, verify=True)
            for k, v in back["params"].items():
                assert isinstance(v, DTensor)
                assert v.placements == sh["params"][k].placements
            same_bits({"params": {k: v.full_tensor()
                                  for k, v in back["params"].items()},
                       "opt": {g: {k: v.full_tensor()
                                   for k, v in back["opt"][g].items()}
                               for g in ("m", "v")}
                       | {"count": back["opt"]["count"]},
                       "step": back["step"]}, port)
        finally:
            dist.destroy_process_group()
    else:
        back = RR.CheckpointManager(tmp_path / "port").restore(
            _sds(ref), verify=True)
        fr, fb = _flat(ref), _flat(back)
        assert list(fr) == list(fb)
        for k in fr:
            a, b = np.asarray(fr[k]), np.asarray(fb[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k


# ---------------------------------------------------------------------------
# elastic: fleet membership and stragglers


def _membership(pkg):
    f = pkg.runtime.FleetState([f"w{i}" for i in range(4)],
                               heartbeat_deadline=1.0)
    now = 100.0
    for w in list(f.workers):
        f.heartbeat(w, now)
    assert f.sweep_dead(now + 0.5) == []
    f.heartbeat("w0", now + 2.0)
    dead = f.sweep_dead(now + 2.0)
    assert set(dead) == {"w1", "w2", "w3"}
    a = f.shard_assignment(8)
    assert sorted(sum(a.values(), [])) == list(range(8))
    assert set(a) == {"w0"}
    g1 = f.generation
    f.heartbeat("w1", now + 2.5)      # rejoin
    assert f.generation > g1
    a2 = f.shard_assignment(8)
    assert set(a2) == {"w0", "w1"}
    assert a2 == f.shard_assignment(8)    # same membership, same assignment
    return dead, a, a2, f.generation, f.alive()


def test_fleet_membership_and_reassignment():
    assert _membership(PPKG) == _membership(RPKG)


def _stragglers(pkg):
    sm = pkg.runtime.StragglerMitigator(k=3.0, min_samples=4)
    f = pkg.runtime.FleetState([f"w{i}" for i in range(8)])
    for w in f.workers:
        f.heartbeat(w, 0.0)
    for i in range(8):
        for w in f.workers:
            sm.record(w, 1.0 + (5.0 if w == "w3" and i >= 4 else 0.0))
    assert sm.stragglers() == ["w3"]
    plan = sm.backup_plan(8, f)
    assert plan and all(v in range(8) for v in plan.values())
    assert "w3" not in plan           # backups go to non-stragglers
    return sm.stragglers(), plan, sm.times


def test_straggler_detection_and_backup():
    assert _stragglers(PPKG) == _stragglers(RPKG)


def test_file_backed_dataset(tmp_path):
    toks = np.arange(10_000, dtype=np.uint16) % 512
    p = tmp_path / "tokens.bin"
    toks.tofile(p)
    got = []
    for pkg in PKGS:
        ds = pkg.data.TokenDataset(512, path=str(p))
        b = ds.batch(0, 0, 1, 2, 8)
        assert b["tokens"].shape == (2, 8)
        assert b["tokens"].max() < 512
        got.append([ds.batch(s, 1, 3, 2, 8) for s in range(4)])
    for br, bp in zip(*got):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(bp[k], br[k])


# ---------------------------------------------------------------------------
# the control plane


def _inject_refusal(pkg, lib_dir):
    """A full mailbox on one worker must not leave frames to healthy
    workers trailer-withheld (unconsumable)."""
    X, R = pkg.transport, pkg.runtime
    eng = X.ProgressEngine(flush_threshold=64, inflight_window="trailer")
    ctl = R.PodController(ctx(pkg, "ctl", lib_dir), engine=eng)
    healthy = R.WorkerAgent("healthy", ctx(pkg, "healthy", lib_dir),
                            n_slots=4, slot_size=8 << 10)
    stuck = R.WorkerAgent("stuck", ctx(pkg, "stuck", lib_dir),
                          n_slots=1, slot_size=8 << 10)
    ctl.attach(healthy)
    ctl.attach(stuck)
    sent = ctl.inject("ctl_probe", b"one")     # fills stuck's single slot
    with pytest.raises(X.TransportError, match="stuck") as e:
        ctl.inject("ctl_probe", b"two")        # stuck refuses...
    healthy.ctx.max_trailer_spins = 10
    assert healthy.poll() == 2                 # ...healthy still got both
    assert healthy.hooks["acks"] == [b"one", b"two"]
    return ctl, (sent, str(e.value), healthy.hooks["acks"],
                 ctl.per_worker_stats())


def test_controller_inject_flushes_despite_refusal(lib_dir):
    (rctl, rout), (pctl, pout) = (_inject_refusal(pkg, lib_dir)
                                  for pkg in PKGS)
    drop = lambda s: {n: {k: v for k, v in st.items()  # noqa: E731
                          if k != "oldest_inflight_s"}
                      for n, st in s.items()}
    assert pout[:3] == rout[:3]
    assert drop(pout[3]) == drop(rout[3])
    same_run(rctl.dispatcher, pctl.dispatcher)


def test_control_plane_drives_training(tmp_path, lib_dir):
    """The controller injects set_lr, checkpoint and probe ifuncs into a
    worker between train steps of the tiny f32 model, in both packages
    from the same parameters and batch: the same hooks fire at the same
    steps, each step's loss agrees within the training tests' tolerance,
    and each checkpoint restores onto a fresh state."""
    cfg_r, cfg_p = RModelConfig(**TINY_KW), PModelConfig(**TINY_KW)
    opt = dict(lr=1e-3, schedule="constant", warmup_steps=1)
    params_r = RT.init_params(cfg_r, jax.random.PRNGKey(0))
    params_p = params_from_numpy(cfg_p, {k: np.asarray(v) for k, v in
                                         params_r.items()}, "cpu")
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, 64, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    runs = []
    for pkg in PKGS:
        if pkg is RPKG:
            step = jax.jit(RS.make_train_step(cfg_r, RO.OptConfig(**opt)))
            init = RS.make_train_step(cfg_r, RO.OptConfig(**opt)).init_opt
            state = {"params": params_r, "opt": init(params_r),
                     "step": jnp.zeros((), jnp.int32)}
            b = {k: jnp.asarray(v) for k, v in batch.items()}
        else:
            step = PS.make_train_step(cfg_p, PO.OptConfig(**opt))
            state = {"params": params_p, "opt": step.init_opt(params_p),
                     "step": 0}
            b = {k: torch.from_numpy(v) for k, v in batch.items()}
        cm = pkg.runtime.CheckpointManager(tmp_path / pkg.name / "ckpt")
        ckpts = []
        agent = pkg.runtime.WorkerAgent("w0", ctx(pkg, "w0", lib_dir))
        agent.hooks["checkpoint"] = lambda s: (cm.save(s, state),
                                               ckpts.append(s))
        agent.hooks["lr_scale"] = 1.0
        ctl = pkg.runtime.PodController(ctx(pkg, "ctl", lib_dir))
        ctl.attach(agent)
        losses, polled = [], []
        for i in range(6):
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
            if i == 1:
                ctl.inject("ctl_set_lr", struct.pack("<d", 0.5))
            if i == 3:
                ctl.inject("ctl_checkpoint",
                           int(metrics["step"]).to_bytes(8, "little"))
            polled.append(agent.poll())
        assert agent.hooks["lr_scale"] == 0.5
        assert ckpts == [4]
        assert cm.latest_step() == 4
        assert ctl.broadcast_until_acked("ctl_probe", b"ping")
        assert b"ping" in agent.hooks["acks"]
        like = _sds(state) if pkg is RPKG else _meta(state)
        restored = _restore(pkg, cm, like)
        assert int(restored["step"]) == 4
        agent.hooks.pop("checkpoint")    # a closure of this run: not state
        runs.append((losses, polled, agent.hooks["acks"], ckpts, ctl,
                     restored))
    (rl, rp, ra, rc, rctl, rres), (pl, pp, pa, pc, pctl, pres) = runs
    np.testing.assert_allclose(pl, rl, rtol=TOL, atol=TOL)
    assert (pp, pa, pc) == (rp, ra, rc)
    same_run(rctl.dispatcher, pctl.dispatcher)
    for k, v in _flat(rres).items():
        np.testing.assert_allclose(_flat(pres)[k], np.asarray(v),
                                   rtol=TOL, atol=TOL, err_msg=k)
    ref_m = json.loads((tmp_path / "ref/ckpt/step_4/manifest.json")
                       .read_text())["leaves"]
    port_m = json.loads((tmp_path / "port/ckpt/step_4/manifest.json")
                        .read_text())["leaves"]
    assert [(k, v["file"], v["shape"], v["dtype"]) for k, v in
            port_m.items()] == [(k, v["file"], v["shape"], v["dtype"])
                                for k, v in ref_m.items()]


# ---------------------------------------------------------------------------
# chip_smoke.py phase 24's parts, small, on the CPU


def test_chip_smoke_phase24_parts_on_cpu(tmp_path, monkeypatch):
    """Phase 24 (a)'s train driver over a reduced bf16 SmolLM on the CPU
    (no kernel launches there, so none expected): the hot LR update, the
    async checkpoints with only the last kept, the verified restore equal
    to the live state and resume equal to continue, all bit for bit; and
    (c)'s ``fig_elastic`` rows at one deadline, recovery not before it."""
    import chip_smoke

    cfg = _port_cfg(reduced(RC.get_config("smollm_360m"))).with_(
        remat="block")
    monkeypatch.setattr(chip_smoke, "train_launches_per_step",
                        lambda cfg, mb: {})
    dev = torch.device("cpu")
    got = chip_smoke.train_driver(np, torch, dev, "cpu", tmp_path,
                                  cfg=cfg, shape=(2, 32, 2))
    assert got == {}
    rows = chip_smoke.fig_elastic(torch, dev, deadlines_ms=(100,),
                                  repeats=1, n_msgs=64)
    assert [r["cell"] for r in rows] == ["recover/100ms", "hb_overhead"]
    assert rows[0]["ratio"] >= 0.8 and rows[1]["msgs_per_s"] > 0
