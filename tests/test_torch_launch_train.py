"""The port's sharded train launcher (``repro_torch.launch.train``) held
against the reference's ``repro.launch.train``.

* ``reduced``: the port's copy equals ``tests/test_models.py::reduced``
  field by field for all ten configs.
* Resume: ``main(["--arch", a, "--mesh", "host", "--reduced", "--device",
  "cpu", ...])`` at world size 1 (this process) and 2 (gloo ranks spawned
  with a ``FileStore`` and a time limit, ``test_torch_parallel.spawn``)
  resumes from its own checkpoint, and its losses and state after the
  resume equal an uninterrupted run's bit for bit.
* Across packages: the reference's ``main`` writes a checkpoint (f32, its
  ``reduced_cfg`` overridden here); both launchers resume from it for two
  steps, and their losses agree (tolerance below).
* ``chip_smoke.py`` phase 26's parts at a reduced size on the CPU; phase
  14's draws (each shape's own seed), phase 17's models, launches and
  training shapes, and its meta estimate of a step's peak against the
  live bytes of the same step on CPU tensors.

Run as a script, this file is one rank of such a spawn.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import shutil

import numpy as np
import pytest
import torch

from repro_torch import configs as PC

from test_torch_parallel import init_rank_group, spawn

ARCHS = ("smollm_360m", "qwen3_moe_30b_a3b")
STEPS, RESUME_AT = 4, 2
SHAPE = ("--batch", "2", "--seq", "16")
# Cross-package: the first resumed step starts from the same restored f32
# state and batch, so its loss differs only by summation order (XLA's
# against PyTorch's, ~1e-7 relative); the second follows one AdamW update,
# whose normalised step m / sqrt(v) turns that rounding in near-zero
# gradient entries into parameter differences of up to lr (5e-4 at step
# 5), about 1e-5 of the loss.
TOL_CROSS = (1e-6, 1e-4)


def argv(arch, ckpt, steps, *extra):
    return ["--arch", arch, "--mesh", "host", "--reduced", "--device", "cpu",
            "--steps", str(steps), "--ckpt", str(ckpt), "--ckpt-every",
            str(RESUME_AT), *SHAPE, *extra]


def leaves(state, path=()):
    if isinstance(state, dict):
        for k in sorted(state):
            yield from leaves(state[k], path + (k,))
    else:
        yield "/".join(path), (state.to_local() if hasattr(state, "to_local")
                               else state)


def bits_equal(a, b):
    if isinstance(a, int) or isinstance(b, int):
        return a == b
    iv = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(iv),
                                              b.contiguous().view(iv))


def resume_runs(arch, root):
    """An uninterrupted run of STEPS and one stopped after RESUME_AT and
    resumed: (losses, final local state leaves) of each."""
    from repro_torch.launch import train as LT

    whole = LT.main(argv(arch, root / "whole", STEPS))
    LT.main(argv(arch, root / "part", RESUME_AT))
    rest = LT.main(argv(arch, root / "part", STEPS - RESUME_AT))
    return ((whole["losses"], dict(leaves(whole["state"]))),
            (rest["losses"], dict(leaves(rest["state"]))))


def _rank_main(argv_=None):
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    for a in ("--world", "--rank"):
        ap.add_argument(a, type=int)
    for a in ("--store", "--out"):
        ap.add_argument(a)
    a = ap.parse_args(argv_)
    init_rank_group(a.world, a.rank, a.store)
    out = pathlib.Path(a.out)
    try:
        res = {arch: resume_runs(arch, out / arch)     # one directory
               for arch in ARCHS}
    finally:
        dist.destroy_process_group()
    torch.save(res, out / f"rank{a.rank}.pt")


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", PC.ARCH_IDS)
def test_reduced_equals_reference(arch):
    from repro import configs as RC
    from repro_torch.launch.train import reduced
    from test_models import reduced as ref_reduced

    ref = ref_reduced(RC.get_config(arch))
    got = reduced(PC.get_config(arch))
    assert {f.name: getattr(got, f.name) for f in dataclasses.fields(got)} \
        == {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}


def _check_resume(whole, rest):
    (l_whole, s_whole), (l_rest, s_rest) = whole, rest
    assert len(l_whole) == STEPS and l_rest == l_whole[RESUME_AT:]
    assert set(s_whole) == set(s_rest)
    for k, v in s_whole.items():
        assert bits_equal(s_rest[k], v), k


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_resumes_bit_for_bit(arch, tmp_path, capsys):
    """World size 1, the launcher's own one-rank gloo group: the run
    resumed after step 2 equals the uninterrupted one bit for bit."""
    import torch.distributed as dist

    whole, rest = resume_runs(arch, tmp_path)
    _check_resume(whole, rest)
    out = capsys.readouterr().out
    assert f"resumed from step {RESUME_AT}" in out
    assert "step    1 loss=" in out and "done; checkpoints: [2, 4]" in out
    assert not dist.is_initialized()       # main tore its group down


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return spawn(2, pathlib.Path(__file__),
                 tmp_path_factory.mktemp("launch2"))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_resumes_bit_for_bit_two_ranks(two_ranks, arch):
    """World size 2 (gloo, a (2, 1) mesh: the batch and the
    ``embed``-split leaves over ``data``): each rank's resumed run equals
    its uninterrupted one bit for bit, and the ranks agree on the
    losses."""
    for r in two_ranks:
        _check_resume(*r[arch])
        assert r[arch][0][0] == two_ranks[0][arch][0][0]


def test_launcher_refuses_what_it_cannot_run(tmp_path):
    """A production mesh on a one-rank group and the card without CUDA
    raise before any step."""
    from repro_torch.launch import train as LT

    with pytest.raises(ValueError, match="256 ranks"):
        LT.main(argv("smollm_360m", tmp_path, 1) + ["--mesh", "pod"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LT.main(["--arch", "smollm_360m", "--reduced", "--device",
                     "cuda", "--ckpt", str(tmp_path)])


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_resume_the_reference_checkpoint(arch, tmp_path,
                                                   monkeypatch):
    """The reference's ``main`` trains RESUME_AT steps in f32 and writes
    its checkpoint; each package's launcher resumes it for two steps on
    the same batches: the losses agree within ``TOL_CROSS``."""
    import jax

    import repro.launch.train as RLT
    from repro_torch.launch import train as LT
    from test_models import reduced as ref_reduced

    f32 = dict(dtype="float32", param_dtype="float32")
    monkeypatch.setattr(RLT, "reduced_cfg",
                        lambda cfg: ref_reduced(cfg).with_(**f32))
    monkeypatch.setattr(LT, "reduced_cfg",
                        lambda cfg: LT.reduced(cfg).with_(**f32))
    losses = []
    real_jit = jax.jit

    def jit(fn, **kw):                      # the reference's step, recorded
        f = real_jit(fn, **kw)
        if kw.get("donate_argnums") != 0:
            return f

        def step(*a):
            out = f(*a)
            losses.append(float(out[1]["loss"]))
            return out
        return step

    def ref_argv(ckpt, steps):             # one checkpoint, at the end
        return ["--arch", arch, "--mesh", "host", "--reduced", "--steps",
                str(steps), "--ckpt", str(ckpt), "--ckpt-every", "100",
                *SHAPE]

    monkeypatch.setattr(jax, "jit", jit)
    RLT.main(ref_argv(tmp_path / "ref", RESUME_AT))
    for d in ("ref_resumed", "port"):
        shutil.copytree(tmp_path / "ref", tmp_path / d)
    del losses[:]
    RLT.main(ref_argv(tmp_path / "ref_resumed", 2))
    got = LT.main(argv(arch, tmp_path / "port", 2))["losses"]
    assert len(losses) == len(got) == 2
    for (a, b), tol in zip(zip(got, losses), TOL_CROSS):
        assert abs(a - b) <= tol * abs(b), (got, losses)


def test_chip_smoke_phase26_parts_on_cpu(tmp_path, monkeypatch):
    """Phase 26 (a)'s launcher run over a reduced bf16 SmolLM on the CPU
    (no kernel launches there, so none expected): DTensor state with the
    rules' placements, losses and state bit for bit the direct step's,
    the resume bit for bit; and (b)'s MoE branch for a reduced Qwen3
    under a one-rank gloo mesh against the dense path, equal in value."""
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.launch.train import reduced

    from repro_torch.launch.mesh import init_one_rank_group

    monkeypatch.setattr(chip_smoke, "train_launches_per_step",
                        lambda cfg, mb: {})
    dev = torch.device("cpu")
    init_one_rank_group(dev)        # the phase's group, as on the card
    try:
        run = chip_smoke.launcher_run(np, torch, dev, "cpu", tmp_path,
                                      reduced=True, shape=(2, 32, 2),
                                      steps=4, resume_at=2)
        cfg = reduced(PC.get_config("qwen3_moe_30b_a3b"))
        moe = chip_smoke.moe_mesh_branch(np, torch, dev, cfg, 2, 32, 2, 426)
    finally:
        dist.destroy_process_group()
    assert len(run["losses"]) == 4 and run["idle"] is None
    assert not any(run["launches"].values())
    assert not list(tmp_path.iterdir())
    assert moe["calls"] == 6 * 2 * 2 and moe["leaves"] > 0


def test_chip_smoke_phase14_draws_are_each_shapes_own(monkeypatch):
    """Phase 14 draws each shape's q, k, v and dO from the shape's own
    seed: the same inputs whether the shape runs alone, after others or
    before them.  On the CPU the f32 wrappers take their plain versions;
    the bf16 ones are given the bf16 kernels' rounding (the twin's
    outputs rounded to bf16), which the CPU's plain versions lack."""
    import chip_smoke
    from repro_torch.kernels import flash_attn as FA

    real = chip_smoke.flash_bwd_inputs
    drawn = []

    def spy(np_, torch_, dev, rng, BH, S, hd, window, dtype):
        out = real(np_, torch_, dev, rng, BH, S, hd, window, dtype)
        drawn.append(((BH, S, hd, window, dtype),
                      [t.clone() for t in out[:4]]))
        return out

    def rounded(real_fn, pick):
        def fn(q, k, v, do, lse, delta, *, scale, window):
            if q.dtype == torch.float32:
                return real_fn(q, k, v, do, lse, delta, scale=scale,
                               window=window)
            out = FA.flash_bwd_plain_bf16(q, k, v, do, lse, delta,
                                          scale=scale, window=window)
            return pick([t.to(q.dtype) for t in out])
        return fn

    monkeypatch.setattr(chip_smoke, "flash_bwd_inputs", spy)
    monkeypatch.setattr(FA, "flash_bwd_dq",
                        rounded(FA.flash_bwd_dq, lambda o: o[0]))
    monkeypatch.setattr(FA, "flash_bwd_dkv",
                        rounded(FA.flash_bwd_dkv, lambda o: tuple(o[1:])))
    a, b, c = (2, 32, 64, 0), (1, 48, 96, 8), (3, 16, 64, 0)
    runs = {}
    for shapes in ((a, b, c), (c,), (b, c, a), (c, a)):
        drawn.clear()
        monkeypatch.setattr(chip_smoke, "bwd_shapes", lambda: shapes)
        chip_smoke.phase_bwd_kernels(np, torch, torch.device("cpu"))
        assert [key[:4] for key, _ in drawn] == [
            x for x in shapes for _ in range(2)]
        for key, ts in drawn:
            runs.setdefault(key, []).append(ts)
    assert [len(runs[(*x, torch.float32)]) for x in (a, b, c)] == [3, 2, 4]
    for key, draws in runs.items():
        for ts in draws[1:]:
            assert all(torch.equal(x, y) for x, y in zip(draws[0], ts)), key
    f32, bf16 = runs[(*c, torch.float32)][0], runs[(*c, torch.bfloat16)][0]
    assert not torch.equal(f32[0].to(torch.bfloat16), bf16[0])
    first = runs[(*a, torch.float32)][0][0]
    assert not torch.equal(first[:1, :16], f32[0][:1])


# phase 17's new models: (arch, the flash shape of one microbatch,
# launches a step of flash_fwd, flash_bwd_dq, flash_bwd_dkv)
PHASE17_NEW = [("internlm2_1_8b", (32, 2048, 128, 0), (96, 48, 48)),
               ("qwen1_5_4b", (40, 2048, 128, 0), (160, 80, 80)),
               ("minicpm_2b", (72, 2048, 64, 0), (160, 80, 80)),
               ("musicgen_large", (64, 2048, 64, 0), (192, 96, 96)),
               ("phi3_vision_4_2b", (64, 2048, 96, 0), (128, 64, 64)),
               ("mamba2_780m", None, (0, 0, 0))]


@pytest.mark.parametrize("arch,shape,launches", PHASE17_NEW)
def test_chip_smoke_phase17_trains_the_model_at_published_depth(
        arch, shape, launches):
    """``TRAIN_MODELS`` trains ``arch`` at its published width and depth,
    4 x 2,048 in 2 microbatches (Mamba-2 through ``ssd_impl="xla"``);
    each step launches the flash kernels as many times as the table
    says (none for Mamba-2, whose ``ssd_scan`` has no gradient); its
    microbatch's flash shape is among ``train_flash_shapes()`` and so
    among phase 14's (and phase 10's) shapes."""
    import chip_smoke

    over, B, S, mb, steps = chip_smoke.TRAIN_MODELS[arch]
    assert "num_layers" not in over and (B, S, mb, steps) == (
        4, 2048, 2, (1, 3, 5))
    cfg, _ = chip_smoke.train_setup(arch, over, mb)
    assert cfg.num_layers == PC.get_config(arch).num_layers
    assert cfg.remat == "block" and cfg.dtype == "bfloat16"
    per_step = chip_smoke.train_launches_per_step(cfg, mb)
    assert tuple(per_step[k] for k in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")) == launches
    if shape is None:
        assert over == {"ssd_impl": "xla"} and cfg.ssd_impl == "xla"
    else:
        assert shape in chip_smoke.train_flash_shapes()
        assert shape in chip_smoke.bwd_shapes()


@pytest.mark.parametrize("arch,kw", [("smollm_360m", {"attn_impl": "naive"}),
                                     ("mamba2_780m", {"ssd_impl": "xla"})])
def test_chip_smoke_phase17_meta_estimate_is_the_steps_live_bytes(arch, kw):
    """Phase 17's estimate of a step's peak (``train_meta_peak``: the step
    on meta tensors under ``LiveBytes``) against the live bytes of the
    same donated step on CPU tensors, a reduced bf16 config in 2
    microbatches: the arguments equal, the peaks within 5% (the CPU's
    embedding backward holds one more temporary than its meta kernel)."""
    from torch.utils import _pytree as pytree

    import chip_smoke
    from repro_torch.launch.dryrun import LiveBytes
    from repro_torch.launch.train import reduced
    from repro_torch.models import transformer as MT
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    cfg = reduced(PC.get_config(arch)).with_(remat="block", **kw)
    opt = OptConfig(lr=1e-3, schedule="constant", warmup_steps=1)
    step = make_train_step(cfg, opt, microbatches=2, donate=True)
    B, S = 4, 32
    est_args, est_peak = chip_smoke.train_meta_peak(torch, cfg, step, B, S)
    params = MT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = {"params": params, "opt": step.init_opt(params), "step": 0}
    del params
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    mem = LiveBytes("cpu")
    args = sum(mem.track(t) for t in pytree.tree_leaves((state, batch)))
    with mem:
        state, m = step(state, batch)
    assert np.isfinite(float(m["loss"])) and state["step"] == 1
    assert est_args == args
    assert 0.95 <= est_peak / mem.peak <= 1.05, (est_peak, mem.peak)


if __name__ == "__main__":
    _rank_main()
