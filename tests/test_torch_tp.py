"""Tensor parallelism in the port's sharded train step (products split
over ``model``) held against the reference's functions and against world
size 1.

Each case runs as gloo ranks (``test_torch_parallel.spawn``: this file
run as a script is one rank) on a ``(data, model)`` mesh: (1, 2) at two
ranks, (1, 4) and (2, 2) at four.  A rank hands the port's modules its
shards of seeded numpy weights (``parallel.sharding.ShardedLeaf``, as the
launcher's step does) and its rows of the batch:

* attention (``layers.attention_seq_kv``, naive and flash, with and
  without QKV biases), whose KV heads split with the q heads where
  ``model`` divides them (2 of 4 heads at 2 ranks) and are cut from the
  whole leaves where it does not (at 4 ranks), and the MLP (gated and
  gelu): the model group's outputs, gathered by batch shard, equal the
  reference's ``attention_seq_kv`` and ``mlp`` on the whole batch within
  ``TOL_REF``, and each weight's gradient, landed in the rank's block,
  equals world size 1's within ``TOL_GRAD``;
* the RG-LRU (``rglru.rglru_seq_cached``) and the SSD mixer
  (``ssm.ssd_seq``, ``ssd_impl`` ``xla`` and ``kernel``, the latter its
  plain version here), their leaves handed over as the stack's
  ``_gather_block`` does: every leaf the reference splits over ``model``
  split, their outputs equal the reference's ``rglru_seq`` / ``ssd_seq``
  within ``TOL_REF`` and (``kernel`` has no backward) each gradient
  world size 1's within ``TOL_GRAD``; an SSD whose ``model`` divides
  ``d_inner`` but not its 3 heads runs whole and equals the same;
* the vocab-parallel ``cross_entropy`` over a rank's block of the
  logits, with IGNORE labels and labels in every block, equals the
  reference's within ``TOL_CE`` relative, its gradient world size 1's;
* one sharded step of a reduced bf16 config: no f32 tensor a rank makes
  has the whole vocabulary along a dimension, and its logits hold V/tp
  entries there.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_parallel as TP  # noqa: E402

TOL_REF = dict(rtol=2e-4, atol=2e-4)   # against the reference's functions
TOL_CE = 1e-6                          # relative, against the reference's
TOL_GRAD = TP.TOL_GRAD                 # relative L2 against world size 1
MESHES = {2: {"1x2": (1, 2)}, 4: {"1x4": (1, 4), "2x2": (2, 2)}}
B, S = 4, 16
# attention: GQA with 2 KV heads of 4 (InternLM2), with QKV biases
# (Qwen1.5); the MLP gated (InternLM2) and gelu (MusicGen)
ATTN = {"gqa": "internlm2_1_8b", "bias": "qwen1_5_4b"}
MLPS = {"gated": "internlm2_1_8b", "gelu": "musicgen_large"}
IMPLS = ("naive", "flash")
# the recurrent blocks: (kind, name) -> (arch, the config's overrides);
# "heads_whole" has 3 SSD heads of 32 over d_inner 96, which 2 and 4 ranks
# divide but not the heads
RECURRENT = {("rglru", "rglru"): ("recurrentgemma_2b", {}),
             ("ssd", "xla"): ("mamba2_780m", {"ssd_impl": "xla"}),
             ("ssd", "kernel"): ("mamba2_780m", {"ssd_impl": "kernel"}),
             ("ssd", "heads_whole"): ("mamba2_780m", {
                 "ssd_impl": "xla", "d_model": 48, "ssm_head_dim": 32})}
CE_V = 64                              # the cross-entropy check's vocabulary
MEM_ARCHS = ("smollm_360m", "qwen3_moe_30b_a3b")   # tied and untied heads


def port_cfg(arch, **kw):
    """The reduced config in f32 (the reference's tests' ``reduced``, as
    the launcher's copy gives it)."""
    from repro_torch import configs as PC
    from repro_torch.launch.train import reduced

    return reduced(PC.get_config(arch)).with_(dtype="float32",
                                              param_dtype="float32", **kw)


def ref_cfg(arch, **kw):
    from repro import configs as RC
    from test_models import reduced

    return reduced(RC.get_config(arch)).with_(dtype="float32",
                                              param_dtype="float32", **kw)


def module_specs(kind, cfg):
    from repro_torch.models import layers as L
    from repro_torch.models import rglru as R
    from repro_torch.models import ssm as SM

    return {"attn": L.attn_specs, "mlp": L.mlp_specs, "rglru": R.rglru_specs,
            "ssd": SM.ssd_specs}[kind](cfg)


def cases():
    """(kind, name, arch, impl) of every module case: ``impl`` attention's
    ``attn_impl``, the SSD's ``ssd_impl``."""
    return ([("attn", n, a, i) for n, a in ATTN.items() for i in IMPLS]
            + [("mlp", n, a, "naive") for n, a in MLPS.items()]
            + [(kind, name, a, kw.get("ssd_impl", "naive"))
               for (kind, name), (a, kw) in RECURRENT.items()])


def case_overrides(kind, name, impl):
    """The config's overrides of a case (see :func:`cases`)."""
    if (kind, name) in RECURRENT:
        return dict(RECURRENT[(kind, name)][1])
    return {"attn_impl": impl}


def case_arch(kind, name):
    return {"attn": ATTN, "mlp": MLPS}[kind][name] if kind in (
        "attn", "mlp") else RECURRENT[(kind, name)][0]


def run_module(kind, p, x, cfg):
    """The port's module ``kind`` on leaves ``p`` (a rank's shards
    handed over as the stack's ``_gather_block`` does for the recurrent
    blocks) -> its output."""
    from repro_torch.models import layers as L
    from repro_torch.models import rglru as R
    from repro_torch.models import ssm as SM
    from repro_torch.models.transformer import _gather_block

    if kind == "attn":
        return L.attention_seq_kv(p, x, cfg)[0]
    if kind == "mlp":
        return L.mlp(p, x, cfg)
    p, tp = _gather_block(p, kind)
    if kind == "rglru":
        return R.rglru_seq_cached(p, x, cfg, tp=tp)[0]
    return SM.ssd_seq(p, x, cfg, tp)


def make_inputs(path):
    """Every case's weights, inputs and output weights, and the
    cross-entropy's logits and labels, from seeds."""
    rng = np.random.default_rng(36)
    inp = {}
    for kind, name, arch, impl in cases():
        cfg = port_cfg(arch, **case_overrides(kind, name, impl))
        for k, (shape, _) in sorted(module_specs(kind, cfg).items()):
            key = f"{kind}/{name}/{k}"
            if key not in inp:
                inp[key] = (rng.standard_normal(shape) * 0.2).astype(
                    np.float32)
    inp["x"] = rng.standard_normal((B, S, 64)).astype(np.float32)
    inp["w_y"] = rng.standard_normal((B, S, 64)).astype(np.float32)
    inp["logits"] = (rng.standard_normal((B, S, CE_V)) * 3).astype(np.float32)
    labels = rng.integers(0, CE_V, (B, S))
    labels[0, :CE_V // S] = np.arange(0, CE_V, S)      # one in every block
    labels[1, ::3] = -100                              # IGNORE
    inp["labels"] = labels.astype(np.int64)
    np.savez(path, **inp)
    return inp


# ---------------------------------------------------------------------------
# a rank


def _leaves(specs, weights, mesh, ops):
    """Each weight as this rank's ``ShardedLeaf`` of it, its block
    requiring grad."""
    from repro_torch.parallel import sharding as SH

    out = {}
    for k, (shape, axes) in specs.items():
        sh = SH.logical_sharding(axes, mesh, shape=shape)
        w = torch.from_numpy(weights[k])
        local = w[sh.local_slices(w.shape, mesh.get_coordinate())].clone()
        out[k] = SH.ShardedLeaf(local.requires_grad_(True), sh, ops, key=k)
    return out


def _module_check(kind, name, arch, impl, mesh, inp):
    from repro_torch.launch import train as LT
    from repro_torch.models import rglru as R
    from repro_torch.models import ssm as SM
    from repro_torch.parallel import sharding as SH

    cfg = port_cfg(arch, **case_overrides(kind, name, impl))
    specs = module_specs(kind, cfg)
    ops = SH.MeshOps(mesh)
    weights = {k: inp[f"{kind}/{name}/{k}"] for k in specs}
    D = cfg.d_model
    with SH.sharding_context(mesh):
        idx, n = LT.batch_shard(mesh)
        rows = slice(idx * B // n, (idx + 1) * B // n)
        p = _leaves(specs, weights, mesh, ops)
        tp = {k: SH.tp_group(v) is not None for k, v in p.items()}
        split = {"rglru": R, "ssd": SM}.get(kind)
        if split is not None:
            tp["block"] = split.tp_split(p) is not None
        x = torch.from_numpy(inp["x"][rows, :, :D]).clone().requires_grad_(
            impl != "kernel")
        with torch.set_grad_enabled(impl != "kernel"):
            y = run_module(kind, p, x, cfg)
        if impl == "kernel":        # ssd_scan has no backward
            grads = [None] * (len(p) + 1)
        else:
            loss = (y * torch.from_numpy(inp["w_y"][rows, :, :D])).sum()
            grads = torch.autograd.grad(loss, [v.local for v in p.values()]
                                        + [x])
    return {"idx": idx, "n": n, "y": y.detach(), "dx": grads[-1], "tp": tp,
            "slices": {k: v.sharding.local_slices(weights[k].shape,
                                                  mesh.get_coordinate())
                       for k, v in p.items()},
            "grads": dict(zip(p, grads[:-1]))}


def _ce_check(mesh, inp):
    """The vocab-parallel cross-entropy over this rank's block of the
    logits, and its gradient there."""
    from repro_torch.launch import train as LT
    from repro_torch.parallel import sharding as SH
    from repro_torch.train.step import cross_entropy

    ops = SH.MeshOps(mesh)
    tp = SH.TPGroup(ops, mesh.shape[1], mesh.get_local_rank("model"))
    with SH.sharding_context(mesh):
        idx, n = LT.batch_shard(mesh)
    rows = slice(idx * B // n, (idx + 1) * B // n)
    start, w = tp.block(CE_V)
    logits = torch.from_numpy(inp["logits"][rows, :, start:start + w]) \
        .clone().requires_grad_(True)
    loss, ce = cross_entropy(logits, torch.from_numpy(inp["labels"][rows]),
                             vocab=tp)
    g, = torch.autograd.grad(loss, [logits])
    return {"idx": idx, "n": n, "loss": loss.detach(), "ce": ce.detach(),
            "start": start, "grad": g}


def _vocab_check(arch, shape, inp):
    """One sharded step of the reduced bf16 ``arch`` under a dispatch mode
    recording the shape of every f32 tensor an operator returns (not the
    ``meta`` ones that placing a DTensor makes for its strides)."""
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import configs as PC
    from repro_torch.launch import train as LT
    from repro_torch.parallel import sharding as SH
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step, train_state_specs

    class F32Shapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in pytree.tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                        and t.device.type != "meta"):
                    self.shapes.add(tuple(t.shape))
            return out

    cfg = LT.reduced(PC.get_config(arch))
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt, donate=True)
    mesh = SH.make_mesh(shape, ("data", "model"), device="cpu")
    shapes, axes = train_state_specs(cfg, opt)
    state_sh = SH.tree_shardings(axes, shapes, mesh)
    state = LT.place(LT.init_state(cfg, step, "cpu"), state_sh)
    with SH.sharding_context(mesh):
        jstep = LT.make_sharded_step(step, mesh, state_sh)
        idx, n = LT.batch_shard(mesh)
    batch = TP.local_rows(TP.grad_batch(inp, 0), idx, n)
    mode = F32Shapes()
    with mode:
        _, m = jstep(state, batch)
    return {"shapes": sorted(mode.shapes), "loss": float(m["loss"]),
            "vocab": cfg.vocab_size, "rows": batch["tokens"].shape}


def _rank_checks(world, rank, out, inp, tp_inp):
    from repro_torch.parallel import sharding as SH

    res = {"rank": rank}
    for mname, shape in MESHES[world].items():
        mesh = SH.make_mesh(shape, ("data", "model"), device="cpu")
        for kind, name, arch, impl in cases():
            res[f"{mname}/{kind}/{name}/{impl}"] = _module_check(
                kind, name, arch, impl, mesh, tp_inp)
        res[f"{mname}/ce"] = _ce_check(mesh, tp_inp)
        for arch in MEM_ARCHS:
            res[f"{mname}/vocab/{arch}"] = _vocab_check(arch, shape, inp)
    torch.save(res, out / f"rank{rank}.pt")


def _rank_main(argv=None):
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    for a in ("--world", "--rank"):
        ap.add_argument(a, type=int)
    for a in ("--store", "--out", "--inputs", "--tp-inputs"):
        ap.add_argument(a)
    a = ap.parse_args(argv)
    TP.init_rank_group(a.world, a.rank, a.store)
    try:
        _rank_checks(a.world, a.rank, pathlib.Path(a.out),
                     dict(np.load(a.inputs)), dict(np.load(a.tp_inputs)))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{n: [the port's results by rank]} at 2 and 4 ranks, and the
    inputs."""
    root = tmp_path_factory.mktemp("tp")
    inputs, tp_inputs = root / "inputs.npz", root / "tp_inputs.npz"
    inp = TP.make_inputs(inputs)
    tp_inp = make_inputs(tp_inputs)
    out = {n: TP.spawn(n, pathlib.Path(__file__), root / f"port{n}",
                       "--inputs", inputs, "--tp-inputs", tp_inputs)
           for n in (2, 4)}
    return {"inp": inp, "tp_inp": tp_inp, **out}


def mesh_cases():
    return [(n, m) for n in (2, 4) for m in MESHES[n]]


def _by_shard(port, key, field):
    """The ranks' ``field`` assembled by batch shard; ranks sharing a shard
    (the ``model`` group) must agree exactly."""
    shards = {}
    for r in port:
        e = r[key]
        if e["idx"] in shards:
            assert torch.equal(shards[e["idx"]], e[field]), key
        shards[e["idx"]] = e[field]
    return torch.cat([shards[i] for i in range(port[0][key]["n"])])


def _whole_grad(port, key, k, shape):
    """A weight's gradient assembled from the ranks' blocks (ranks holding
    one block agree within float rounding of their sums)."""
    g = torch.full(shape, float("nan"))
    for r in port:
        e = r[key]
        g[e["slices"][k]] = e["grads"][k]
    assert not torch.isnan(g).any(), (key, k)
    return g


def _reference_module(kind, name, arch, weights, x):
    """The reference's module on the whole batch: attention naive, the
    SSD through its ``xla`` form (the port's ``kernel`` case is held
    against it)."""
    import jax.numpy as jnp

    from repro.models import layers as RL
    from repro.models import rglru as RR
    from repro.models import ssm as RS

    kw = case_overrides(kind, name, "naive")
    if "ssd_impl" in kw:
        kw["ssd_impl"] = "xla"
    cfg = ref_cfg(arch, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        port_cfg(arch, **kw)), arch
    p = {k: jnp.asarray(v) for k, v in weights.items()}
    x = jnp.asarray(x[..., :cfg.d_model])
    if kind == "attn":
        y, _ = RL.attention_seq_kv(p, x, cfg)
    else:
        y = {"mlp": RL.mlp, "rglru": RR.rglru_seq, "ssd": RS.ssd_seq}[kind](
            p, x, cfg)
    return np.asarray(y)


@pytest.mark.parametrize("n,mesh,kind,name,impl", [
    (n, m, kind, name, impl) for n, m in mesh_cases()
    for kind, name, _, impl in cases()])
def test_tp_module_equals_reference(runs, n, mesh, kind, name, impl):
    """The model group's outputs, gathered by batch shard, equal the
    reference's module on the whole batch within ``TOL_REF``; attention's
    q heads (and the MLP's hidden units) split over ``model`` on every
    mesh, its KV heads split at 2 model ranks and cut at 4; the RG-LRU's
    and the SSD's own leaves split and the block runs split, but the
    SSD's B, C and norm scale, which stay whole, and an SSD whose heads
    ``model`` does not divide, which runs whole."""
    from repro_torch.models import rglru as R
    from repro_torch.models import ssm as SM

    arch = case_arch(kind, name)
    port = runs[n]
    key = f"{mesh}/{kind}/{name}/{impl}"
    tp = port[0][key]["tp"]
    if kind == "attn":
        assert tp["wq"] and tp["wo"]
        assert tp["wk"] == (MESHES[n][mesh][1] == 2)
        assert ("wq_b" in tp) == (name == "bias")
        assert all(v for k, v in tp.items() if k in ("wq_b", "wo"))
    elif kind == "mlp":
        assert tp["w_up"] and tp["w_down"]
    else:
        own = (R if kind == "rglru" else SM).TP_WEIGHTS
        heads = ("wdt", "A_log", "D_skip", "dt_bias")
        whole = name == "heads_whole"
        assert {k for k, v in tp.items() if v and k != "block"} == (
            set(own) - set(heads) if whole else set(own)), tp
        assert tp["block"] == (not whole)
    inp = runs["tp_inp"]
    specs = module_specs(kind, port_cfg(arch, **case_overrides(kind, name,
                                                               impl)))
    weights = {k: inp[f"{kind}/{name}/{k}"] for k in specs}
    y = _by_shard(port, key, "y")
    np.testing.assert_allclose(y.numpy(), _reference_module(
        kind, name, arch, weights, inp["x"]), **TOL_REF)


@pytest.mark.parametrize("n,mesh,kind,name,impl", [
    (n, m, kind, name, impl) for n, m in mesh_cases()
    for kind, name, _, impl in cases() if impl != "kernel"])
def test_tp_module_gradients_equal_world_size_1(runs, n, mesh, kind, name,
                                                impl):
    """Each weight's gradient of sum(y · w) landed in the ranks' blocks
    (the gather's backward: the sum over the ranks holding the block,
    divided by the rank count) equals world size 1's gradient of the mean
    over the batch shards within ``TOL_GRAD``, and x's gradient summed
    over the model group, divided by its size, world size 1's."""
    arch = case_arch(kind, name)
    port = runs[n]
    key = f"{mesh}/{kind}/{name}/{impl}"
    cfg = port_cfg(arch, **case_overrides(kind, name, impl))
    inp = runs["tp_inp"]
    specs = module_specs(kind, cfg)
    p = {k: torch.from_numpy(inp[f"{kind}/{name}/{k}"]).requires_grad_(True)
         for k in specs}
    D = cfg.d_model
    x = torch.from_numpy(inp["x"][..., :D]).clone().requires_grad_(True)
    y = run_module(kind, p, x, cfg)
    shards = port[0][key]["n"]
    loss = (y * torch.from_numpy(inp["w_y"][..., :D])).sum() / shards
    *grads, dx = torch.autograd.grad(loss, [*p.values(), x])
    for k, g in zip(p, grads):
        got = _whole_grad(port, key, k, g.shape)
        assert TP.rel_l2(got, g) < TOL_GRAD, (k, TP.rel_l2(got, g))
    dx = dx * shards
    tp = n // shards
    got = {}
    for r in port:
        e = r[key]
        got[e["idx"]] = got.get(e["idx"], 0) + e["dx"] / tp
    got = torch.cat([got[i] for i in range(shards)])
    assert TP.rel_l2(got, dx) < TOL_GRAD, TP.rel_l2(got, dx)


@pytest.mark.parametrize("n,mesh", mesh_cases())
def test_vocab_parallel_cross_entropy_equals_reference(runs, n, mesh):
    """The vocab-parallel cross-entropy (each rank one block of the
    logits' vocabulary: block max over the group, sums of exp and of the
    label's logit over it) equals the reference's ``cross_entropy`` on the
    whole logits within ``TOL_CE`` relative, with IGNORE labels and
    labels in every block; the gradient in each rank's block, divided by
    the group's size, equals world size 1's within ``TOL_GRAD``."""
    import jax.numpy as jnp

    from repro.train.step import cross_entropy as ref_ce
    from repro_torch.train.step import cross_entropy

    port = runs[n]
    inp = runs["tp_inp"]
    labels = inp["labels"]
    tp = MESHES[n][mesh][1]
    w = CE_V // tp
    assert {int(v) // w for v in labels.reshape(-1) if v >= 0} == set(
        range(tp))
    assert (labels == -100).any()
    shards = port[0][f"{mesh}/ce"]["n"]
    rows = B // shards
    for r in port:
        e = r[f"{mesh}/ce"]
        sl = slice(e["idx"] * rows, (e["idx"] + 1) * rows)
        want, want_ce = ref_ce(jnp.asarray(inp["logits"][sl]),
                               jnp.asarray(labels[sl].astype(np.int32)))
        for got, ref in ((e["loss"], want), (e["ce"], want_ce)):
            assert abs(float(got) - float(ref)) <= TOL_CE * abs(float(ref)), \
                (float(got), float(ref))
        logits = torch.from_numpy(inp["logits"][sl]).requires_grad_(True)
        g, = torch.autograd.grad(cross_entropy(
            logits, torch.from_numpy(labels[sl]))[0], [logits])
        block = g[..., e["start"]:e["start"] + w]
        assert TP.rel_l2(e["grad"] / tp, block) < TOL_GRAD


@pytest.mark.parametrize("n,mesh,arch", [(n, m, a) for n, m in mesh_cases()
                                         for a in MEM_ARCHS])
def test_no_rank_holds_f32_over_the_whole_vocabulary(runs, n, mesh, arch):
    """Over one sharded step of the reduced bf16 config (its head tied for
    SmolLM, ``lm_head`` for Qwen3), no f32 tensor a rank makes has the
    whole vocabulary along any dimension, and its logits [rows, S, V/tp]
    are among them: the head projects to the rank's block."""
    port = runs[n]
    tp = MESHES[n][mesh][1]
    for r in port:
        e = r[f"{mesh}/vocab/{arch}"]
        V = e["vocab"]
        assert not [s for s in e["shapes"] if V in s], e["shapes"]
        assert (*e["rows"], V // tp) in e["shapes"]
        assert np.isfinite(e["loss"])


if __name__ == "__main__":
    _rank_main()
