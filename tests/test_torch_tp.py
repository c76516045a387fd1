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
  whole leaves where it does not (at 4 ranks); its q heads in padded
  tiles where ``model`` does not divide them (3 heads: 2 + 1 at 2 ranks,
  1, 1, 1 and an empty tile at 4; 6 heads of 2 KV heads: 2, 2, 2, 0),
  and the MLP (gated and gelu): the model group's outputs, gathered by
  batch shard, equal the
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
* the vocab-parallel ``cross_entropy`` over a rank's padded tile of the
  logits (64 words; 61 in tiles of 31 + 30 and 16, 16, 16, 13; 9 in 5 +
  4 and 3, 3, 3, 0), with IGNORE labels and labels in every non-empty
  tile, equals the reference's within ``TOL_CE`` relative, its gradient
  world size 1's;
* one sharded step of a reduced bf16 config (a MiniCPM-2B at 3 heads and
  511 words among them): no f32 tensor a rank makes has the whole
  vocabulary along a dimension but a replicated leaf's own, and its
  logits hold the rank's tile;
* one sharded step of that MiniCPM-2B in f32 equals world size 1's step
  within ``TP.TOL_GRAD``;
* ``TPGroup.gather`` assembles padded tiles (9 and 61 over 2 and 4
  ranks) whole, its backward each rank's tile of the summed cotangents.
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
# attention: name -> (arch, the config's overrides): GQA with 2 KV heads
# of 4 (InternLM2), with QKV biases (Qwen1.5); 3 heads, which 2 and 4
# ranks tile padded (2 + 1; 1, 1, 1 and an empty tile), without biases
# (MiniCPM) and with them; 6 heads of 2 KV heads (2, 2, 2, 0 at 4 ranks)
ATTN = {"gqa": ("internlm2_1_8b", {}), "bias": ("qwen1_5_4b", {}),
        "heads3": ("minicpm_2b", {"num_heads": 3, "num_kv_heads": 3}),
        "heads3_bias": ("qwen1_5_4b", {"num_heads": 3, "num_kv_heads": 3}),
        "gqa6": ("internlm2_1_8b", {"num_heads": 6, "num_kv_heads": 2})}
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
# the cross-entropy checks' vocabularies: 64 splits evenly; 61 in tiles
# of 31 + 30 and 16, 16, 16, 13; 9 in 5 + 4 and 3, 3, 3, 0
CE_VS = (64, 61, 9)
# the vocabulary checks' configs: tied and untied heads, and a reduced
# MiniCPM-2B whose 3 heads and 511 words 2 and 4 ranks tile padded
MINICPM = {"num_heads": 3, "num_kv_heads": 3, "vocab_size": 511}
MEM_ARCHS = {"smollm_360m": {}, "qwen3_moe_30b_a3b": {},
             "minicpm_2b": MINICPM}


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
    return ([("attn", n, a, i) for n, (a, _) in ATTN.items() for i in IMPLS]
            + [("mlp", n, a, "naive") for n, a in MLPS.items()]
            + [(kind, name, a, kw.get("ssd_impl", "naive"))
               for (kind, name), (a, kw) in RECURRENT.items()])


def case_overrides(kind, name, impl):
    """The config's overrides of a case (see :func:`cases`)."""
    if (kind, name) in RECURRENT:
        return dict(RECURRENT[(kind, name)][1])
    return {"attn_impl": impl, **(ATTN[name][1] if kind == "attn" else {})}


def case_arch(kind, name):
    if kind == "attn":
        return ATTN[name][0]
    return MLPS[name] if kind == "mlp" else RECURRENT[(kind, name)][0]


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
    from repro_torch.parallel import sharding as SH

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
    inp["logits"] = (rng.standard_normal((B, S, max(CE_VS))) * 3).astype(
        np.float32)
    for V in CE_VS:
        labels = rng.integers(0, V, (B, S))
        starts = sorted({SH.tile(V, n, r)[0] for n in (2, 4)
                         for r in range(n) if SH.tile(V, n, r)[1]})
        labels[0, :len(starts)] = starts         # one in every tile
        labels[1, ::3] = -100                    # IGNORE
        inp[f"labels{V}"] = labels.astype(np.int64)
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
    from repro_torch.models import layers as L
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
        tp = {k: (SH.tile_group(v, "heads") if k in L.HEAD_DIMS
                  else SH.tp_group(v)) is not None for k, v in p.items()}
        if kind == "attn":
            tp["heads"] = SH.tile_group(p["wq"], "heads").block(
                cfg.num_heads)[1]
        split = {"rglru": R, "ssd": SM}.get(kind)
        if split is not None:
            tp["block"] = split.tp_split(p) is not None
        x = torch.from_numpy(inp["x"][rows, :, :D]).clone().requires_grad_(
            impl != "kernel")
        launched = []
        flash = L.flash_attention

        def counted(q, *a, **kw):
            launched.append(q.shape[0])
            return flash(q, *a, **kw)

        L.flash_attention = counted
        try:
            with torch.set_grad_enabled(impl != "kernel"):
                y = run_module(kind, p, x, cfg)
        finally:
            L.flash_attention = flash
        tp["flash_bh"] = launched
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


def _ce_check(mesh, inp, V):
    """The vocab-parallel cross-entropy over this rank's padded tile of
    the first ``V`` columns of the logits, and its gradient there."""
    from repro_torch.launch import train as LT
    from repro_torch.parallel import sharding as SH
    from repro_torch.train.step import cross_entropy

    ops = SH.MeshOps(mesh)
    tp = SH.TPGroup(ops, mesh.shape[1], mesh.get_local_rank("model"))
    with SH.sharding_context(mesh):
        idx, n = LT.batch_shard(mesh)
    rows = slice(idx * B // n, (idx + 1) * B // n)
    start, w = tp.block(V)
    logits = torch.from_numpy(inp["logits"][rows, :, start:start + w]) \
        .clone().requires_grad_(True)
    loss, ce = cross_entropy(logits,
                             torch.from_numpy(inp[f"labels{V}"][rows]),
                             vocab=tp, vocab_size=V)
    g, = torch.autograd.grad(loss, [logits])
    return {"idx": idx, "n": n, "loss": loss.detach(), "ce": ce.detach(),
            "start": start, "grad": g}


def _vocab_check(arch, shape, inp):
    """One sharded step of the reduced bf16 ``arch`` (with
    ``MEM_ARCHS[arch]``) under a dispatch mode recording the shape of
    every f32 tensor an operator returns (not the ``meta`` ones that
    placing a DTensor makes for its strides)."""
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

    cfg = LT.reduced(PC.get_config(arch)).with_(**MEM_ARCHS[arch])
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt, donate=True)
    mesh = SH.make_mesh(shape, ("data", "model"), device="cpu")
    shapes, axes = train_state_specs(cfg, opt)
    state_sh = SH.tree_shardings(axes, shapes, mesh)
    state = LT.place(LT.init_state(cfg, step, "cpu"), state_sh)
    with SH.sharding_context(mesh):
        jstep = LT.make_sharded_step(step, mesh, state_sh)
        idx, n = LT.batch_shard(mesh)
    batch = TP.local_rows(step_batch(inp, cfg), idx, n)
    mode = F32Shapes()
    with mode:
        _, m = jstep(state, batch)
    return {"shapes": sorted(mode.shapes), "loss": float(m["loss"]),
            "vocab": cfg.vocab_size, "d_model": cfg.d_model,
            "rows": batch["tokens"].shape,
            "tile": SH.tile(cfg.vocab_size, shape[1],
                            mesh.get_local_rank("model"))[1]}


def step_batch(inp, cfg, i=0):
    """``test_torch_parallel``'s batch ``i``, its tokens below the
    config's vocabulary."""
    return {k: v % cfg.vocab_size for k, v in TP.grad_batch(inp, i).items()}


def _gather_check(mesh, V):
    """``TPGroup.gather`` of the rank's padded tile of ``arange(V)`` and
    the gradient of ``(gathered * weights).sum()`` in its tile; and
    whether a tile of the wrong width is refused."""
    from repro_torch.parallel import sharding as SH

    tp = SH.TPGroup(SH.MeshOps(mesh), mesh.shape[1],
                    mesh.get_local_rank("model"))
    start, w = tp.block(V)
    x = torch.arange(start, start + w, dtype=torch.float32)[None]
    x.requires_grad_(True)
    y = tp.gather(x, -1, V)
    weights = torch.linspace(-1.0, 1.0, V)[None]
    g, = torch.autograd.grad((y * weights).sum(), [x])
    try:
        tp.gather(torch.zeros(1, w + 1), -1, V)
        refused = False
    except ValueError:
        refused = True
    return {"y": y.detach(), "grad": g, "start": start, "refused": refused}


def _step_check(shape, inp):
    """One sharded step of the reduced MiniCPM-2B of ``MEM_ARCHS`` in f32
    (3 heads and 511 words, which the mesh's ``model`` tiles padded):
    its loss and the whole state after it."""
    from repro_torch.launch import train as LT
    from repro_torch.parallel import sharding as SH
    from repro_torch.train.step import make_train_step, train_state_specs

    cfg, opt = step_setup()
    step = make_train_step(cfg, opt, donate=True)
    mesh = SH.make_mesh(shape, ("data", "model"), device="cpu")
    shapes, axes = train_state_specs(cfg, opt)
    state_sh = SH.tree_shardings(axes, shapes, mesh)
    state = LT.place(LT.init_state(cfg, step, "cpu"), state_sh)
    with SH.sharding_context(mesh):
        jstep = LT.make_sharded_step(step, mesh, state_sh)
        idx, n = LT.batch_shard(mesh)
    state, m = jstep(state, TP.local_rows(step_batch(inp, cfg), idx, n))
    return {"loss": float(m["loss"]), "step": state["step"],
            "state": TP.state_wholes(state)}


def step_setup():
    """The sharded step check's config (f32) and optimizer."""
    from repro_torch import configs as PC
    from repro_torch.launch import train as LT
    from repro_torch.train.optim import OptConfig

    cfg = LT.reduced(PC.get_config("minicpm_2b")).with_(
        dtype="float32", param_dtype="float32", **MINICPM)
    return cfg, OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)


def _rank_checks(world, rank, out, inp, tp_inp):
    from repro_torch.parallel import sharding as SH

    res = {"rank": rank}
    for mname, shape in MESHES[world].items():
        mesh = SH.make_mesh(shape, ("data", "model"), device="cpu")
        for kind, name, arch, impl in cases():
            res[f"{mname}/{kind}/{name}/{impl}"] = _module_check(
                kind, name, arch, impl, mesh, tp_inp)
        for V in CE_VS:
            res[f"{mname}/ce/{V}"] = _ce_check(mesh, tp_inp, V)
            res[f"{mname}/gather/{V}"] = _gather_check(mesh, V)
        for arch in MEM_ARCHS:
            res[f"{mname}/vocab/{arch}"] = _vocab_check(arch, shape, inp)
        res[f"{mname}/step"] = _step_check(shape, inp)
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
    mesh, in padded tiles where it does not divide them (3 heads: 2 + 1
    at 2 ranks, 1, 1, 1 and an empty tile at 4; 6: 2, 2, 2, 0), its KV
    heads split where ``model`` divides them too and cut from the whole
    leaves elsewhere, flash launched once at the rank's rows times its
    heads and never on an empty tile; the RG-LRU's and the SSD's own
    leaves split and the
    block runs split, but the SSD's B, C and norm scale, which stay
    whole, and an SSD whose heads ``model`` does not divide, which runs
    whole."""
    from repro_torch.models import rglru as R
    from repro_torch.models import ssm as SM
    from repro_torch.parallel import sharding as SH

    arch = case_arch(kind, name)
    port = runs[n]
    key = f"{mesh}/{kind}/{name}/{impl}"
    tp = port[0][key]["tp"]
    model = MESHES[n][mesh][1]
    if kind == "attn":
        cfg = port_cfg(arch, **case_overrides(kind, name, impl))
        H, Kv = cfg.num_heads, cfg.num_kv_heads
        assert tp["wq"] and tp["wo"]
        assert tp["wk"] == (Kv % model == 0)
        assert ("wq_b" in tp) == cfg.qkv_bias
        assert all(v for k, v in tp.items() if k in ("wq_b", "wo"))
        tiles = {r["rank"] % model: r[key]["tp"]["heads"] for r in port}
        assert [tiles[i] for i in range(model)] == [
            SH.tile(H, model, i)[1] for i in range(model)]
        assert max(tiles.values()) < H
        # flash launched at the rank's rows x its heads, never on none
        for r in port:
            e = r[key]
            want = [B // e["n"] * e["tp"]["heads"]] if impl == "flash" \
                and e["tp"]["heads"] else []
            assert e["tp"]["flash_bh"] == want, (r["rank"], e["tp"])
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


@pytest.mark.parametrize("n,mesh,V", [(n, m, V) for n, m in mesh_cases()
                                      for V in CE_VS])
def test_vocab_parallel_cross_entropy_equals_reference(runs, n, mesh, V):
    """The vocab-parallel cross-entropy (each rank one padded tile of the
    logits' vocabulary: tile max over the group, sums of exp and of the
    label's logit over it; trailing tiles short, or empty at 9 words over
    4 ranks) equals the reference's ``cross_entropy`` on the whole logits
    within ``TOL_CE`` relative, with IGNORE labels and labels in every
    non-empty tile; the gradient in each rank's tile, divided by the
    group's size, equals world size 1's within ``TOL_GRAD``."""
    import jax.numpy as jnp

    from repro.train.step import cross_entropy as ref_ce
    from repro_torch.parallel import sharding as SH
    from repro_torch.train.step import cross_entropy

    port = runs[n]
    inp = runs["tp_inp"]
    labels = inp[f"labels{V}"]
    logits_v = inp["logits"][..., :V]
    tp = MESHES[n][mesh][1]
    tiles = [SH.tile(V, tp, i) for i in range(tp)]
    got_tiles = {i for i, (s0, w) in enumerate(tiles) for v in
                 labels.reshape(-1) if s0 <= v < s0 + w}
    assert got_tiles == {i for i, (_, w) in enumerate(tiles) if w}
    assert (labels == -100).any()
    shards = port[0][f"{mesh}/ce/{V}"]["n"]
    rows = B // shards
    for r in port:
        e = r[f"{mesh}/ce/{V}"]
        sl = slice(e["idx"] * rows, (e["idx"] + 1) * rows)
        want, want_ce = ref_ce(jnp.asarray(logits_v[sl]),
                               jnp.asarray(labels[sl].astype(np.int32)))
        for got, ref in ((e["loss"], want), (e["ce"], want_ce)):
            assert abs(float(got) - float(ref)) <= TOL_CE * abs(float(ref)), \
                (float(got), float(ref))
        logits = torch.from_numpy(logits_v[sl].copy()).requires_grad_(True)
        g, = torch.autograd.grad(cross_entropy(
            logits, torch.from_numpy(labels[sl]))[0], [logits])
        block = g[..., e["start"]:e["start"] + e["grad"].shape[-1]]
        assert e["grad"].shape == block.shape
        if block.numel():
            assert TP.rel_l2(e["grad"] / tp, block) < TOL_GRAD


@pytest.mark.parametrize("n,mesh,V", [(n, m, V) for n, m in mesh_cases()
                                      for V in CE_VS])
def test_tile_gather_assembles_padded_tiles(runs, n, mesh, V):
    """``TPGroup.gather`` of the ranks' padded tiles of a dimension of
    ``V`` (short and empty ones included) is the whole dimension, the
    padding cut; its backward gives each rank the sum of the group's
    cotangents in its tile; a tile of another width is refused."""
    model = MESHES[n][mesh][1]
    weights = torch.linspace(-1.0, 1.0, V)
    for r in runs[n]:
        e = r[f"{mesh}/gather/{V}"]
        assert torch.equal(e["y"][0], torch.arange(V, dtype=torch.float32))
        w = e["grad"].shape[-1]
        torch.testing.assert_close(
            e["grad"][0], model * weights[e["start"]:e["start"] + w])
        assert e["refused"]


@pytest.mark.parametrize("n,mesh,arch", [(n, m, a) for n, m in mesh_cases()
                                         for a in MEM_ARCHS])
def test_no_rank_holds_f32_over_the_whole_vocabulary(runs, n, mesh, arch):
    """Over one sharded step of the reduced bf16 config (its head tied for
    SmolLM and MiniCPM, ``lm_head`` for Qwen3), no f32 tensor a rank
    makes has the whole vocabulary along any dimension, and its logits
    [rows, S, tile] are among them: the head projects to the rank's
    tile, padded where ``model`` does not divide MiniCPM's 511 words.
    There the stored leaf keeps the whole vocabulary (its spec drops
    ``model``, as the reference's does, and splits ``D`` over ``data``),
    and only the rank's block of it [V, D/data] does: the optimizer's
    moments and update of it."""
    port = runs[n]
    data, model = MESHES[n][mesh]
    for r in port:
        e = r[f"{mesh}/vocab/{arch}"]
        V = e["vocab"]
        leaf = (V, e["d_model"] // data) if V % model else None
        assert not [s for s in e["shapes"] if V in s and s != leaf], \
            e["shapes"]
        assert e["tile"] < V
        assert (*e["rows"], e["tile"]) in e["shapes"]
        assert np.isfinite(e["loss"])


@pytest.mark.parametrize("n,mesh", mesh_cases())
def test_sharded_step_with_padded_tiles_equals_world_size_1(runs, n, mesh):
    """One sharded step of the reduced MiniCPM-2B in f32 at 3 heads and
    511 words, which ``model`` tiles padded over 2 and 4 ranks (empty
    tiles of the heads at 4): the loss, the parameters and the moments
    equal one world-size-1 step within ``TP.TOL_GRAD`` (1e-5) relative
    L2."""
    from repro_torch.launch import train as LT
    from repro_torch.train.step import make_train_step

    cfg, opt = step_setup()
    step = make_train_step(cfg, opt)
    state, m = step(LT.init_state(cfg, step, "cpu"),
                    step_batch(runs["inp"], cfg))
    loss = float(m["loss"])
    want = TP.state_wholes(state)
    assert any(k.startswith("opt.") for k in want)
    for r in runs[n]:
        got = r[f"{mesh}/step"]
        assert got["step"] == 1
        assert abs(got["loss"] - loss) <= TP.TOL_GRAD * abs(loss)
        assert got["state"].keys() == want.keys()
        for k, v in want.items():
            err = TP.rel_l2(got["state"][k], v)
            assert err < TP.TOL_GRAD, (k, err)


if __name__ == "__main__":
    _rank_main()
