"""The port's parallelism layer (``repro_torch.parallel``, the MoE's
expert-parallel paths, the sharded restore) held against the reference.

Specs are compared in this process on abstract meshes.  Multi-rank
behaviour runs in subprocesses: the reference's ``shard_map`` programs in
one process per device count (``XLA_FLAGS`` forcing n host devices, as
``tests/test_system.py`` does), the port's ranks as gloo processes over a
``FileStore`` under the test's temporary directory, each group with a
timeout and each spawn with its own time limit.  One spawn per world size
(2 and 4) runs every multi-rank check; the tests read its results.  Both
sides read the same inputs, drawn from seeds with numpy.

Run as a script, this file is one rank of such a spawn.
"""

from __future__ import annotations

import argparse
import datetime
import filecmp
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as PC

REPO = pathlib.Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 240          # each spawn's own time limit
GROUP_TIMEOUT_S = 60           # each process group's collective timeout
TOL_EP = dict(rtol=2e-4, atol=2e-4)    # tests/test_system.py's MoE tolerance
TOL_GRAD = 1e-5                        # relative L2 against world size 1
SAVE_BUDGET = 4096      # a 4-rank save's budget, under a row of every rank

# the reference MoE test's config (tests/test_system.py:77-81)
MOE_KW = dict(name="m", family="moe", num_layers=2, d_model=32, num_heads=2,
              num_kv_heads=2, d_ff=64, vocab_size=64,
              block_pattern=("attn_moe",), num_experts=4,
              experts_per_token=2, moe_d_ff=16, capacity_factor=8.0,
              dtype="float32", param_dtype="float32")
CF_PUBLISHED = 1.25                    # Qwen3-30B-A3B's, where copies drop

# the EP forward cases: name -> (mesh (data, model), config overrides,
# rules overrides, input, positions kept)
EP_CASES = {
    2: {
        "a2a": ((1, 2), {}, {}, "x", None),
        "psum": ((1, 2), {}, {}, "x", 1),
        "seq_shard": ((1, 2), {"moe_seq_shard": True}, {}, "x", None),
        "dp_over_model": ((1, 2), {}, {"batch": ("data", "model")}, "x",
                          None),
        "drop": ((1, 2), {"capacity_factor": CF_PUBLISHED}, {}, "x_drop",
                 None),
        "ties_drop": ((1, 2), {"capacity_factor": CF_PUBLISHED}, {}, "x",
                      None),
    },
    4: {
        "a2a": ((1, 4), {}, {}, "x", None),
        "psum": ((1, 4), {}, {}, "x", 1),
        "seq_shard": ((1, 4), {"moe_seq_shard": True}, {}, "x", None),
        "dp_over_model": ((1, 4), {}, {"batch": ("data", "model")}, "x",
                          None),
        "drop": ((1, 4), {"capacity_factor": CF_PUBLISHED}, {}, "x_drop",
                 None),
        "a2a_2x2": ((2, 2), {}, {}, "x", None),
        "resident": ((2, 2), {"moe_expert_resident": True}, {}, "x", None),
        "resident_psum": ((2, 2), {"moe_expert_resident": True}, {}, "x", 1),
        "resident_drop": ((2, 2), {"moe_expert_resident": True,
                                   "capacity_factor": CF_PUBLISHED}, {},
                          "x_drop", None),
        "ties_drop": ((1, 4), {"capacity_factor": CF_PUBLISHED}, {}, "x",
                      None),
    },
}

# gradient meshes: name -> (mesh (data, model), config overrides)
GRAD_MESHES = {
    2: {"data": ((2, 1), {}), "model": ((1, 2), {})},
    4: {"data": ((4, 1), {}), "model": ((1, 4), {}),
        "resident": ((2, 2), {"moe_expert_resident": True}),
        "2x2": ((2, 2), {})},
}
GRAD_ARCHS = ("qwen3_moe_30b_a3b", "smollm_360m")
GRAD_B, GRAD_S = 4, 16
# dp_fsdp's rules (the dry run's ``apply_policy``): the batch over every
# axis, no product split over model
DP_FSDP = dict(batch=("pod", "data", "model"), heads=(), kv_heads=(),
               ffn=(), vocab=(), act_heads=(), act_ffn=(), act_vocab=())
SPLIT_ARCHS = GRAD_ARCHS + ("recurrentgemma_2b",)
# the sharded steps' options: name -> (optimizer, microbatches, remat,
# rules overrides, meshes); "" is the launcher's default.  Every option
# runs on every mesh; "resident_ffn" also splits the experts' F over
# ``data`` in the stored state (the dry run's ``resident`` rules), so that
# the MoE keeps that split and Adafactor's column moment of the gate and
# up weights lies otherwise than their blocks
STEP_VARIANTS = {
    "": ("adamw", 1, "block", {}, None),
    "adafactor_mb2_none": ("adafactor", 2, "none", {}, None),
    "resident_ffn": ("adafactor", 1, "block", {"expert_ffn": ("data",)},
                     ("resident",)),
    "dp_fsdp_split": ("adamw", 1, "block", DP_FSDP, ("model", "2x2")),
    "dp_fsdp_split_mb2": ("adafactor", 2, "none", DP_FSDP, ("model",)),
    "mb2_ignore": ("adamw", 2, "block", {}, ("data", "2x2")),
    "mb2_ignore_moe": ("adamw", 2, "block", {}, ("data", "2x2")),
}
# the row-split variants' global rows by mesh: batches that model does
# not divide, so that each rank of a model group runs its padded tile of
# a microbatch's rows of its shard: 3 over 2 (2 + 1), 2 over 4 (1, 1 and
# two empty ranks), a shard of 3 of 6 over 2 (2 + 1); in 2 microbatches
# 6 over 4 (3 a microbatch: 1, 1, 1 and an empty rank; a model of 2
# divides any batch that splits in 2 there).  Their labels hold IGNORE
# unevenly (``step_batch``)
SPLIT_ROWS = {"dp_fsdp_split": {(1, 2): 3, (1, 4): 2, (2, 2): 6},
              "dp_fsdp_split_mb2": {(1, 4): 6}}
# the microbatch variants: the batch split over data's 2 ranks, 2
# microbatches, 4 rows whose kept labels are MB_KEPT (the rest IGNORE):
# each rank's microbatch i is its block of the global batch's slice i
# (rows {0, 1}, then {2, 3}: the masked means weigh them so), not slice i
# of its own shard ({0, 2}, then {1, 3}).  "mb2_ignore_moe" is the reduced
# Qwen3 with its router's aux term on and copies dropping at the published
# capacity factor: its capacity, drops and aux are a batch shard's (and
# under 2x2 a model rank's slice of the sequence), which its world size 1
# runs alike (:func:`world1_step`)
MB_ROWS = {"mb2_ignore": {(2, 1): 4, (2, 2): 4},
           "mb2_ignore_moe": {(2, 1): 4, (2, 2): 4}}
MB_KEPT = (16, 0, 16, 11)
MB_ARCHS = {"mb2_ignore": ("smollm_360m",),
            "mb2_ignore_moe": ("qwen3_moe_30b_a3b",)}
MB_AUX_WEIGHT = 0.1
MEM_B, MEM_S, MEM_LAYERS = 4, 8, 4     # the per-rank memory check's step


# ---------------------------------------------------------------------------
# inputs and spawns


def make_inputs(path):
    """Every multi-rank check's inputs, from seeds."""
    rng = np.random.default_rng(31)
    D, E, F = 32, 4, 16
    inp = {
        "router": rng.standard_normal((D, E)).astype(np.float32) * 0.3,
        "we_gate": rng.standard_normal((E, D, F)).astype(np.float32) * 0.2,
        "we_up": rng.standard_normal((E, D, F)).astype(np.float32) * 0.2,
        "we_down": rng.standard_normal((E, F, D)).astype(np.float32) * 0.2,
        "x": rng.standard_normal((4, 16, D)).astype(np.float32),
        # tokens leaning toward expert 0, so that its bins overflow
        "x_drop": (rng.standard_normal((4, 16, D)) + 0.5).astype(np.float32),
        "g": rng.standard_normal((8, 13)).astype(np.float32) * 3.0,
        "g_ranks": rng.standard_normal((4, 8, 13)).astype(np.float32),
        "ws": np.stack([np.eye(8, dtype=np.float32) * (i + 1)
                        for i in range(4)]),
        "xs": rng.standard_normal((3, 4, 8)).astype(np.float32),
        "tokens": rng.integers(0, 512, (2, GRAD_B, GRAD_S + 1))
                     .astype(np.int32),
        "w_y": rng.standard_normal((4, 16, D)).astype(np.float32),
    }
    # drawn after the others, which stay as they were: an 8-row batch
    # (two rows a rank at 4 data ranks, for 2 microbatches), the gather
    # check's leaf and each rank's weights on it
    inp["tokens8"] = rng.integers(0, 512, (2, 2 * GRAD_B, GRAD_S + 1)) \
        .astype(np.int32)
    inp["gw"] = rng.standard_normal((4, 6)).astype(np.float32)
    inp["gx"] = rng.standard_normal((2, 4, 6)).astype(np.float32)
    inp["router_drop"] = inp["router"].copy()
    inp["router_drop"][:, 0] += 0.4
    # experts 1 and 2 tie for every token; 0 leads, so 1 (the lower id)
    # takes the second place everywhere and its bins overflow
    inp["router_ties_drop"] = inp["router"].copy()
    inp["router_ties_drop"][:, 2] = inp["router_ties_drop"][:, 1]
    inp["router_ties_drop"][:, 0] += 0.4
    # the row-split steps' batches (12 rows at most) and the share of each
    # row's labels set to IGNORE: none, some, all
    inp["tokens_split"] = rng.integers(0, 512, (2, 12, GRAD_S + 1)) \
        .astype(np.int32)
    frac = np.array([0.0, 0.75, 0.3, 1.0, 0.5, 0.0, 0.9, 0.1, 0.6, 1.0, 0.2,
                     0.4])
    inp["ignore"] = rng.random((2, 12, GRAD_S)) < frac[None, :, None]
    # the microbatch steps' batches: row r keeps its first MB_KEPT[r]
    # labels
    inp["tokens_mb"] = rng.integers(0, 512, (2, 4, GRAD_S + 1)) \
        .astype(np.int32)
    inp["ignore_mb"] = np.broadcast_to(
        np.arange(GRAD_S)[None, None, :]
        >= np.array(MB_KEPT)[None, :, None], (2, 4, GRAD_S)).copy()
    np.savez(path, **inp)
    return inp


def sub_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return env


def spawn(world: int, script: pathlib.Path, out: pathlib.Path, *extra,
          timeout: float = SPAWN_TIMEOUT_S) -> list[dict]:
    """Run ``script`` as ``world`` gloo ranks over a ``FileStore`` in
    ``out``, within ``timeout`` seconds in all; every rank must exit 0.
    Returns each rank's results (``out/rank{r}.pt``)."""
    out.mkdir(parents=True, exist_ok=True)
    store = out / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(script), "--world", str(world), "--rank",
         str(r), "--store", str(store), "--out", str(out), *map(str, extra)],
        env=sub_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"{world} ranks of {script.name} passed {timeout} s")
    failed = [f"rank {r} of {world} (exit {p.returncode}):\n{log[-3000:]}"
              for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not failed, "\n".join(failed)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def init_rank_group(world, rank, store):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(store), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


# ---------------------------------------------------------------------------
# the reference side (a subprocess with n host devices)

_REF_SCRIPT = r"""
import os, sys
n = int(sys.argv[1])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
import jax, jax.numpy as jnp, numpy as np
from repro.models import moe as M
from repro.models.config import ModelConfig
from repro.parallel import sharding as SH
from repro.parallel.compress import compressed_psum_mean
from repro.parallel.pipeline import pipeline_apply
import test_torch_parallel as TP

inp = dict(np.load(sys.argv[2]))
out = {}
devs = jax.devices()[:n]

mesh = SH.make_mesh((n,), ("pod",), devices=devs)
mean, err = compressed_psum_mean({"w": jnp.asarray(inp["g"])},
                                 {"w": jnp.zeros((8, 13), jnp.float32)},
                                 mesh, axis="pod")
out["compress/mean"] = np.asarray(mean["w"])
out["compress/err"] = np.asarray(err["w"])
try:
    pipeline_apply(lambda w, x: x @ w, jnp.asarray(inp["ws"][:n]),
                   jnp.asarray(inp["xs"]), mesh, axis="pod")
    out["pipeline/error"] = np.asarray("")
except ValueError as e:
    out["pipeline/error"] = np.asarray(str(e))

for name, (shape, cfg_kw, rules_kw, xkey, keep) in TP.EP_CASES[n].items():
    cfg = ModelConfig(**{**TP.MOE_KW, **cfg_kw})
    p = {k: jnp.asarray(inp[k]) for k in ("we_gate", "we_up", "we_down")}
    p["router"] = jnp.asarray(inp[TP.router_key(name)])
    x = jnp.asarray(inp[xkey])
    if keep:
        x = x[:, :keep]
    mesh = SH.make_mesh(shape, ("data", "model"), devices=devs)
    rules = SH.DEFAULT_RULES.override(**rules_kw)
    w = jnp.asarray(inp["w_y"][:, :x.shape[1]])

    def loss(p, x):
        y, aux = M.moe_ffn(p, x, cfg)
        return jnp.sum(y * w) + aux

    with SH.sharding_context(mesh, rules):
        y, aux = jax.jit(lambda p, x: M.moe_ffn(p, x, cfg))(p, x)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
    out[f"moe/{name}/y"] = np.asarray(y)
    out[f"moe/{name}/aux"] = np.asarray(aux)
    out[f"moe/{name}/dx"] = np.asarray(gx)
    for k, g in gp.items():
        out[f"moe/{name}/d{k}"] = np.asarray(g)
np.savez(sys.argv[3], **out)
print("REF_OK")
"""


def start_reference(n, inputs, out):
    """The reference's side at n devices, started in the background;
    :func:`reference_results` waits for it."""
    return subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, str(n),
                             str(inputs), str(out)], env=sub_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def reference_results(proc, out):
    try:
        stdout, stderr = proc.communicate(timeout=SPAWN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail(f"the reference's side passed {SPAWN_TIMEOUT_S} s")
    assert "REF_OK" in stdout, stdout[-2000:] + stderr[-4000:]
    return dict(np.load(out))


# ---------------------------------------------------------------------------
# the port's ranks


def router_key(case: str) -> str:
    """The router weights of an EP case: tied experts, overflowing bins,
    or the plain draw."""
    if case.startswith("ties"):
        return "router_ties_drop"
    return "router_drop" if "drop" in case else "router"


def _moe_params(inp, case=""):
    p = {k: torch.from_numpy(inp[k]) for k in ("we_gate", "we_up", "we_down")}
    p["router"] = torch.from_numpy(inp[router_key(case)])
    return p


def drops_of(x_tok, router, cfg):
    """Token copies past capacity when ``x_tok`` [t, D] is routed alone."""
    from repro_torch.models import moe as M

    _, top_e, _ = M._router(x_tok, router, cfg)
    counts = torch.bincount(top_e.reshape(-1), minlength=cfg.num_experts)
    return int(torch.clamp(counts - M.capacity(x_tok.shape[0], cfg),
                           min=0).sum())


def grad_cfg(arch, **kw):
    """A reduced f32 config for the gradient checks; a MoE at capacity
    factor E / k (nothing drops) and without its load-balance term, which
    the reference computes per shard (see :func:`test_ep_gradients`)."""
    from repro_torch.launch.train import reduced

    cfg = reduced(PC.get_config(arch)).with_(dtype="float32",
                                             param_dtype="float32", **kw)
    if cfg.num_experts:
        cfg = cfg.with_(capacity_factor=cfg.num_experts
                        / cfg.experts_per_token, router_aux_weight=0.0)
    return cfg


def grad_batch(inp, i, key="tokens"):
    t = torch.from_numpy(inp[key][i]).long()
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def case_rows(variant) -> dict | None:
    """{mesh shape: global rows} of a variant whose batches have rows of
    their own (``SPLIT_ROWS``, ``MB_ROWS``), else None."""
    return SPLIT_ROWS.get(variant) or MB_ROWS.get(variant)


def step_cases(world):
    """(arch, mesh name, variant) of every sharded-step case at ``world``
    ranks."""
    return [(arch, m, v) for v, (*_, meshes) in STEP_VARIANTS.items()
            for arch in MB_ARCHS.get(v, SPLIT_ARCHS if v in SPLIT_ROWS
                                     else GRAD_ARCHS)
            for m, (shape, _) in GRAD_MESHES[world].items()
            if (meshes is None or m in meshes)
            and shape in (case_rows(v) or {shape: None})]


def step_setup(arch, mesh_name, variant, world):
    """The case's config, optimizer, microbatches, rules, batch key and
    global rows (None: the batch key's own; each rank then takes its
    block over every batch axis, as the launcher's loader gives it)."""
    from repro_torch.parallel import sharding as SH
    from repro_torch.train.optim import OptConfig

    name, mb, remat, rules_kw, _ = STEP_VARIANTS[variant]
    shape, kw = GRAD_MESHES[world][mesh_name]
    cfg = grad_cfg(arch, remat=remat, **kw)
    if variant == "mb2_ignore_moe":
        cfg = cfg.with_(capacity_factor=CF_PUBLISHED,
                        router_aux_weight=MB_AUX_WEIGHT)
    opt = OptConfig(name=name, lr=1e-3, warmup_steps=1, total_steps=10)
    rules = SH.DEFAULT_RULES.override(**rules_kw)
    if variant in SPLIT_ROWS:
        return cfg, opt, mb, rules, "tokens_split", SPLIT_ROWS[variant][shape]
    if variant in MB_ROWS:
        return cfg, opt, mb, rules, "tokens_mb", MB_ROWS[variant][shape]
    return cfg, opt, mb, rules, "tokens8" if mb > 1 else "tokens", None


# the mask of each batch key with rows of its own: True where a label is
# IGNORE
IGNORE_OF = {"tokens_split": "ignore", "tokens_mb": "ignore_mb"}


def step_batch(inp, i, key, rows=None):
    """Step ``i``'s global batch: :func:`grad_batch`, or with ``rows`` the
    first rows of ``key``'s, their labels IGNORE where its mask
    (``IGNORE_OF``) says."""
    from repro_torch.train.step import IGNORE

    if rows is None:
        return grad_batch(inp, i, key)
    t = torch.from_numpy(inp[key][i][:rows]).long()
    mask = torch.from_numpy(inp[IGNORE_OF[key]][i][:rows])
    return {"tokens": t[:, :-1], "labels": t[:, 1:].masked_fill(mask, IGNORE)}


def world1_step(cfg, opt, mb, variant, shape):
    """The world-size-1 step a sharded case is held to:
    ``make_train_step``'s on the global batch.  For ``mb2_ignore_moe``,
    whose router statistics (capacity, drops, aux) are those of the
    tokens a rank routes, the same step with each microbatch's rows run a
    batch shard at a time (``shape``'s data ranks), its MoE a slice of
    the sequence at a time (``shape``'s model ranks: the ``a2a`` path's
    tokens) through the dense fallback, the loss the global batch's
    masked mean and the aux the mean over those token groups.  Its
    ``drops`` lists the copies dropped a call."""
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.train import step as ST

    step = ST.make_train_step(cfg, opt, microbatches=mb)
    if variant != "mb2_ignore_moe":
        return step
    shards, ep = shape
    drops = []
    # no remat: a recompute would run after ``moe_ffn`` is restored
    plain = cfg.with_(remat="none")

    def moe_slices(p, x, cfg_, prefix="", rows=None):
        S, D = x.shape[1], x.shape[2]
        out = []
        for j in range(ep):
            xs = x[:, j * S // ep:(j + 1) * S // ep]
            drops.append(drops_of(xs.detach().reshape(-1, D),
                                  p[f"{prefix}router"].detach(), cfg_))
            out.append(M._moe_dense_fallback(p, xs, cfg_, prefix))
        return (torch.cat([y for y, _ in out], dim=1),
                torch.stack([a for _, a in out]).mean())

    def loss_of(params, batch):
        sums, counts, auxs = [], [], []
        real, M.moe_ffn = M.moe_ffn, moe_slices
        try:
            for tok, lab in zip(batch["tokens"].chunk(shards),
                                batch["labels"].chunk(shards)):
                logits, _, aux = T.forward(params, {"tokens": tok}, plain)
                loss, _ = ST.cross_entropy(logits, lab)
                count = (lab != ST.IGNORE).sum()
                sums.append(loss * torch.clamp(count, min=1))
                counts.append(count)
                auxs.append(aux)
        finally:
            M.moe_ffn = real
        return (torch.stack(sums).sum()
                / torch.clamp(torch.stack(counts).sum(), min=1)
                + cfg.router_aux_weight * torch.stack(auxs).mean())

    def train_step(state, batch):
        params = state["params"]
        dev = next(iter(params.values())).device
        n = batch["tokens"].shape[0] // mb
        acc = {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
               for k, v in params.items()}
        losses = []
        for i in range(mb):
            part = {k: torch.as_tensor(v)[i * n:(i + 1) * n].to(dev)
                    for k, v in batch.items()}
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            with torch.enable_grad():
                loss = loss_of(leaves, part)
                grads = torch.autograd.grad(loss, list(leaves.values()),
                                            allow_unused=True)
            for (k, a), g in zip(acc.items(), grads):
                if g is not None:
                    a.add_(g.float() / mb)
            losses.append(loss.detach())
        return step.apply(state, torch.stack(losses).mean(), {}, acc)

    train_step.init_opt = step.init_opt
    train_step.drops = drops
    return train_step


def state_wholes(state, path=""):
    """{path: whole tensor} of every tensor leaf of ``state`` (a DTensor
    gathered whole)."""
    if isinstance(state, dict):
        return {k2: v2 for k, v in state.items()
                for k2, v2 in state_wholes(v, f"{path}{k}.").items()}
    if hasattr(state, "full_tensor"):
        return {path: state.full_tensor()}
    return {path: state} if isinstance(state, torch.Tensor) else {}


def mem_cfg():
    """The memory check's config: a reduced f32 SmolLM at MEM_LAYERS
    layers under block remat, whose state outweighs a step's activations
    at MEM_B x MEM_S."""
    return grad_cfg("smollm_360m", num_layers=MEM_LAYERS, remat="block")


def _gather_check(rank, inp):
    """World size 2 on a (2, 1) mesh: a leaf split over ``data`` and a
    replicated one, each gathered and multiplied by this rank's own
    weights: the gathered values, and the gradient landed in the block."""
    from repro_torch.parallel import sharding as SH

    mesh = SH.make_mesh((2, 1), ("data", "model"), device="cpu")
    ops = SH.MeshOps(mesh)
    w, x = torch.from_numpy(inp["gw"]), torch.from_numpy(inp["gx"][rank])
    out = {}
    for name, axes in (("split", ("embed", None)), ("replicated", (None,))):
        sh = SH.logical_sharding(axes, mesh)
        local = w[sh.local_slices(w.shape, mesh.get_coordinate())].clone()
        local.requires_grad_(True)
        full = SH.ShardedLeaf(local, sh, ops, key=name).gather()
        grad, = torch.autograd.grad((full * x).sum(), [local])
        out[name] = {"full": full.detach(), "grad": grad,
                     "slices": sh.local_slices(w.shape,
                                               mesh.get_coordinate()),
                     "aliased": full.data_ptr() == local.data_ptr()}
    return out


def rs_inputs(world):
    """Every rank's tensor for the reduce-scatter check, [world, ...]."""
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.standard_normal(
        (world, 2 * world, 3 * world, world)).astype(np.float32))


def _reduce_scatter_check(world, rank):
    """``parallel.sharding.reduce_scatter`` of this rank's tensor along each
    dimension over a (world,) mesh, by the all-reduce route and by the
    group's own ``reduce_scatter_tensor`` (forced on gloo, which runs it
    here).  Returns {route: {dim: block}}."""
    from repro_torch.parallel import sharding as SH

    mesh = SH.make_mesh((world,), ("pod",), device="cpu")
    x = rs_inputs(world)[rank]
    real = SH.native_reduce_scatter
    out = {}
    for route, native in (("all_reduce", False), ("native", True)):
        SH.native_reduce_scatter = lambda x, group, native=native: native
        try:
            out[route] = {d: SH.reduce_scatter(x, mesh.get_group("pod"), d)
                          for d in range(x.dim())}
        finally:
            SH.native_reduce_scatter = real
    return out


# the all-to-all checks: world -> (mesh shape, axis names, the axis
# exchanged over) cases; each rank's tensor has 2 rows a block
A2A_CASES = {2: (((2,), ("pod",), "pod"),),
             4: (((4,), ("pod",), "pod"),
                 ((2, 2), ("data", "model"), "model"),
                 ((2, 2), ("data", "model"), "data"))}


def a2a_inputs(world):
    """Every rank's tensor and cotangent for the all-to-all check, each
    [world, 2 * world, 3]."""
    rng = np.random.default_rng(11)
    return tuple(torch.from_numpy(rng.standard_normal(
        (world, 2 * world, 3)).astype(np.float32)) for _ in range(2))


def _all_to_all_check(world, rank):
    """Each ``A2A_CASES`` exchange of this rank's tensor: through
    ``MeshOps.all_to_all``, through ``dist.all_to_all_single`` on the
    axis's group, and through ``AllToAll`` with its gradient of the sum
    of the output times this rank's cotangent.  Returns {case index:
    results}."""
    import torch.distributed as dist

    from repro_torch.parallel import sharding as SH

    xs, gs = a2a_inputs(world)
    out = {}
    for i, (shape, names, axis) in enumerate(A2A_CASES[world]):
        mesh = SH.make_mesh(shape, names, device="cpu")
        ops = SH.MeshOps(mesh)
        x = xs[rank][:2 * ops.sizes[axis]]
        g = gs[rank][:2 * ops.sizes[axis]]
        direct = torch.empty_like(x)
        dist.all_to_all_single(direct, x, group=mesh.get_group(axis))
        leaf = x.clone().requires_grad_(True)
        y = SH.AllToAll.apply(leaf, ops, axis)
        gx, = torch.autograd.grad((y * g).sum(), [leaf])
        out[i] = {"ops": ops.all_to_all(x, axis), "direct": direct,
                  "y": y.detach(), "gx": gx,
                  "group": dist.get_process_group_ranks(
                      mesh.get_group(axis))}
    return out


def _memory_check(world, rank, inp, shape=None):
    """One sharded step of ``mem_cfg`` at ``world`` ranks on a ``shape``
    mesh ((world, 1) by default) under ``LiveBytes``: the rank's peak live
    storage bytes (its state shards and batch rows included), and every
    block's entry at which a gathered layer of another super-block was
    still alive (the leaves a module gathers itself, split over ``model``,
    reach the block as shards)."""
    import weakref

    from repro_torch.launch import train as LT
    from repro_torch.launch.dryrun import LiveBytes
    from repro_torch.models import transformer as MT
    from repro_torch.parallel import sharding as SH
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step, train_state_specs

    cfg = mem_cfg()
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt, donate=True)
    mesh = SH.make_mesh(shape or (world, 1), ("data", "model"),
                        device="cpu")
    shapes, axes = train_state_specs(cfg, opt)
    state_sh = SH.tree_shardings(axes, shapes, mesh)
    state = LT.place(LT.init_state(cfg, step, "cpu"), state_sh)
    jstep = LT.make_sharded_step(step, mesh, state_sh)
    idx, n = LT.batch_shard(mesh)
    batch = local_rows(mem_batch(inp), idx, n)
    alive, seen, late = [], [], []
    real_gather, real_block = SH.ShardedLeaf.gather, MT.block_fwd

    def gather(self, keep=()):
        out = real_gather(self, keep)
        st = out.untyped_storage()
        if st.data_ptr() != self.local.untyped_storage().data_ptr():
            alive.append((self.index, weakref.ref(st)))
        return out

    def block_fwd(kind, cfg_, p, x, **kw):
        live = [(i, r()) for i, r in alive if r() is not None]
        mine = {id(v.untyped_storage()) for v in p.values()
                if isinstance(v, torch.Tensor)}
        now = {i for i, st in live if id(st) in mine}
        seen.append(sorted(now))
        others = {i for i, st in live if i is not None and i not in now}
        if others:
            late.append((sorted(now), sorted(others)))
        return real_block(kind, cfg_, p, x, **kw)

    SH.ShardedLeaf.gather, MT.block_fwd = gather, block_fwd
    mem = LiveBytes("cpu")
    try:
        args = sum(mem.track(v.to_local()) for v in _dtensors(state)) + sum(
            mem.track(t) for t in batch.values())
        with mem:
            state, m = jstep(state, batch)
    finally:
        SH.ShardedLeaf.gather, MT.block_fwd = real_gather, real_block
    return {"peak": mem.peak, "args": args, "loss": m["loss"],
            "blocks": seen, "late": late}


def _dtensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _dtensors(v)]
    return [tree] if hasattr(tree, "to_local") else []


def mem_batch(inp):
    """The memory check's global batch: MEM_B rows of MEM_S tokens."""
    t = torch.from_numpy(inp["tokens"][0][:MEM_B, :MEM_S + 1]).long()
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def spec_shard(mesh, rows=None):
    """(this rank's index, their count) of its batch shard: the launcher's
    (``launch.train.batch_shard``, along the rules' batch axes), or with
    ``rows`` that of a global batch of ``rows`` under the batch's spec
    (``model`` dropped where it does not divide them)."""
    from repro_torch.launch import train as LT
    from repro_torch.parallel import sharding as SH

    if rows is None:
        return LT.batch_shard(mesh)
    sl = SH.logical_sharding(("batch",), mesh, shape=(rows,)).local_slices(
        (rows,), mesh.get_coordinate())[0]
    return sl.start // (sl.stop - sl.start), rows // (sl.stop - sl.start)


def local_rows(batch, idx, n):
    b = next(iter(batch.values())).shape[0]
    return {k: v[idx * b // n:(idx + 1) * b // n] for k, v in batch.items()}


def storage_bytes(state, path=""):
    """{path: (bytes of the local tensor's storage, bytes of the local
    tensor, bytes of the whole leaf)} for every DTensor leaf of
    ``state``."""
    if isinstance(state, dict):
        return {k2: v2 for k, v in state.items()
                for k2, v2 in storage_bytes(v, f"{path}/{k}").items()}
    if hasattr(state, "to_local"):
        local = state.to_local()
        return {path: (local.untyped_storage().nbytes(),
                       local.numel() * local.element_size(),
                       state.numel() * local.element_size())}
    return {}


def _traced_save(path, placed):
    """A blocking ``CheckpointManager`` save of the DTensor state
    ``placed`` to ``path``; returns (the leaf's bytes, the peak bytes of
    the tensors this rank made while it took part in assembling it, the
    bytes of one leading-axis row of its block) for each split leaf."""
    from repro_torch.launch.dryrun import LiveBytes
    from repro_torch.runtime import checkpoint as CK

    gathers = []
    real = CK._host_sharded

    def host_sharded(leaf):
        mem = LiveBytes("cpu")
        block = mem.track(leaf.to_local())
        with mem:
            out = real(leaf)
        gathers.append((leaf.numel() * leaf.element_size(),
                        mem.peak - block,
                        block // max(leaf.to_local().shape[0], 1)))
        return out

    CK._host_sharded = host_sharded
    try:
        CK.CheckpointManager(path).save(3, placed, blocking=True)
    finally:
        CK._host_sharded = real
    return gathers


def _rank_checks(world, rank, out, inp):
    import torch.distributed as dist

    from repro_torch.launch import train as LT
    from repro_torch.launch.dryrun import LiveBytes
    from repro_torch.models import moe as M
    from repro_torch.models.config import ModelConfig
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.compress import compressed_psum_mean
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.runtime import checkpoint as CK
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step, train_state_specs

    res = {"rank": rank}
    mesh = SH.make_mesh((world,), ("pod",), device="cpu")
    g = torch.from_numpy(inp["g"])
    mean, err = compressed_psum_mean({"w": g}, {"w": torch.zeros_like(g)},
                                     mesh, axis="pod")
    res["compress/mean"], res["compress/err"] = mean["w"], err["w"]
    g_r = torch.from_numpy(inp["g_ranks"][rank])
    res["compress/mean_ranks"] = compressed_psum_mean(
        [g_r], [torch.zeros_like(g_r)], mesh, axis="pod")[0][0]
    res["pipeline"] = pipeline_apply(
        lambda w, x: x @ w, torch.from_numpy(inp["ws"][:world]),
        torch.from_numpy(inp["xs"]), mesh, axis="pod")

    for name, (shape, cfg_kw, rules_kw, xkey, keep) in EP_CASES[world].items():
        cfg = ModelConfig(**{**MOE_KW, **cfg_kw})
        mesh = SH.make_mesh(shape, ("data", "model"), device="cpu")
        rules = SH.DEFAULT_RULES.override(**rules_kw)
        x = torch.from_numpy(inp[xkey])
        if keep:
            x = x[:, :keep]
        p = _moe_params(inp, name)
        with SH.sharding_context(mesh, rules):
            idx, n = LT.batch_shard(mesh)
            rows = slice(idx * x.shape[0] // n, (idx + 1) * x.shape[0] // n)
            xl = x[rows].clone().requires_grad_(True)
            p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
            y, aux = M.moe_ffn(p, xl, cfg)
            # each rank's share of sum(y * w) + aux: the ranks' gradients
            # summed over every rank, over the replicas of a batch shard,
            # are the whole function's
            w = torch.from_numpy(inp["w_y"][rows, :xl.shape[1]])
            grads = torch.autograd.grad((y * w).sum() + aux / n,
                                        [xl, *p.values()])
        y, aux = y.detach(), aux.detach()
        ep, mi = shape[1], mesh.get_local_rank("model")
        S = xl.shape[1]
        xs = xl if keep or "model" in rules.get("batch") else \
            xl[:, mi * (S // ep):(mi + 1) * (S // ep)]
        res[f"moe/{name}"] = {
            "idx": idx, "n": n, "y": y, "aux": aux, "dx": grads[0],
            "dp": dict(zip(p, grads[1:])),
            "drops": drops_of(xs.reshape(-1, xs.shape[-1]), p["router"], cfg)}

    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    b0 = grad_batch(inp, 0)
    for arch in GRAD_ARCHS:
        for mname, (shape, kw) in GRAD_MESHES[world].items():
            cfg = grad_cfg(arch, **kw)
            mesh = SH.make_mesh(shape, ("data", "model"), device="cpu")
            idx, n = LT.batch_shard(mesh)
            step = make_train_step(cfg, opt)
            params = LT.init_state(cfg, step, "cpu")["params"]
            with SH.sharding_context(mesh):
                loss, _, grads = step.grads(params, local_rows(b0, idx, n))
            key = f"grad/{arch}/{mname}"
            res[key] = {"loss": LT._mean_over_ranks(loss),
                        "grads": {k: LT._mean_over_ranks(v)
                                  for k, v in grads.items()}}

    for arch, mname, variant in step_cases(world):
        cfg, opt, mb, rules, bkey, rows = step_setup(arch, mname, variant,
                                                     world)
        mesh = SH.make_mesh(GRAD_MESHES[world][mname][0], ("data", "model"),
                            device="cpu")
        donated = make_train_step(cfg, opt, microbatches=mb, donate=True)
        shapes, axes = train_state_specs(cfg, opt)
        with SH.sharding_context(mesh, rules):
            idx, n = spec_shard(mesh, rows)
            state_sh = SH.tree_shardings(axes, shapes, mesh)
            state = LT.place(LT.init_state(cfg, donated, "cpu"), state_sh)
            jstep = LT.make_sharded_step(donated, mesh, state_sh, rows=rows)
            split = SH.row_group(SH.MeshOps(mesh), rows)
        losses = []
        for i in range(2):
            state, m = jstep(state, local_rows(step_batch(inp, i, bkey, rows),
                                               idx, n))
            losses.append(m["loss"])
        res[f"steps/{arch}/{mname}/{variant}"] = {
            "losses": losses, "step": state["step"],
            "tile": None if split is None else split.block(rows // n // mb),
            "storage": storage_bytes(state), **state_wholes(state)}

    res["reduce_scatter"] = _reduce_scatter_check(world, rank)
    res["all_to_all"] = _all_to_all_check(world, rank)
    if world == 2:
        res["gather"] = _gather_check(rank, inp)
        real = SH.native_reduce_scatter
        SH.native_reduce_scatter = lambda x, group: True
        try:
            res["gather/native"] = _gather_check(rank, inp)
        finally:
            SH.native_reduce_scatter = real
    if world == 4:
        res["memory"] = _memory_check(world, rank, inp)
        res["memory/tp"] = _memory_check(world, rank, inp, (1, 4))

    # the sharded checkpoint: written at world size 2, read at 4
    cfg, opt, _ = _whole_state()
    step = make_train_step(cfg, opt)
    shapes, axes = train_state_specs(cfg, opt)
    ckpt = out.parent / "ckpt"
    if world == 2:
        mesh = SH.make_mesh((2, 1), ("data", "model"), device="cpu")
        whole = LT.init_state(cfg, step, "cpu")
        placed = LT.place(whole, SH.tree_shardings(axes, shapes, mesh))
        res["placements"] = {k: v.placements
                             for k, v in placed["params"].items()}
        res["placed"] = {"storage": storage_bytes(placed)}
        res["save_gathers"] = _traced_save(ckpt / "sharded", placed)
        if rank == 0:
            CheckpointManager(ckpt / "whole").save(3, whole)
        dist.barrier()
    else:
        # a save within a budget under one leading-axis row of every rank
        mesh = SH.make_mesh((4, 1), ("data", "model"), device="cpu")
        placed = LT.place(LT.init_state(cfg, step, "cpu"),
                          SH.tree_shardings(axes, shapes, mesh))
        real = CK.SAVE_GATHER_BYTES
        CK.SAVE_GATHER_BYTES = SAVE_BUDGET
        try:
            res["budget_gathers"] = _traced_save(ckpt / "budget", placed)
        finally:
            CK.SAVE_GATHER_BYTES = real
        for shape in ((2, 2), (4, 1)):
            mesh = SH.make_mesh(shape, ("data", "model"), device="cpu")
            sh = SH.tree_shardings(axes, shapes, mesh)
            back = CheckpointManager(ckpt / "sharded").restore(
                LT.state_template(shapes), placements=sh, verify=True)
            res[f"restore/{shape}"] = {
                "coord": mesh.get_coordinate(), "step": back["step"],
                "storage": storage_bytes(back),
                "count": back["opt"]["count"],
                "leaves": {f"{grp}/{k}": (v.to_local(), v.placements,
                                          sh_leaf.spec)
                           for grp, tree, shs in (
                               ("params", back["params"], sh["params"]),
                               ("m", back["opt"]["m"], sh["opt"]["m"]))
                           for k, v in tree.items()
                           for sh_leaf in (shs[k],)}}
    torch.save(res, out / f"rank{rank}.pt")


def _rank_main(argv=None):
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    for a in ("--world", "--rank"):
        ap.add_argument(a, type=int)
    for a in ("--store", "--out", "--inputs"):
        ap.add_argument(a)
    a = ap.parse_args(argv)
    init_rank_group(a.world, a.rank, a.store)
    try:
        _rank_checks(a.world, a.rank, pathlib.Path(a.out),
                     dict(np.load(a.inputs)))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference and the port at 2 and 4 ranks: {n: (reference
    results, [port results by rank])}, and the inputs and checkpoint
    directory."""
    root = tmp_path_factory.mktemp("parallel")
    inputs = root / "inputs.npz"
    inp = make_inputs(inputs)
    refs = {n: start_reference(n, inputs, root / f"ref{n}.npz")
            for n in (2, 4)}
    ports = {n: spawn(n, pathlib.Path(__file__), root / f"port{n}",
                      "--inputs", inputs)
             for n in (2, 4)}      # 4 reads the checkpoint that 2 writes
    out = {n: (reference_results(refs[n], root / f"ref{n}.npz"), ports[n])
           for n in (2, 4)}
    return {"inp": inp, "ckpt": root / "ckpt", **out}


@pytest.fixture(scope="module")
def group1():
    """A one-rank gloo group in this process (``launch.mesh``'s own)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_one_rank_group

    if not dist.is_initialized():
        init_one_rank_group("cpu")
    yield
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# specs: every logical-axes tuple of all ten configs on five meshes

MESHES = (((1, 1), ("data", "model")), ((2, 1), ("data", "model")),
          ((1, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))


def policy_overrides():
    """The rules ``apply_policy`` builds (``src/repro/launch/dryrun.py:
    39-118``), written out: the module itself is not imported, since its
    first line sets ``XLA_FLAGS`` for the process."""
    return {
        "baseline": {},
        "decode_b1": dict(batch=(), cache_batch=()),
        "resident": dict(expert_ffn=("data",)),
        "dp_all": dict(batch=("pod", "data", "model"), embed=(), heads=(),
                       kv_heads=(), ffn=(), vocab=(), act_heads=(),
                       act_ffn=(), act_vocab=()),
        "serve_tp": dict(embed=()),
        "cache_heads": dict(cache_seq=(), cache_kv_heads=("model",),
                            act_heads=()),
        "dp_fsdp": dict(batch=("pod", "data", "model"), heads=(), kv_heads=(),
                        ffn=(), vocab=(), act_heads=(), act_ffn=(),
                        act_vocab=()),
        "attn_dp": dict(batch=("pod", "data", "model"), heads=(), kv_heads=(),
                        vocab=(), act_heads=(), act_ffn=(), act_vocab=(),
                        ffn=()),
    }


def _trees(arch):
    """(reference (shapes, axes), port (shapes, axes)) of every tree whose
    leaves get a sharding: params, decode cache, AdamW and Adafactor
    train states."""
    from repro import configs as RC
    from repro.models import transformer as RT
    from repro.train import step as RS
    from repro.train.optim import OptConfig as ROpt
    from repro_torch.models import transformer as PT
    from repro_torch.train import step as PS
    from repro_torch.train.optim import OptConfig as POpt

    rc, pc = RC.get_config(arch), PC.get_config(arch)
    out = [((RT.param_shapes(rc), RT.param_axes(rc)),
            (PT.param_shapes(pc), PT.param_axes(pc))),
           ((RT.cache_shapes(rc, 8, 1024), RT.cache_axes(rc, 8, 1024)),
            (PT.cache_shapes(pc, 8, 1024),
             {k: ax for k, (_, ax) in PT.cache_specs(pc, 8, 1024).items()}))]
    for name in ("adamw", "adafactor"):
        out.append((RS.train_state_specs(rc, ROpt(name=name)),
                    PS.train_state_specs(pc, POpt(name=name))))
    return out


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("arch", PC.ARCH_IDS)
def test_specs_equal_reference(arch):
    """``logical_sharding(...).spec`` equals the reference's
    ``PartitionSpec`` for every logical-axes tuple of the config's
    params, cache and train states, on the five meshes, under
    ``DEFAULT_RULES`` and every ``apply_policy`` override, with and
    without shapes."""
    from jax.sharding import AbstractMesh

    from repro.parallel import sharding as RSH
    from repro_torch.parallel import sharding as PSH

    n = 0
    for (r_shapes, r_axes), (p_shapes, p_axes) in _trees(arch):
        assert dict(_flat(r_axes)) == dict(_flat(p_axes))
        for shape, names in MESHES:
            rm, pm = AbstractMesh(shape, names), PSH.AbstractMesh(shape, names)
            for ov in policy_overrides().values():
                rr = RSH.DEFAULT_RULES.override(**ov)
                pr = PSH.DEFAULT_RULES.override(**ov)
                for with_shapes in (False, True):
                    ref = RSH.tree_shardings(
                        r_axes, r_shapes if with_shapes else None, rm, rr)
                    got = PSH.tree_shardings(
                        p_axes, p_shapes if with_shapes else None, pm, pr)
                    want = {k: tuple(v.spec) for k, v in _flat(ref)}
                    have = {k: v.spec for k, v in _flat(got)}
                    assert have == want, (arch, shape, ov, with_shapes)
                    n += len(have)
    assert n > 1000


def test_default_rules_equal_reference():
    from repro.parallel import sharding as RSH
    from repro_torch.parallel import sharding as PSH

    assert PSH.DEFAULT_RULES.rules == RSH.DEFAULT_RULES.rules


def test_placements_follow_the_spec():
    """Shard(i) on each mesh dimension that splits tensor dimension i; an
    entry of several axes out of the mesh's order is refused."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel import sharding as PSH

    mesh = PSH.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    sh = PSH.logical_sharding(("batch", None, "vocab"), mesh)
    assert sh.spec == (("pod", "data"), None, "model")
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert PSH.logical_sharding(("norm",), mesh).placements == \
        (Replicate(),) * 3
    assert sh.local_slices((64, 3, 32), (1, 2, 3)) == (
        slice(36, 38), slice(0, 3), slice(6, 8))
    rules = PSH.DEFAULT_RULES.override(batch=("data", "pod"))
    with pytest.raises(ValueError, match="order"):
        PSH.logical_sharding(("batch",), mesh, rules)


# the seven tests of tests/test_sharding.py, on the port


@pytest.fixture(scope="module")
def mesh2d(group1):
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh("cpu")


def test_missing_mesh_axis_dropped(mesh2d):
    from repro_torch.parallel import sharding as SH

    sh = SH.logical_sharding(("batch", None), mesh2d)
    assert sh.spec == ("data",)


def test_divisibility_dropping(mesh2d):
    from repro_torch.parallel import sharding as SH

    n = SH.mesh_shape(mesh2d)["data"]
    sh = SH.logical_sharding(("batch",), mesh2d, SH.DEFAULT_RULES, shape=(7,))
    assert (sh.spec != ()) == (7 % n == 0)
    big = SH.AbstractMesh((4, 1), ("data", "model"))
    assert SH.logical_sharding(("batch",), big, shape=(7,)).spec == ()
    assert SH.logical_sharding(("batch",), big, shape=(8,)).spec == ("data",)


def test_no_axis_reuse(mesh2d):
    from repro_torch.parallel import sharding as SH

    rules = SH.DEFAULT_RULES.override(seq=("data",))
    sh = SH.logical_sharding(("batch", "seq"), mesh2d, rules)
    flat = []
    for part in sh.spec:
        if part is None:
            continue
        flat.extend([part] if isinstance(part, str) else list(part))
    assert len(flat) == len(set(flat))


def test_tree_shardings_with_shapes(mesh2d):
    from repro_torch.models.transformer import TensorSpec
    from repro_torch.parallel import sharding as SH

    axes = {"a": ("batch", None), "b": ("vocab", "embed")}
    shapes = {"a": TensorSpec((8, 4), torch.float32),
              "b": TensorSpec((13, 16), torch.float32)}
    tree = SH.tree_shardings(axes, shapes, mesh2d)
    assert set(tree) == {"a", "b"}


def test_shard_act_noop_outside_context():
    from repro_torch.parallel import sharding as SH

    x = torch.ones(4, 4)
    assert SH.shard_act(x, "batch", None) is x


def test_context_installs_mesh(mesh2d):
    """Inside the context the mesh is current; ``shard_act`` leaves a plain
    tensor alone and redistributes a DTensor to the spec's placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.parallel import sharding as SH

    with SH.sharding_context(mesh2d):
        assert SH.current_mesh() is mesh2d
        x = torch.ones(2, 2)
        assert SH.shard_act(x, "batch", None) is x
        d = DTensor.from_local(torch.ones(2, 2), mesh2d,
                               (Replicate(), Replicate()))
        y = SH.shard_act(d, "batch", None)
        assert y.placements == (Shard(0), Replicate())
        assert torch.equal(y.full_tensor(), torch.ones(2, 2))
    assert SH.current_mesh() is None


def test_override():
    from repro_torch.parallel import sharding as SH

    r = SH.DEFAULT_RULES.override(heads=None, embed="model", batch=("data",))
    assert r.get("heads") == ()
    assert r.get("embed") == ("model",)
    assert r.get("batch") == ("data",)
    # original untouched
    assert SH.DEFAULT_RULES.get("heads") == ("model",)


def test_meshes_need_their_ranks(group1):
    """``make_production_mesh`` refuses a group that is not 256 or 512
    ranks and builds nothing; importing the modules started no group."""
    from repro_torch.launch.mesh import make_production_mesh

    for multi in (False, True):
        with pytest.raises(ValueError, match="ranks"):
            make_production_mesh(multi_pod=multi, device="cpu")
    code = ("import torch.distributed as d, repro_torch.launch.mesh, "
            "repro_torch.launch.train, repro_torch.parallel.pipeline, "
            "repro_torch.parallel.compress; "
            "assert not d.is_initialized(); print('OK')")
    r = subprocess.run([sys.executable, "-c", code], env=sub_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.stdout.strip() == "OK", r.stderr


# ---------------------------------------------------------------------------
# compress: tests/test_compress.py on the port, and against the reference

try:
    from hypothesis import given, settings, strategies as st
    from hypothesis.extra import numpy as hnp
except ImportError:  # pragma: no cover - optional dep (see requirements.txt)
    from _hypothesis_stub import given, hnp, settings, st


@given(hnp.arrays(np.float32, st.integers(1, 64),
                  elements=st.floats(-100, 100, allow_nan=False, width=32)))
@settings(max_examples=50, deadline=None)
def test_quantize_bounded_error(g):
    from repro_torch.parallel.compress import dequantize, quantize_ef

    g = torch.from_numpy(g)
    q, scale, err = quantize_ef(g, torch.zeros_like(g))
    deq = dequantize(q, scale)
    assert float(torch.max(torch.abs(g - deq))) <= float(scale) * 0.5 + 1e-6
    np.testing.assert_allclose(err.numpy(), (g - deq).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_error_feedback_unbiased_over_time():
    from repro_torch.parallel.compress import dequantize, quantize_ef

    g = torch.from_numpy(np.random.default_rng(0).standard_normal(256)
                         .astype(np.float32))
    err = torch.zeros_like(g)
    applied = torch.zeros_like(g)
    for _ in range(50):
        q, s, err = quantize_ef(g, err)
        applied = applied + dequantize(q, s)
    np.testing.assert_allclose((applied / 50).numpy(), g.numpy(),
                               rtol=0.02, atol=0.02)


def test_wire_bytes_are_int8():
    from repro_torch.parallel.compress import quantize_ef

    g = torch.from_numpy(np.random.default_rng(1).standard_normal(1024)
                         .astype(np.float32))
    q, _, _ = quantize_ef(g, torch.zeros_like(g))
    assert q.dtype == torch.int8
    assert q.nbytes == g.nbytes // 4


def test_compressed_mean_single_axis(group1):
    from repro_torch.parallel.compress import compressed_psum_mean
    from repro_torch.parallel.sharding import make_mesh

    mesh = make_mesh((1,), ("pod",), device="cpu")
    g = {"w": torch.from_numpy(np.random.default_rng(2).standard_normal((1, 8))
                               .astype(np.float32))}
    e = {"w": torch.zeros(1, 8)}
    mean, _ = compressed_psum_mean(g, e, mesh, axis="pod")
    assert mean["w"].shape == (1, 8)
    np.testing.assert_allclose(mean["w"].numpy(), g["w"].numpy(),
                               atol=float(g["w"].abs().max()) / 100)


@pytest.mark.parametrize("seed", range(4))
def test_quantize_ef_bit_for_bit(seed):
    """``q`` and ``scale`` equal the reference's bit for bit over seeded
    inputs with a carried error; ``err`` within the reference test's own
    tolerance."""
    import jax.numpy as jnp

    from repro.parallel.compress import quantize_ef as ref_q
    from repro.transport.codec import quantize8_np as ref_np
    from repro_torch.parallel.compress import quantize8_np, quantize_ef

    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(1000) * 10 ** rng.uniform(-3, 3)).astype(np.float32)
    e = (rng.standard_normal(1000) * 0.01).astype(np.float32)
    q, s, err = quantize_ef(torch.from_numpy(g), torch.from_numpy(e))
    rq, rs, rerr = ref_q(jnp.asarray(g), jnp.asarray(e))
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert np.float32(s.item()).tobytes() == np.asarray(rs).tobytes()
    np.testing.assert_allclose(err.numpy(), np.asarray(rerr), rtol=1e-5,
                               atol=1e-6)
    a, b = quantize8_np(g), ref_np(g)
    assert a[0].tobytes() == b[0].tobytes() and a[1] == b[1]


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_mean_multi_rank(runs, n):
    """At n ranks the compressed mean is within one quantisation step of
    the reference's at n devices, equal on every rank, and the carried
    error is the reference's; with a different gradient on each rank it
    is within two steps of the exact mean."""
    ref, port = runs[n]
    step = float(np.abs(runs["inp"]["g"]).max()) / 127
    for r in port:
        np.testing.assert_allclose(r["compress/mean"].numpy(),
                                   ref["compress/mean"], rtol=0, atol=step)
        np.testing.assert_allclose(r["compress/err"].numpy(),
                                   ref["compress/err"], rtol=1e-5, atol=1e-6)
        assert torch.equal(r["compress/mean_ranks"],
                           port[0]["compress/mean_ranks"])
    g = runs["inp"]["g_ranks"][:n]
    exact = g.mean(axis=0)
    bound = 2 * float(np.abs(g).max()) / 127
    np.testing.assert_allclose(port[0]["compress/mean_ranks"].numpy(), exact,
                               rtol=0, atol=bound)


# ---------------------------------------------------------------------------
# pipeline


def test_pipeline_parallel_schedule_one_stage(group1):
    """n = 1: the reference's own test, and the reference's output."""
    import jax
    import jax.numpy as jnp

    from repro.parallel import sharding as RSH
    from repro.parallel.pipeline import pipeline_apply as ref_apply
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.parallel.sharding import make_mesh

    inp = {"ws": np.stack([np.eye(8, dtype=np.float32)]),
           "xs": np.random.default_rng(0).standard_normal((3, 4, 8))
           .astype(np.float32)}
    out = pipeline_apply(lambda w, x: x @ w, torch.from_numpy(inp["ws"]),
                         torch.from_numpy(inp["xs"]),
                         make_mesh((1,), ("pod",), device="cpu"), axis="pod")
    ref = ref_apply(lambda w, x: x @ w, jnp.asarray(inp["ws"]),
                    jnp.asarray(inp["xs"]),
                    RSH.make_mesh((1,), ("pod",), devices=jax.devices()[:1]),
                    axis="pod")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), inp["xs"] @ inp["ws"][0],
                               rtol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_parallel_schedule(runs, n):
    """n stages: every rank returns the stages applied in sequence
    (``tests/test_system.py:173-190``).  The reference refuses n > 1 at
    its final ``ppermute`` (one source, n destinations): ROADMAP
    divergence 17, pinned here."""
    ref, port = runs[n]
    assert "must be unique" in str(ref["pipeline/error"])
    inp = runs["inp"]
    want = inp["xs"]
    for i in range(n):
        want = np.einsum("mbd,de->mbe", want, inp["ws"][i])
    for r in port:
        np.testing.assert_allclose(r["pipeline"].numpy(), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# the MoE's expert-parallel paths


def _assemble(port, name):
    """The global output from the ranks' local ones (by batch shard; the
    ranks sharing a shard must agree exactly) and the aux (equal on all)."""
    shards = {}
    for r in port:
        e = r[f"moe/{name}"]
        if e["idx"] in shards:
            assert torch.equal(shards[e["idx"]], e["y"]), name
        shards[e["idx"]] = e["y"]
        assert torch.equal(e["aux"], port[0][f"moe/{name}"]["aux"])
    n = port[0][f"moe/{name}"]["n"]
    return torch.cat([shards[i] for i in range(n)]).numpy(), \
        float(port[0][f"moe/{name}"]["aux"])


@pytest.mark.parametrize("n,name", [(n, name) for n in (2, 4)
                                    for name in EP_CASES[n]])
def test_moe_ep_forward(runs, n, name):
    """Each expert-parallel path at n ranks within 2e-4 of the
    reference's ``moe_ffn`` under the same mesh and rules (output and
    load-balance loss) and, where nothing drops, of the dense fallback.
    At the published capacity factor copies drop, and the outputs equal
    the reference's, so its drops are the reference's."""
    from repro_torch.models import moe as M
    from repro_torch.models.config import ModelConfig

    ref, port = runs[n]
    shape, cfg_kw, _, xkey, keep = EP_CASES[n][name]
    y, aux = _assemble(port, name)
    np.testing.assert_allclose(y, ref[f"moe/{name}/y"], **TOL_EP)
    np.testing.assert_allclose(aux, ref[f"moe/{name}/aux"], **TOL_EP)
    drops = sum(r[f"moe/{name}"]["drops"] for r in port)
    if "drop" in name:
        assert drops > 0, name
        return
    assert drops == 0
    inp = runs["inp"]
    x = torch.from_numpy(inp[xkey])
    if keep:
        x = x[:, :keep]
    cfg = ModelConfig(**{**MOE_KW, **cfg_kw})
    y_dense, _ = M._moe_dense_fallback(_moe_params(inp), x, cfg)
    np.testing.assert_allclose(y, y_dense.numpy(), **TOL_EP)


@pytest.mark.parametrize("n,name", [(n, name) for n in (2, 4)
                                    for name in EP_CASES[n]])
def test_moe_ep_gradients_equal_reference(runs, n, name):
    """Each path's gradients of sum(y · w) + aux with respect to the
    expert weights, the router and x, summed over the ranks (and divided
    by the replicas of a batch shard), within relative L2 1e-5 of the
    reference's ``jax.grad`` through its ``shard_map`` at the same mesh
    (whose own gradients equal its dense fallback's: ROADMAP item 8)."""
    ref, port = runs[n]
    reps = n // port[0][f"moe/{name}"]["n"]
    for k in ("router", "we_gate", "we_up", "we_down"):
        got = sum(r[f"moe/{name}"]["dp"][k] for r in port) / reps
        want = torch.from_numpy(ref[f"moe/{name}/d{k}"])
        assert rel_l2(got, want) < TOL_GRAD, (k, rel_l2(got, want))
    shards = {}
    for r in port:
        e = r[f"moe/{name}"]
        shards[e["idx"]] = shards.get(e["idx"], 0) + e["dx"] / reps
    got = torch.cat([shards[i] for i in range(len(shards))])
    assert rel_l2(got, torch.from_numpy(ref[f"moe/{name}/dx"])) < TOL_GRAD


# ---------------------------------------------------------------------------
# gradients across ranks


def rel_l2(a, b):
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.clamp(torch.linalg.vector_norm(b.float()), min=1e-30))


@pytest.mark.parametrize("n,arch,mesh", [
    (n, arch, m) for n in (2, 4) for arch in GRAD_ARCHS
    for m in GRAD_MESHES[n]])
def test_ep_gradients(runs, n, arch, mesh):
    """The loss and every gradient of one train step, averaged over the
    ranks as the launcher does, within relative L2 1e-5 of world size 1
    on the global batch (f32): the MoE's collectives differentiate as
    their adjoints.  The MoE's load-balance term is left out (weight 0):
    the reference averages a per-shard statistic (``pmean`` of each
    shard's E·Σ f·p), which is not world size 1's value at any mesh."""
    from repro_torch.launch import train as LT
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    _, port = runs[n]
    cfg = grad_cfg(arch, **GRAD_MESHES[n][mesh][1])
    step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1,
                                          total_steps=10))
    params = LT.init_state(cfg, step, "cpu")["params"]
    loss, _, grads = step.grads(params, grad_batch(runs["inp"], 0))
    for r in port:
        got = r[f"grad/{arch}/{mesh}"]
        assert abs(float(got["loss"]) - float(loss)) <= TOL_GRAD * abs(float(loss))
        assert set(got["grads"]) == set(grads)
        for k, g in grads.items():
            assert rel_l2(got["grads"][k], g) < TOL_GRAD, (k, rel_l2(got["grads"][k], g))
    if cfg.num_experts:
        assert any(float(g.abs().max()) > 0 for k, g in grads.items()
                   if "we_" in k or "router" in k)


@pytest.mark.parametrize("n,arch,mesh,variant", [
    pytest.param(n, arch, m, v, id="-".join(map(str, (n, arch, m)))
                 + (f"-{v}" if v else ""))
    for n in (2, 4) for arch, m, v in step_cases(n)])
def test_two_sharded_steps(runs, n, arch, mesh, variant):
    """Two sharded launcher steps (DTensor state kept sharded through the
    step, batch shards, each gradient reduced to the rank's block, the
    optimizer on the blocks) from the seeded state equal two world-size-1
    steps: losses, parameters and optimizer moments within relative L2
    1e-5.  ``STEP_VARIANTS`` run AdamW and Adafactor, 1 and 2
    microbatches and remat ``none`` and ``block`` on every mesh.  The
    row-split variants put ``dp_fsdp``'s batch over ``model`` where it
    does not divide the rows (``SPLIT_ROWS``), with labels IGNORE
    unevenly: each rank of a ``model`` group runs its padded tile of a
    microbatch's rows (two ranks of four with none) and its share of the
    global batch's masked mean (``dp_fsdp_split_mb2`` on one batch
    shard).  The microbatch variants (``MB_ROWS``) split the batch over
    ``data`` in 2 microbatches with labels IGNORE unevenly: each rank's
    microbatch i is its block of the global batch's slice i, as world
    size 1's is that slice (``mb2_ignore_moe``: with its router's aux
    term on and copies dropping, its world size 1 routes each rank's
    tokens alone, :func:`world1_step`)."""
    from repro_torch.launch import train as LT
    from repro_torch.parallel import sharding as SH

    _, port = runs[n]
    cfg, opt, mb, _, bkey, rows = step_setup(arch, mesh, variant, n)
    shape = GRAD_MESHES[n][mesh][0]
    step = world1_step(cfg, opt, mb, variant, shape)
    state = LT.init_state(cfg, step, "cpu")
    losses = []
    for i in range(2):
        state, m = step(state, step_batch(runs["inp"], i, bkey, rows))
        losses.append(float(m["loss"]))
    if variant == "mb2_ignore_moe":
        assert sum(step.drops) > 0, step.drops
    want = state_wholes(state)
    assert any(k.startswith("opt.") for k in want)
    tiles = [r[f"steps/{arch}/{mesh}/{variant}"]["tile"] for r in port]
    if variant in SPLIT_ROWS:
        # each rank of a model group ran its padded tile of a microbatch's
        # rows: 2 + 1 of 3, or 1, 1 and two empty tiles of 2
        m = rows // shape[0] // mb
        assert tiles == [SH.tile(m, shape[1], r % shape[1])
                         for r in range(n)], tiles
        assert sum(w for _, w in tiles) == m * shape[0]
    else:
        assert tiles == [None] * n
    for r in port:
        got = r[f"steps/{arch}/{mesh}/{variant}"]
        assert got["step"] == 2
        for a, b in zip(got["losses"], losses):
            assert abs(float(a) - b) <= TOL_GRAD * abs(b)
        for k, v in want.items():
            assert rel_l2(got[k], v) < TOL_GRAD, (k, rel_l2(got[k], v))


def test_gather_sums_the_gradient_over_ranks(runs):
    """At 2 ranks, each multiplying the gathered leaf by weights of its
    own (as its batch shard would): a leaf split over ``data`` gathers to
    the whole leaf, and its backward gives each rank the block of the
    mean over ranks of the weights, summed over the ranks and not this
    rank's slice alone (what ``full_tensor()``'s default backward gives).
    A leaf with no split axis gathers nothing (its block's storage comes
    back) and its gradient is the mean too."""
    inp = runs["inp"]
    _, port = runs[2]
    mean = inp["gx"].mean(axis=0)
    for rank, r in enumerate(port):
        split, rep = r["gather"]["split"], r["gather"]["replicated"]
        sl = split["slices"]
        assert np.array_equal(split["full"].numpy(), inp["gw"])
        assert not split["aliased"]
        np.testing.assert_allclose(split["grad"].numpy(), mean[sl],
                                   rtol=1e-6, atol=1e-7)
        for sliced in (inp["gx"][rank][sl], inp["gx"][rank][sl] / 2):
            assert not np.allclose(split["grad"].numpy(), sliced)
        assert rep["aliased"]
        assert np.array_equal(rep["full"].numpy(), inp["gw"])
        np.testing.assert_allclose(rep["grad"].numpy(), mean, rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("n", [2, 4])
def test_reduce_scatter_is_the_sum_of_the_block(runs, n):
    """At ``n`` ranks, ``reduce_scatter`` along each dimension gives each
    rank its block of the sum over ranks, owning only the block's bytes,
    by the all-reduce route (gloo's) and by ``reduce_scatter_tensor``
    (NCCL's, run here through gloo), which agree."""
    xs = rs_inputs(n)
    total = xs.sum(0)
    _, port = runs[n]
    for rank, r in enumerate(port):
        got = r["reduce_scatter"]
        assert set(got) == {"all_reduce", "native"}
        for route, blocks in got.items():
            assert sorted(blocks) == list(range(total.dim()))
            for d, block in blocks.items():
                w = total.shape[d] // n
                want = total.narrow(d, rank * w, w)
                assert block.shape == want.shape, (route, d)
                torch.testing.assert_close(block, want, rtol=1e-6,
                                           atol=1e-6)
                assert block.is_contiguous()
                assert block.untyped_storage().nbytes() == \
                    block.numel() * block.element_size(), (route, d)


@pytest.mark.parametrize("n,case", [(n, i) for n in (2, 4)
                                    for i in range(len(A2A_CASES[n]))])
def test_all_to_all_is_the_exchange_and_its_adjoint(runs, n, case):
    """``MeshOps.all_to_all`` and ``AllToAll`` over a mesh axis (the
    whole world, and each axis of a (2, 2) mesh) at n gloo ranks: block j
    of each rank's result is block r of rank j's input (r its own place
    in the axis's group), as ``dist.all_to_all_single`` on the group
    gives; the backward is the same exchange of the cotangents, the
    forward's adjoint: the sum over ranks of <y, g> equals that of <x,
    dx>."""
    xs, gs = a2a_inputs(n)
    res = [r["all_to_all"][case] for r in runs[n][1]]
    lhs = rhs = 0.0
    for rank, got in enumerate(res):
        group = got["group"]
        m = len(group)
        me = group.index(rank)
        want = torch.cat([xs[j][:2 * m][2 * me:2 * me + 2] for j in group])
        want_g = torch.cat([gs[j][:2 * m][2 * me:2 * me + 2] for j in group])
        assert torch.equal(got["direct"], want)
        assert torch.equal(got["ops"], want)
        assert torch.equal(got["y"], want)
        assert torch.equal(got["gx"], want_g)
        lhs += float((got["y"] * gs[rank][:2 * m]).double().sum())
        rhs += float((xs[rank][:2 * m] * got["gx"]).double().sum())
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0), (lhs, rhs)


def test_gather_gradient_by_the_native_reduce_scatter(runs):
    """:func:`test_gather_sums_the_gradient_over_ranks`'s gathers with the
    gradient reduced by ``reduce_scatter_tensor`` (the NCCL route, forced
    on gloo): the same values and gradients as by the all-reduce route."""
    _, port = runs[2]
    for r in port:
        for name in ("split", "replicated"):
            a, b = r["gather"][name], r["gather/native"][name]
            assert torch.equal(a["full"], b["full"])
            torch.testing.assert_close(a["grad"], b["grad"], rtol=1e-6,
                                       atol=1e-7)
            assert a["aliased"] == b["aliased"]


def _memory_world_1(inp):
    """``mem_cfg``'s step at world size 1 under ``LiveBytes``: (its peak,
    the bytes of its arguments, of the state after it, its loss)."""
    from torch.utils import _pytree as pytree

    from repro_torch.launch import train as LT
    from repro_torch.launch.dryrun import LiveBytes
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    cfg = mem_cfg()
    step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1,
                                          total_steps=10), donate=True)
    state = LT.init_state(cfg, step, "cpu")
    batch = mem_batch(inp)
    mem = LiveBytes("cpu")
    args = sum(mem.track(t) for t in pytree.tree_leaves((state, batch)))
    with mem:
        state, m = step(state, batch)
    state_bytes = sum(t.nbytes for t in pytree.tree_leaves(state)
                      if isinstance(t, torch.Tensor))
    return mem.peak, args, state_bytes, float(m["loss"])


def test_sharded_step_memory_per_rank(runs):
    """At 4 ranks on a (4, 1) mesh, each rank's peak live storage bytes
    over one step of ``mem_cfg`` (its state shards and batch rows
    included) stay under half of world size 1's over the same step (the
    whole state and batch); every block, in the forward and in the remat
    recompute, runs with its own layer's gathered weights and no gathered
    weight of another super-block alive; the loss is world size 1's."""
    _check_memory(runs, "memory")


def test_tp_step_memory_per_rank(runs):
    """:func:`test_sharded_step_memory_per_rank` on a (1, 4) mesh, where
    ``model`` splits attention's heads, the MLP's hidden units and the
    vocabulary (tensor parallelism) and every rank runs the whole batch:
    each rank's peak under half of world size 1's, no gathered weight of
    another super-block alive at a block's start, world size 1's loss."""
    _check_memory(runs, "memory/tp")


def _check_memory(runs, key):
    _, port = runs[4]
    cfg = mem_cfg()
    peak, args, state_bytes, loss = _memory_world_1(runs["inp"])
    assert args > 2 * (peak - args), "the state must outweigh the step"
    layers = sorted([i] for i in range(cfg.n_super) for _ in range(2))
    for r in port:
        got = r[key]
        assert got["peak"] < peak / 2, (got["peak"], peak)
        assert got["args"] < state_bytes / 2
        assert not got["late"], got["late"]
        assert sorted(got["blocks"]) == layers, got["blocks"]
        assert abs(float(got["loss"]) - loss) <= TOL_GRAD * abs(loss)


@pytest.mark.parametrize("remat", ["block", "dots"])
def test_remat_recomputes_under_the_forward_mesh(group1, monkeypatch, remat):
    """A remat block's recompute runs the forward's expert-parallel path
    when the backward runs in another thread than the forward, as it does
    on the card (the autograd engine's device thread; the sharding context
    is thread-local): two ``all_to_all`` a MoE layer in each of the
    forward, the recompute and the backward, and gradients equal to those
    of a backward in the forward's thread."""
    import threading

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as MT
    from repro_torch.parallel import sharding as SH

    cfg = grad_cfg("qwen3_moe_30b_a3b", remat=remat)
    n_moe = sum(k == "attn_moe" for k in cfg.layer_kinds)
    params = {k: v.requires_grad_(True) for k, v in MT.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu").items()}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    mesh = make_host_mesh("cpu")
    calls, real = [], dist.all_to_all_single

    def counted(*a, **k):
        calls.append(threading.current_thread().name)
        return real(*a, **k)

    def loss():
        with SH.sharding_context(mesh):
            logits, _, aux = MT.forward(params, {"tokens": toks}, cfg)
        return logits.square().mean() + aux

    monkeypatch.setattr(dist, "all_to_all_single", counted)
    here = torch.autograd.grad(loss(), list(params.values()))
    assert len(calls) == 6 * n_moe
    del calls[:]
    out = {}
    l = loss()

    def backward():
        out["grads"] = torch.autograd.grad(l, list(params.values()))

    th = threading.Thread(target=backward, name="backward")
    th.start()
    th.join()
    assert calls.count("backward") == 4 * n_moe, calls
    assert len(calls) == 6 * n_moe
    for a, b in zip(out["grads"], here):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the sharded checkpoint


def _whole_state():
    from repro_torch.launch import train as LT
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    cfg = LT.reduced(PC.get_config("smollm_360m"))
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt)
    return cfg, opt, LT.init_state(cfg, step, "cpu")


def _bits(t):
    iv = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(iv[t.element_size()])


def test_sharded_save_equals_whole_save(runs, tmp_path):
    """A save of the DTensor state at world size 2 (each split leaf
    assembled on rank 0's host, rank 0 writing) is byte for byte a
    world-size-1 save of the same state, in the ranks' process and in
    this one; some leaves were split."""
    from torch.distributed.tensor import Shard

    from repro_torch.runtime.checkpoint import CheckpointManager

    _, port = runs[2]
    assert any(Shard(0) in p or Shard(1) in p
               for p in port[0]["placements"].values())
    _, _, whole = _whole_state()
    CheckpointManager(tmp_path).save(3, whole)
    for other in (runs["ckpt"] / "whole" / "step_3", tmp_path / "step_3"):
        cmp = filecmp.dircmp(runs["ckpt"] / "sharded" / "step_3", other)
        assert not cmp.left_only and not cmp.right_only
        for f in cmp.common_files:
            assert filecmp.cmp(pathlib.Path(cmp.left) / f, other / f,
                               shallow=False), f


def test_sharded_save_holds_no_whole_leaf(runs):
    """The world-size-2 save assembles each split leaf (params and both
    moments) in rank 0's host memory a few rows of each block at a time:
    while a rank takes part in one leaf's assembly, the tensors it makes
    (on its device; the CPU here, where the host buffer is a numpy array
    and the copies to it are views) stay under that leaf's bytes: no
    rank holds a whole leaf."""
    from torch.distributed.tensor import Shard

    _, port = runs[2]
    split = sum(any(isinstance(x, Shard) for x in p)
                for p in port[0]["placements"].values())
    for r in port:
        assert len(r["save_gathers"]) == 3 * split > 0
        for whole, peak, _ in r["save_gathers"]:
            assert peak < whole, (whole, peak)


def test_sharded_save_within_a_budget(runs):
    """At 4 ranks with ``SAVE_GATHER_BYTES`` under one leading-axis row of
    every rank's block for some leaves, the save sends parts of rows:
    the tensors a rank makes while it takes part in one leaf's assembly
    stay within the budget, and the files are byte for byte a
    world-size-1 save's."""
    _, port = runs[4]
    for r in port:
        rows = [row for _, _, row in r["budget_gathers"]]
        assert any(4 * row > SAVE_BUDGET for row in rows)
        assert any(4 * row <= SAVE_BUDGET for row in rows)
        for whole, peak, _ in r["budget_gathers"]:
            assert peak <= SAVE_BUDGET and peak < whole, (whole, peak)
    cmp = filecmp.dircmp(runs["ckpt"] / "budget" / "step_3",
                         runs["ckpt"] / "whole" / "step_3")
    assert not cmp.left_only and not cmp.right_only
    for f in cmp.common_files:
        assert filecmp.cmp(pathlib.Path(cmp.left) / f,
                           pathlib.Path(cmp.right) / f, shallow=False), f


@pytest.mark.parametrize("shape,item,world,budget", [
    ((48, 8, 128, 768), 4, 256, 1 << 28),   # Qwen3's f32 expert moment
    ((48, 8, 128, 768), 4, 2, 1 << 28),
    ((5, 7, 3), 2, 4, 100),
    ((1, 7), 4, 4, 1 << 20),
    ((3,), 4, 4, 1 << 20)])
def test_save_pieces_cover_the_block_within_the_budget(monkeypatch, shape,
                                                       item, world, budget):
    """``_pieces`` covers a block once, in pieces of which ``world`` + 1
    fit the budget and each is under half the block, rows split where a
    row of every rank does not fit (Qwen3-30B-A3B's f32 expert moment
    block at 256 ranks: 3 MiB a row, 768 MiB for 256 of them)."""
    from repro_torch.runtime import checkpoint as CK

    monkeypatch.setattr(CK, "SAVE_GATHER_BYTES", budget)
    pieces = CK._pieces(shape, item, world)
    cover = np.zeros(shape, np.int64)
    for sl in pieces:
        assert len(sl) == len(shape)
        cover[sl] += 1
    assert (cover == 1).all()
    size = max(int(cover[sl].size) for sl in pieces) * item
    assert (world + 1) * size <= budget
    assert size <= max(item, cover.size * item // 2)
    if shape[0] > 1 and world * item * cover[0].size > budget:
        assert all(sl[1].stop - sl[1].start < shape[1] for sl in pieces)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_restore_at_four_ranks(runs, shape):
    """The world-size-2 checkpoint restored at 4 ranks with ``placements``:
    each rank's local shard is its slice of the whole leaf, bit for bit,
    placed by the rules."""
    from repro_torch.parallel import sharding as SH

    _, _, whole = _whole_state()
    _, port = runs[4]
    names = ("data", "model")
    split = 0
    for r in port:
        got = r[f"restore/{shape}"]
        assert got["step"] == 0 and got["count"] == 0
        for key, (local, placements, spec) in got["leaves"].items():
            grp, name = key.split("/", 1)
            full = whole["params"][name] if grp == "params" else \
                whole["opt"]["m"][name]
            sh = SH.NamedSharding(SH.AbstractMesh(shape, names), spec,
                                  placements)
            want = full[sh.local_slices(full.shape, got["coord"])]
            assert torch.equal(_bits(local), _bits(want)), key
            split += local.shape != full.shape
    assert split > 0


@pytest.mark.parametrize("n", [2, 4])
def test_local_shards_hold_only_their_bytes(runs, n):
    """Every rank's local shard of a placed, stepped or restored state
    owns only its own bytes: no view keeps the whole leaf's storage alive
    (world size 2: the placed state and two sharded steps' state; 4: both
    restores and the steps' state); some leaves are split."""
    _, port = runs[n]
    split = 0
    for r in port:
        cases = [k for k, v in r.items()
                 if isinstance(v, dict) and "storage" in v]
        assert len(cases) >= (3 if n == 4 else 2)
        for case in cases:
            for path, (storage, own, whole) in r[case]["storage"].items():
                assert storage == own, (case, path, storage, own)
                split += own < whole
    assert split > 0


def test_restore_at_one_rank(runs, group1):
    """The world-size-2 checkpoint restored at world size 1: with
    placements, DTensors whose whole is the saved leaf bit for bit; and
    without, the tensors themselves."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as SH
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.train.step import train_state_specs

    cfg, opt, whole = _whole_state()
    shapes, axes = train_state_specs(cfg, opt)
    mesh = make_host_mesh("cpu")
    cm = CheckpointManager(runs["ckpt"] / "sharded")
    back = cm.restore(LT.state_template(shapes),
                      placements=SH.tree_shardings(axes, shapes, mesh))
    plain = cm.restore(LT.state_template(shapes), device="cpu", verify=True)
    for k, v in whole["params"].items():
        assert isinstance(back["params"][k], DTensor)
        assert torch.equal(_bits(back["params"][k].full_tensor()), _bits(v))
        assert torch.equal(_bits(plain["params"][k]), _bits(v))
    assert back["step"] == plain["step"] == 0


if __name__ == "__main__":
    _rank_main()
