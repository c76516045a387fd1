"""Production-style train entry: mesh + sharded state + elastic loop — the
reference's ``repro.launch.train`` in PyTorch.

Every rank holds the train state as DTensors placed by the logical-axis
rules (``parallel.sharding.tree_shardings``) and takes its own shard of
the batch (``data.Loader(shard_id=<its place along the batch axes>)``).
A step is the counterpart of the reference's ``jax.jit(step_fn,
in_shardings=(state_sh, None), out_shardings=(state_sh, None),
donate_argnums=0)`` under GSPMD's FSDP placements, and keeps the state
sharded throughout: the forward gathers each super-block's weights just
before the block runs and drops them after (``models/transformer.py``;
the MoE keeps its experts split over ``model``), each gather's backward
lands the gradient in the rank's block (the sum over ranks divided by
their count, ``parallel.sharding.MeshOps``), and the optimizer updates
only the local blocks (``parallel.sharding.StateShards`` for its sums over
whole leaves).  The loss and its extras are averaged over every rank.
The state is donated: the step empties the dicts it was given.  At world
size 1 this is ``make_train_step``'s step, bit for bit.  Where the rules
put the batch over ``model`` (``dp_fsdp``, ``dp_all``, ``attn_dp``) and
``model`` does not divide the global batch, each rank of a ``model``
group runs only its padded tile of its shard's rows, a microbatch at a
time (``parallel.sharding.row_group``; trailing tiles short or empty, a
rank with none still running every collective of the step), and each
rank's loss is its share of the global batch's masked mean.  A
microbatch is a slice of the global batch, as in the reference: with
more than one, the ranks exchange their shards' rows first, so that each
holds its block of every slice (``parallel.sharding.microbatch_rows``).
Where a leaf's spec splits its product over ``model`` and the rules'
batch leaves ``model`` out (``baseline``'s ``heads``, ``kv_heads``,
``ffn`` and ``vocab``), the ranks of a ``model`` group split the product
(tensor parallelism, ``parallel.sharding.tp_group``): each runs its
batch shard through its block of attention's heads, of the MLPs' hidden
units and of the vocabulary (its logits and the vocab-parallel
cross-entropy), the partial outputs summed over the group.  The heads
and the vocabulary split so also where ``model`` does not divide them,
in padded tiles cut from the weights gathered whole
(``parallel.sharding.tile_group``).  Everything else (the RG-LRU's and
the SSD's own leaves where ``model`` does not split them all, rules that
put the batch over ``model``) runs with a layer's weights whole.

Auto-resume through ``CheckpointManager.restore(placements=)``, the
straggler tracker and the reference's checkpoint cadence and log lines.
On the card, attention runs the flash kernels (``attn_impl="flash"``).
``main`` returns the run's losses and step times (s, each step's loss
read back), the final state and the mesh; it tears down the process
group only if it started it.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \
        --mesh host                                  # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \
        --mesh host --reduced --device cpu --steps 10
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import configs as C
from repro_torch.data import Loader, TokenDataset
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import StragglerMitigator
from repro_torch.train import step as ST
from repro_torch.train.optim import OptConfig


def reduced(cfg):
    """The reduced config of the same family that the reference's smoke
    tests use (``tests/test_models.py::reduced``), copied: the port
    imports nothing of the reference's tests."""
    pat = cfg.block_pattern
    n_layers = max(len(pat) * 2, 2)
    kw = dict(
        num_layers=n_layers + (1 if cfg.trailing else 0),
        d_model=64, d_ff=128 if cfg.d_ff else 0, vocab_size=512,
        num_heads=4, num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16, q_chunk=16, ssm_chunk=8,
    )
    if cfg.num_experts:
        kw.update(num_experts=8, experts_per_token=min(cfg.experts_per_token, 2),
                  moe_d_ff=32)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16)
    if cfg.attn_window:
        kw.update(attn_window=8)
    if cfg.lru_width:
        kw.update(lru_width=64)
    if cfg.ext_embed_len:
        kw.update(ext_embed_len=5)
    return cfg.with_(**kw)


def reduced_cfg(cfg):
    return reduced(cfg)


def train_config(arch: str, reduce: bool, device):
    """The launcher's model config: ``arch``'s (``reduced_cfg`` of it with
    ``--reduced``); on the card, attention runs the hand-written flash
    kernels."""
    cfg = C.get_config(arch)
    if reduce:
        cfg = reduced_cfg(cfg)
    if resolve_device(device).type == "cuda":
        cfg = cfg.with_(attn_impl="flash")
    return cfg


def opt_config(steps: int) -> OptConfig:
    return OptConfig(lr=1e-3, warmup_steps=10, total_steps=max(steps, 100))


# ---------------------------------------------------------------------------
# the sharded state


def batch_shard(mesh) -> tuple[int, int]:
    """(this rank's index, their count) along the current rules' batch axes
    present in ``mesh``: ranks that differ only along other axes share a
    shard."""
    ops = SH.MeshOps(mesh)
    axes = SH.batch_axes(ops, None)
    return ops.index(axes), math.prod(ops.sizes[a] for a in axes)


def state_template(shapes):
    """A restore template of the train state: ``meta`` tensors, and the
    int32 scalars (``step``, the optimizer's ``count``) as the port's
    Python ints."""
    if isinstance(shapes, dict):
        return {k: state_template(v) for k, v in shapes.items()}
    if tuple(shapes.shape) == () and shapes.dtype == torch.int32:
        return 0
    return torch.empty(shapes.shape, dtype=shapes.dtype, device="meta")


def place(state, shardings):
    """``state`` (whole tensors, the same on every rank) as DTensors placed
    by ``shardings``; ints stay ints."""
    if isinstance(state, dict):
        return {k: place(v, shardings[k]) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return SH.distribute(state, shardings)
    return state


def to_local(state):
    """Every DTensor leaf of ``state`` as its local block (other leaves as
    they are), the dicts emptied as they are read (the state is
    donated)."""
    if isinstance(state, dict):
        out = {k: to_local(v) for k, v in state.items()}
        state.clear()
        return out
    if isinstance(state, torch.Tensor) and hasattr(state, "to_local"):
        return state.to_local()
    return state


def from_local(state, shardings):
    """``state`` of local blocks as DTensors placed by ``shardings``."""
    if isinstance(state, dict):
        return {k: from_local(v, shardings[k]) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return SH.from_local(state, shardings)
    return state


def _mean_over_ranks(x: torch.Tensor, n: int | None = None,
                     all_reduce=None) -> torch.Tensor:
    """The f32 mean of ``x`` over every rank (``x`` itself, widened, at
    world size 1).  ``n`` and ``all_reduce`` default to the process
    group's size and ``dist.all_reduce``; the dry run passes its mesh's
    size and a reduction that moves nothing."""
    x = x.float()
    n = dist.get_world_size() if n is None else n
    if n == 1:
        return x
    x = x.clone()
    (all_reduce or dist.all_reduce)(x)
    return x / n


def make_sharded_step(step_fn, mesh, state_sh, *, ops=None,
                      place=from_local, mean=_mean_over_ranks,
                      rows: int | None = None):
    """The sharded counterpart of ``step_fn`` (a ``make_train_step`` step):
    ``(state of DTensors, this rank's batch) -> (state of DTensors,
    metrics)``, the state sharded by ``state_sh`` throughout (see the
    module).  Each parameter goes to the forward as a
    ``parallel.sharding.ShardedLeaf`` of its local block; the gathers'
    backward sums each gradient over the ranks that hold its block and
    divides it by the rank count, and each rank's loss is its share of
    the global batch's masked mean (``train/step.py``'s ``rank_share``),
    so that ranks sharing a batch shard (along ``model``: the same rows;
    partial-sum gradients of the MoE's experts, ``models/moe.py``, and of
    the products split over ``model``, each rank's own block's) and ranks
    on other shards together give the global batch's gradient, in the
    block.  The loss and its extras are averaged over every rank: the
    global batch's.  ``rows`` is the global batch's rows, of which the
    rank is handed its shard under the batch's spec (None: its block over
    every batch axis, as :func:`batch_shard` gives the loader); where the
    rules put the batch over ``model`` and ``model`` does not divide
    ``rows`` (``parallel.sharding.row_group``), each rank of a ``model``
    group runs its padded tile of each microbatch's rows, maybe short or
    empty.  With more than one microbatch, the rank's rows are first
    exchanged over the axes that split the batch
    (``parallel.sharding.microbatch_rows``), so that microbatch i is the
    rank's block of the global batch's i-th slice, as in the reference's
    step; a padded tile of rows is then cut from that block.  At one rank
    nothing is gathered or reduced: the local blocks are the whole
    leaves.  The step runs under ``mesh`` and the rules
    current when it was made.  ``ops`` (``parallel.sharding.MeshOps`` over
    ``mesh`` by default), ``place`` and ``mean`` are its collectives and
    pieces; the dry run (``launch/dryrun.py``) runs the same step with its
    own, on local tensors (which ``to_local`` passes as they are)."""
    rules = SH.current_rules()
    ops = SH.MeshOps(mesh) if ops is None else ops
    shards = SH.StateShards(ops, state_sh) if ops.n > 1 else None
    with SH.sharding_context(mesh, rules):
        split = SH.row_group(ops if ops.n > 1 else None, rows)
        axes = SH.batch_axes(ops, rows)
    n_mb = step_fn.microbatches

    def sharded_step(state, batch):
        st = to_local(state)
        params = SH.sharded_leaves(st["params"], state_sh["params"], ops)
        if n_mb > 1 and axes:
            dev = SH.local_of(next(iter(params.values()))).device
            batch = {k: SH.microbatch_rows(torch.as_tensor(v, device=dev),
                                           ops, axes, n_mb)
                     for k, v in batch.items()}
        with SH.sharding_context(mesh, rules):
            loss, extras, grads = step_fn.grads(params, batch, split=split)
        del params
        loss = mean(loss)
        extras = {k: mean(v) for k, v in extras.items()}
        new, metrics = step_fn.apply(st, loss, extras, grads, shards=shards)
        del st, grads
        return place(new, state_sh), metrics

    return sharded_step


def init_state(cfg, step_fn, device, seed: int = 0):
    """The whole initial state on every rank, from one seed."""
    dev = resolve_device(device)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           dev)
    return {"params": params, "opt": step_fn.init_opt(params), "step": 0}


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--mesh", default="host", choices=["host", "pod", "multipod"])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the arch for CPU smoke runs")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = train_config(args.arch, args.reduced, dev)
    fresh = not dist.is_initialized()
    if args.mesh == "host":
        mesh = make_host_mesh(dev)
    else:
        mesh = make_production_mesh(multi_pod=args.mesh == "multipod",
                                    device=dev)
    rank = dist.get_rank()
    opt_cfg = opt_config(args.steps)
    step_fn = ST.make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                                 donate=True)

    with SH.sharding_context(mesh):
        shapes, axes = ST.train_state_specs(cfg, opt_cfg)
        state_sh = SH.tree_shardings(axes, shapes, mesh)

        cm = CheckpointManager(args.ckpt, keep=2)
        if cm.latest_step() is not None:
            state = cm.restore(state_template(shapes), placements=state_sh)
            print(f"resumed from step {int(state['step'])}")
        else:
            state = place(init_state(cfg, step_fn, dev), state_sh)

        jstep = make_sharded_step(step_fn, mesh, state_sh)

        ds = TokenDataset(cfg.vocab_size, seed=0)
        shard_id, n_shards = batch_shard(mesh)
        loader = Loader(ds, shard_id=shard_id, n_shards=n_shards,
                        batch_per_shard=args.batch, seq_len=args.seq,
                        start_step=int(state["step"]))
        strag = StragglerMitigator()
        losses, times = [], []
        try:
            for _ in range(args.steps):
                t0 = time.time()
                _, batch = next(loader)
                state, m = jstep(state, batch)
                s = int(m["step"])
                losses.append(float(m["loss"]))     # waits for the step
                times.append(time.time() - t0)
                strag.record(f"w{rank}", times[-1])
                if s % args.ckpt_every == 0:
                    cm.save(s, state, blocking=False)
                if s % 5 == 0 or s == 1:
                    print(f"step {s:4d} loss={float(m['loss']):.4f} "
                          f"gnorm={float(m['grad_norm']):.3f} "
                          f"({time.time() - t0:.2f}s)")
            cm.wait()
            cm.save(int(state["step"]), state, blocking=True)
        finally:
            loader.close()
        print(f"done; checkpoints: {cm.steps()}; stragglers: {strag.stragglers()}")
    out = {"losses": losses, "times": times, "state": state, "mesh": mesh}
    if fresh:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
