"""Train step: masked LM loss, microbatched gradient accumulation,
AdamW/Adafactor — the reference's ``repro.train.step`` in PyTorch.

The state is ``{"params": {...}, "opt": {...}, "step": int}``.  A step
takes the gradient of the loss with ``torch.autograd.grad`` with respect
to detached copies of the parameters (the caller's tensors are never
marked ``requires_grad``), then applies the functional optimizer update
under ``torch.no_grad()`` and returns a new state.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.transformer import TensorSpec
from repro_torch.parallel import sharding as SH
from repro_torch.train import optim as O

TrainState = dict[str, Any]  # {"params": …, "opt": …, "step": int}

IGNORE = -100


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_weight: float = 1e-4, vocab: SH.TPGroup | None = None,
                  vocab_size: int | None = None,
                  ranks: SH.MeshOps | None = None):
    """logits [B,S,V] f32, labels [B,S] integers (IGNORE = masked).
    Returns (loss with the z-loss, mean cross-entropy).  With ``vocab``
    (``parallel.sharding.TPGroup``) the logits are this rank's padded
    tile (``TPGroup.block``) of a vocabulary of ``vocab_size``, the
    group's tiles in rank order (vocab-parallel,
    :class:`_VocabParallel`); the mask and denominator are the same.
    With ``ranks`` (the ``MeshOps`` of a rank's shards) both are the
    rank's share of the global batch's masked means: its masked sums
    over :func:`rank_share`'s denominator, so that the mean over ranks,
    of the values and of the gradients, is the global batch's however
    its rows fall (a rank's rows may be few, or none)."""
    labels = torch.as_tensor(labels, device=logits.device)
    mask = (labels != IGNORE).float()
    labels_c = torch.clamp(labels, min=0).long()
    if vocab is None:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    else:
        if vocab_size is None:
            raise ValueError("a vocab-parallel cross-entropy needs the "
                             "vocabulary's size")
        lse, picked = _VocabParallel.apply(logits, labels_c, vocab,
                                           vocab_size)
    ll = picked - lse
    denom = (torch.clamp(mask.sum(), min=1.0) if ranks is None
             else rank_share(mask.sum(), ranks))
    ce = -(ll * mask).sum() / denom
    zl = z_weight * torch.square(lse * mask).sum() / denom
    return ce + zl, ce


def rank_share(count: torch.Tensor, ops: SH.MeshOps) -> torch.Tensor:
    """The denominator of a rank's share of a mean over every rank's
    items: ``count`` (this rank's items, 0-d) summed over every rank with
    no gradient, clamped to 1, over the rank count.  A sum over this
    rank's items divided by it, averaged over the ranks, is the mean over
    all items, and so is its gradient averaged over the ranks
    (``MeshOps.reduce`` divides by the rank count); ranks that hold the
    same items (a ``model`` group splitting a product) count them once
    each, which the sum's copies cancel.  Under the dry run's collectives,
    which move nothing, the share is ``count`` over the rank count: the
    mean over ranks reads the rank's own mean."""
    with torch.no_grad():
        total = ops.sum_over(count.detach().float().clone(), list(ops.sizes))
    return torch.clamp(total, min=1.0) / ops.n


class _VocabParallel(torch.autograd.Function):
    """(log-sum-exp over the whole vocabulary, the label's logit) from
    this rank's tile of the logits: the tile's max taken over the group
    (it shifts the exponentials and has no gradient: the log-sum-exp's
    derivative is the softmax whatever the shift), the sum of exp(logit
    - max) summed over the group, and the label's logit where the label
    falls in the tile, 0 elsewhere, summed over it.  An empty tile (a
    trailing rank of a padded split) adds a max of -inf, a sum of 0 and
    no label.  One function, so that the logits' gradient is one tensor:
    exp(logit - max) (kept from the forward, the only tensor of the
    tile's size it keeps) times the cotangent of the sum, plus the
    label's cotangent at its place, where autograd would keep the logits
    and add two gradients.  Each sum over the group has its exact
    adjoint in the backward, the same sum of the cotangents."""

    @staticmethod
    def forward(ctx, logits, labels, tp, vocab_size):
        start, w = tp.block(vocab_size)
        if logits.shape[-1] != w:
            raise ValueError(f"logits over {logits.shape[-1]} words, not "
                             f"rank {tp.index}'s tile of {w} of "
                             f"{vocab_size}")
        mx = tp.max_(logits.amax(dim=-1) if w else logits.new_full(
            logits.shape[:-1], float("-inf")))
        e = logits.sub(mx[..., None]).exp_()
        total = tp.ops.sum_over(e.sum(dim=-1), (SH.TP_AXIS,))
        local = labels - start
        inside = (local >= 0) & (local < w)
        local = torch.where(inside, local, 0)[..., None]
        got = (torch.where(inside, torch.gather(logits, -1, local)[..., 0],
                           0.0) if w else torch.zeros_like(mx))
        ctx.tp = tp
        ctx.save_for_backward(e, total, local, inside)
        return (torch.log(total) + mx,
                tp.ops.sum_over(got, (SH.TP_AXIS,)))

    @staticmethod
    def backward(ctx, g_lse, g_label):
        e, total, local, inside = ctx.saved_tensors
        sum_over = ctx.tp.ops.sum_over
        g_e = sum_over(g_lse / total, (SH.TP_AXIS,))
        g_label = sum_over(g_label.clone(), (SH.TP_AXIS,))
        g = e * g_e[..., None]
        if g.shape[-1]:
            g.scatter_add_(-1, local,
                           torch.where(inside, g_label, 0.0)[..., None])
        return g, None, None, None


def make_loss_fn(cfg: ModelConfig):
    """``loss_fn(params, batch, split=None) -> (loss, {"ce", "aux"})``.
    Where ``params`` are a rank's shards, the cross-entropy is the rank's
    share of the global batch's masked mean (:func:`rank_share`), and the
    router's aux loss every rank's (``models/moe.py``).  ``split``
    (``parallel.sharding.row_group``'s) runs the rank's tile of the
    batch's rows alone."""
    def loss_fn(params: dict, batch: dict, split: SH.TPGroup | None = None):
        ops = SH.leaf_ops(params)
        rows = None
        if split is not None:
            batch = {k: torch.as_tensor(v) for k, v in batch.items()}
            rows = (split, batch["labels"].shape[0])
            batch = {k: split.cut(v) for k, v in batch.items()}
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        logits, _, aux = T.forward(params, inputs, cfg, mode="train",
                                   rows=rows)
        loss, ce = cross_entropy(logits, batch["labels"],
                                 vocab=T.head_split(params, cfg),
                                 vocab_size=cfg.vocab_size, ranks=ops)
        loss = loss + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux}
    return loss_fn


def _split(x, n: int) -> list:
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch of {b} does not split into {n} microbatches")
    return [x[i * (b // n):(i + 1) * (b // n)] for i in range(n)]


def _requiring_grad(v):
    """A detached copy of a leaf (of a shard's block) that requires grad."""
    if isinstance(v, SH.ShardedLeaf):
        return v.with_local(v.local.detach().requires_grad_(True))
    return v.detach().requires_grad_(True)


def make_train_step(cfg: ModelConfig, opt_cfg: O.OptConfig,
                    microbatches: int = 1, *, donate: bool = False):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``tokens`` and ``labels`` ([B,S]; tensors or numpy
    arrays, moved to the parameters' device), and ``ext_embed`` where the
    model takes one.  ``microbatches > 1`` runs the forward and backward
    once per slice of the batch and accumulates f32 gradients, each
    divided by the count; loss and extras are averaged.  Live activation
    memory drops by the microbatch factor.

    ``donate=True`` hands the state over to the step, as the reference's
    launcher donates it to the jitted step (``donate_argnums=0``): the
    optimizer frees each leaf's old params and moments as it updates the
    leaf, so that the update holds one leaf twice instead of the whole
    state, and the caller must not use the old state again.  The numbers
    are the same either way.

    The step carries its ``microbatches`` and three helpers:
    ``init_opt(params)``, the optimizer state; ``grads(params, batch,
    split=None) -> (loss, extras, grads)``, the accumulated gradients the
    step would apply (``split``: each microbatch's tile of the rows alone,
    see :func:`make_loss_fn`); and ``apply(state, loss, extras, grads,
    shards=None) -> (state, metrics)``, the step's update from them.  The
    sharded launcher hands ``grads`` a rank's shards
    (``parallel.sharding.ShardedLeaf``) and gets each gradient back as the
    block of the mean over ranks (the gathers' backward reduces it);
    ``apply`` then updates the local blocks, ``shards``
    (``parallel.sharding.StateShards``) summing over ranks where the
    optimizer reduces over a whole leaf.  Over microbatches, each one's
    gradient is reduced over the ranks first, then cast to f32, divided
    by the count and added to the accumulator, in microbatch order.
    """
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    loss_fn = make_loss_fn(cfg)
    try:
        upd_init, upd_fn = {
            "adamw": (O.adamw_init, O.adamw_update),
            "adafactor": (O.adafactor_init, O.adafactor_update),
        }[opt_cfg.name]
    except KeyError:
        raise ValueError(f"unknown optimizer {opt_cfg.name!r} "
                         "(adamw | adafactor)") from None

    def grads_of(params: dict, batch: dict, split=None):
        leaves = {k: _requiring_grad(v) for k, v in params.items()}
        with torch.enable_grad():
            loss, extras = loss_fn(leaves, batch, split)
            grads = torch.autograd.grad(
                loss, [SH.local_of(v) for v in leaves.values()],
                allow_unused=True)
        grads = {k: (torch.zeros_like(SH.local_of(p)) if g is None else g)
                 for (k, p), g in zip(leaves.items(), grads)}
        return loss.detach(), {k: v.detach() for k, v in extras.items()}, grads

    def accumulate(params: dict, batch: dict, split=None):
        if microbatches == 1:
            return grads_of(params, batch, split)
        local = {k: SH.local_of(v) for k, v in params.items()}
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in local.items()}
        del local
        parts = {k: _split(v, microbatches) for k, v in batch.items()}
        losses, extras = [], []
        for i in range(microbatches):
            loss, ex, grads = grads_of(
                params, {k: v[i] for k, v in parts.items()}, split)
            with torch.no_grad():
                for k, g in grads.items():
                    acc[k].add_(g.float() / microbatches)
            losses.append(loss)
            extras.append(ex)
            del grads
        loss = torch.stack(losses).mean()
        ex = {k: torch.stack([e[k] for e in extras]).mean() for k in extras[0]}
        return loss, ex, acc

    def apply(state: TrainState, loss, extras: dict, grads: dict,
              shards=None):
        with torch.no_grad():
            new_params, new_opt, om = upd_fn(state["params"], grads,
                                             state["opt"], opt_cfg,
                                             donate=donate, shards=shards)
        step = state["step"] + 1
        metrics = {"loss": loss, **extras, **om, "step": step}
        return {"params": new_params, "opt": new_opt, "step": step}, metrics

    def train_step(state: TrainState, batch: dict):
        loss, extras, grads = accumulate(state["params"], batch)
        return apply(state, loss, extras, grads)

    train_step.init_opt = lambda params: upd_init(params, opt_cfg)
    train_step.microbatches = microbatches
    train_step.grads = accumulate
    train_step.apply = apply
    return train_step


# ---------------------------------------------------------------------------
# specs — shapes, types and logical axes of the whole state


def train_state_specs(cfg: ModelConfig, opt_cfg: O.OptConfig):
    """(shapes, axes) of the train state: ``TensorSpec`` leaves, and the
    logical axes of each (the reference's, for the launchers' sharding)."""
    p_shapes = T.param_shapes(cfg)
    p_axes = T.param_axes(cfg)
    count = TensorSpec((), torch.int32)
    if opt_cfg.name == "adafactor":
        def fac_shape(sd):
            if len(sd.shape) >= 2:
                return {"vr": TensorSpec(sd.shape[:-1], torch.float32),
                        "vc": TensorSpec(sd.shape[:-2] + sd.shape[-1:],
                                         torch.float32)}
            return {"v": TensorSpec(sd.shape, torch.float32)}

        def fac_axes(ax):
            if len(ax) >= 2:
                return {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
            return {"v": ax}

        opt_shapes = {"f": {k: fac_shape(v) for k, v in p_shapes.items()},
                      "count": count}
        opt_axes = {"f": {k: fac_axes(v) for k, v in p_axes.items()},
                    "count": ()}
    else:
        sdt = torch_dtype(opt_cfg.state_dtype)
        mv = {k: TensorSpec(v.shape, sdt) for k, v in p_shapes.items()}
        opt_shapes = {"m": mv, "v": dict(mv), "count": count}
        opt_axes = {"m": dict(p_axes), "v": dict(p_axes), "count": ()}
    shapes = {"params": p_shapes, "opt": opt_shapes, "step": count}
    axes = {"params": p_axes, "opt": opt_axes, "step": ()}
    return shapes, axes


def metrics_axes():
    return {"loss": (), "ce": (), "aux": (), "grad_norm": (), "lr": (),
            "step": ()}
