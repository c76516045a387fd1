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
from repro_torch.train import optim as O

TrainState = dict[str, Any]  # {"params": …, "opt": …, "step": int}

IGNORE = -100


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_weight: float = 1e-4):
    """logits [B,S,V] f32, labels [B,S] integers (IGNORE = masked).
    Returns (loss with the z-loss, mean cross-entropy)."""
    labels = torch.as_tensor(labels, device=logits.device)
    mask = (labels != IGNORE).float()
    labels_c = torch.clamp(labels, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels_c[..., None])[..., 0] - lse
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = -(ll * mask).sum() / denom
    zl = z_weight * torch.square(lse * mask).sum() / denom
    return ce + zl, ce


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params: dict, batch: dict):
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        logits, _, aux = T.forward(params, inputs, cfg, mode="train")
        loss, ce = cross_entropy(logits, batch["labels"])
        loss = loss + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux}
    return loss_fn


def _split(x, n: int) -> list:
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch of {b} does not split into {n} microbatches")
    return [x[i * (b // n):(i + 1) * (b // n)] for i in range(n)]


def make_train_step(cfg: ModelConfig, opt_cfg: O.OptConfig,
                    microbatches: int = 1):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``tokens`` and ``labels`` ([B,S]; tensors or numpy
    arrays, moved to the parameters' device), and ``ext_embed`` where the
    model takes one.  ``microbatches > 1`` runs the forward and backward
    once per slice of the batch and accumulates f32 gradients, each
    divided by the count; loss and extras are averaged.  Live activation
    memory drops by the microbatch factor.

    The step carries two helpers: ``init_opt(params)``, the optimizer
    state, and ``grads(params, batch) -> (loss, extras, grads)``, the
    accumulated gradients the step would apply.
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

    def grads_of(params: dict, batch: dict):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            loss, extras = loss_fn(leaves, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = {k: (torch.zeros_like(p) if g is None else g)
                 for (k, p), g in zip(leaves.items(), grads)}
        return loss.detach(), {k: v.detach() for k, v in extras.items()}, grads

    def accumulate(params: dict, batch: dict):
        if microbatches == 1:
            return grads_of(params, batch)
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()}
        parts = {k: _split(v, microbatches) for k, v in batch.items()}
        losses, extras = [], []
        for i in range(microbatches):
            loss, ex, grads = grads_of(params, {k: v[i] for k, v in parts.items()})
            with torch.no_grad():
                for k, g in grads.items():
                    acc[k].add_(g.float() / microbatches)
            losses.append(loss)
            extras.append(ex)
            del grads
        loss = torch.stack(losses).mean()
        ex = {k: torch.stack([e[k] for e in extras]).mean() for k in extras[0]}
        return loss, ex, acc

    def train_step(state: TrainState, batch: dict):
        params = state["params"]
        loss, extras, grads = accumulate(params, batch)
        with torch.no_grad():
            new_params, new_opt, om = upd_fn(params, grads, state["opt"],
                                             opt_cfg)
        step = state["step"] + 1
        metrics = {"loss": loss, **extras, **om, "step": step}
        return {"params": new_params, "opt": new_opt, "step": step}, metrics

    train_step.init_opt = lambda params: upd_init(params, opt_cfg)
    train_step.grads = accumulate
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
