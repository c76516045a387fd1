"""Optimizers and LR schedules (AdamW with optional bf16 state,
Adafactor-lite, WSD / cosine schedules) — the reference's
``repro.train.optim`` in PyTorch.

State is a dict of tensors that mirrors the params dict (plus a step
``count``).  The updates are functional, as in the reference: they return
new params and a new state and leave their inputs untouched.  Call them
under ``torch.no_grad()`` (the train step does) so that nothing records
the arithmetic.  With ``donate=True`` the caller hands its params,
gradients and state over, as the reference's launcher donates the train
state to its jitted step (``donate_argnums=0``): each leaf's old tensors
leave their dicts as soon as the leaf is updated, so that the update
holds one leaf twice instead of the whole state; the numbers are the
same.

With ``shards`` (``parallel.sharding.StateShards``) the params, gradients
and moments are a rank's blocks of the leaves, as the sharded launcher
keeps them through its step.  The elementwise arithmetic runs on the
blocks as it stands; each reduction over a whole leaf (AdamW's global
norm, Adafactor's row, column and RMS means) is the blocks' partial sums
added over the ranks that split the leaf, as GSPMD computes it for the
reference.  Without ``shards`` every leaf is whole.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.config import torch_dtype


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"             # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"    # "bfloat16" halves the optimizer's memory
    schedule: str = "cosine"        # cosine | wsd | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1         # WSD: trailing fraction spent decaying


def lr_at(cfg: OptConfig, step) -> float:
    """Schedule value at ``step``."""
    step = float(step)
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    if cfg.schedule == "wsd":
        # warmup -> stable -> decay (MiniCPM): a linear decay tail to 10%
        decay_start = cfg.total_steps * (1.0 - cfg.decay_frac)
        frac = (step - decay_start) / max(cfg.total_steps - decay_start, 1.0)
        return cfg.lr * warm * (1.0 - min(max(frac, 0.0), 1.0) * 0.9)
    if cfg.schedule != "cosine":
        raise ValueError(f"unknown schedule {cfg.schedule!r} "
                         "(cosine | wsd | constant)")
    t = min(max(step / cfg.total_steps, 0.0), 1.0)
    return cfg.lr * warm * (0.5 * (1.0 + math.cos(math.pi * t)))


# ---------------------------------------------------------------------------
# AdamW


def adamw_init(params: dict, cfg: OptConfig) -> dict:
    dt = torch_dtype(cfg.state_dtype)
    return {"m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "count": 0}


def _leaves(params: dict, grads: dict, state: tuple, donate: bool):
    """(key, param, grad, *state leaves) for each leaf of ``params``, each
    ``state`` a dict keyed alike; ``donate`` pops every leaf out of its
    dict as it is handed out, so that nothing else holds it."""
    for k in list(params):
        take = dict.pop if donate else dict.__getitem__
        yield (k, take(params, k), take(grads, k),
               *(take(d, k) for d in state))


def _global_norm(grads: dict, shards=None) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in f32 (a 0-d tensor,
    left on the device), summed in key order (jax's leaf order), so that a
    state restored from a checkpoint, whose dicts may be ordered
    otherwise, steps as the live one does.  With ``shards`` each leaf's
    sum over its block is first summed over the leaf's distinct blocks."""
    keys = sorted(grads)
    sums = [torch.sum(torch.square(grads[k].float())) for k in keys]
    if shards is not None:
        sums = shards.leaf_totals(keys, sums)
    return torch.sqrt(sum(sums))


def adamw_update(params: dict, grads: dict, state: dict, cfg: OptConfig,
                 *, donate: bool = False, shards=None):
    """Returns (new_params, new_state, metrics).  The global-norm clip
    scales every gradient by ``min(1, clip / norm)``; weight decay is
    decoupled (added to the normalised step, times the LR).  ``donate``
    and ``shards``: see the module's docstring."""
    count = state["count"] + 1
    gnorm = _global_norm(grads, shards)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    lr = lr_at(cfg, count)
    c1 = 1.0 - cfg.b1 ** count
    c2 = 1.0 - cfg.b2 ** count
    sdt = torch_dtype(cfg.state_dtype)
    new_p, new_m, new_v = {}, {}, {}
    f32 = torch.float32
    for k, p, g, m, v in _leaves(params, grads, (state["m"], state["v"]),
                                 donate):
        # each line is the functional update's arithmetic, op for op; the
        # results land in place in this leaf's f32 temporaries and, when
        # donated, in its f32 moments and params, so that the update of
        # the largest leaf holds about three f32 copies of it at once,
        # not seven (Qwen1.5-4B's stacked MLP leaves: 2.64 GiB each)
        g = g.float() * scale
        m32 = m.to(f32, copy=not donate).mul_(cfg.b1)
        m32.add_((1 - cfg.b1) * g)
        v32 = v.to(f32, copy=not donate).mul_(cfg.b2)
        g.square_()
        v32.add_(g.mul_(1 - cfg.b2))
        del g, m, v
        step_ = (m32 / c1).div_((v32 / c2).sqrt_().add_(cfg.eps))
        p32 = p.to(f32, copy=not donate)
        step_.add_(cfg.weight_decay * p32).mul_(lr)
        new_p[k] = p32.sub_(step_).to(p.dtype)
        new_m[k], new_v[k] = m32.to(sdt), v32.to(sdt)
        del p, m32, v32, step_, p32
    return (new_p, {"m": new_m, "v": new_v, "count": count},
            {"grad_norm": gnorm, "lr": lr})


# ---------------------------------------------------------------------------
# Adafactor-lite (factored second moment; for very large embeddings/experts)


def adafactor_init(params: dict, cfg: OptConfig) -> dict:
    def fac(p):
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}
    return {"f": {k: fac(p) for k, p in params.items()}, "count": 0}


class _Means:
    """One leaf's means over whole dimensions, and its factored moments'
    layouts: ``torch.mean`` on a whole leaf; with ``shards``, from this
    rank's blocks.  A layout lists, a dimension each, the mesh axes that
    split it: ``p`` the param's, ``r`` / ``c`` the row / column moment's
    (``vr`` / ``vc``), ``pr`` / ``pc`` the param's with its last / second
    last dimension taken out (where a row / column mean of g² lands), and
    ``r1`` / ``pr1`` those of ``vr``'s mean over its rows (kept as a
    dimension of 1) in ``vr``'s layout and in the param's."""

    def __init__(self, shards, key: str, ndim: int):
        self.shards = shards
        if shards is None:
            return
        self.p = shards.layout(("params", key), ndim)
        if ndim >= 2:
            self.r = shards.layout(("opt", "f", key, "vr"), ndim - 1)
            self.c = shards.layout(("opt", "f", key, "vc"), ndim - 1)
            self.pr, self.pc = self.p[:-1], self.p[:-2] + self.p[-1:]
            self.r1, self.pr1 = self.r[:-1] + [()], self.pr[:-1] + [()]

    def mean(self, x, dim=None, layout="p", keepdim=False):
        if self.shards is None:
            return (torch.mean(x) if dim is None
                    else torch.mean(x, dim=dim, keepdim=keepdim))
        return self.shards.mean(x, dim, getattr(self, layout), keepdim)

    def move(self, x, src: str, dst: str):
        """``x`` from layout ``src`` to ``dst`` (names of this object's
        layouts)."""
        if self.shards is None:
            return x
        return self.shards.ops.relayout(x, getattr(self, src),
                                        getattr(self, dst))


def adafactor_update(params: dict, grads: dict, state: dict, cfg: OptConfig,
                     *, donate: bool = False, shards=None):
    """Returns (new_params, new_state, metrics): the factored second moment
    (row and column means of g²) on every matrix, a full one on vectors,
    and the update clipped to RMS 1.  ``donate`` and ``shards``: see the
    module's docstring."""
    count = state["count"] + 1
    lr = lr_at(cfg, count)
    d = 1.0 - cfg.b2 ** count
    new_p, new_f = {}, {}
    for k, p, g, f in _leaves(params, grads, (state["f"],), donate):
        g = g.float()
        m = _Means(shards, k, p.dim())
        if p.dim() >= 2:
            vr = cfg.b2 * f["vr"] + (1 - cfg.b2) * m.move(
                m.mean(torch.square(g), -1), "pr", "r")
            vc = cfg.b2 * f["vc"] + (1 - cfg.b2) * m.move(
                m.mean(torch.square(g), -2), "pc", "c")
            mean_vr = m.move(m.mean(vr, -1, "r", keepdim=True), "r1", "pr1")
            denom = torch.sqrt(
                m.move(vr, "r", "pr")[..., None]
                * m.move(vc, "c", "pc")[..., None, :]
                / torch.clamp(mean_vr[..., None], min=1e-30) / d)
            step_ = g / torch.clamp(denom, min=1e-30)
            new_f[k] = {"vr": vr, "vc": vc}
        else:
            v = cfg.b2 * f["v"] + (1 - cfg.b2) * torch.square(g)
            step_ = g / (torch.sqrt(v / d) + cfg.eps)
            new_f[k] = {"v": v}
        # update clipping (Adafactor's RMS rule)
        rms = torch.sqrt(m.mean(torch.square(step_)) + 1e-30)
        step_ = step_ / torch.clamp(rms, min=1.0)
        p32 = p.float()
        new_p[k] = (p32 - lr * (step_ + cfg.weight_decay * p32)).to(p.dtype)
        del p, g, f, step_, p32
    return new_p, {"f": new_f, "count": count}, {"lr": lr}
