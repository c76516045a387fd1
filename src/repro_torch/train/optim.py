"""Optimizers and LR schedules (AdamW with optional bf16 state,
Adafactor-lite, WSD / cosine schedules) — the reference's
``repro.train.optim`` in PyTorch.

State is a dict of tensors that mirrors the params dict (plus a step
``count``).  The updates are functional, as in the reference: they return
new params and a new state and leave their inputs untouched.  Call them
under ``torch.no_grad()`` (the train step does) so that nothing records
the arithmetic.
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


def _global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in f32 (a 0-d tensor,
    left on the device)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


def adamw_update(params: dict, grads: dict, state: dict, cfg: OptConfig):
    """Returns (new_params, new_state, metrics).  The global-norm clip
    scales every gradient by ``min(1, clip / norm)``; weight decay is
    decoupled (added to the normalised step, times the LR)."""
    count = state["count"] + 1
    gnorm = _global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    lr = lr_at(cfg, count)
    c1 = 1.0 - cfg.b1 ** count
    c2 = 1.0 - cfg.b2 ** count
    sdt = torch_dtype(cfg.state_dtype)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float() * scale
        m32 = cfg.b1 * state["m"][k].float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * state["v"][k].float() + (1 - cfg.b2) * torch.square(g)
        step_ = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        p32 = p.float()
        new_p[k] = (p32 - lr * (step_ + cfg.weight_decay * p32)).to(p.dtype)
        new_m[k], new_v[k] = m32.to(sdt), v32.to(sdt)
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


def adafactor_update(params: dict, grads: dict, state: dict, cfg: OptConfig):
    """Returns (new_params, new_state, metrics): the factored second moment
    (row and column means of g²) on every matrix, a full one on vectors,
    and the update clipped to RMS 1."""
    count = state["count"] + 1
    lr = lr_at(cfg, count)
    d = 1.0 - cfg.b2 ** count
    new_p, new_f = {}, {}
    for k, p in params.items():
        g = grads[k].float()
        f = state["f"][k]
        if p.dim() >= 2:
            vr = cfg.b2 * f["vr"] + (1 - cfg.b2) * torch.mean(torch.square(g), dim=-1)
            vc = cfg.b2 * f["vc"] + (1 - cfg.b2) * torch.mean(torch.square(g), dim=-2)
            denom = torch.sqrt(
                vr[..., None] * vc[..., None, :]
                / torch.clamp(torch.mean(vr, dim=-1, keepdim=True)[..., None],
                              min=1e-30) / d)
            step_ = g / torch.clamp(denom, min=1e-30)
            new_f[k] = {"vr": vr, "vc": vc}
        else:
            v = cfg.b2 * f["v"] + (1 - cfg.b2) * torch.square(g)
            step_ = g / (torch.sqrt(v / d) + cfg.eps)
            new_f[k] = {"v": v}
        # update clipping (Adafactor's RMS rule)
        rms = torch.sqrt(torch.mean(torch.square(step_)) + 1e-30)
        step_ = step_ / torch.clamp(rms, min=1.0)
        p32 = p.float()
        new_p[k] = (p32 - lr * (step_ + cfg.weight_decay * p32)).to(p.dtype)
    return new_p, {"f": new_f, "count": count}, {"lr": lr}
