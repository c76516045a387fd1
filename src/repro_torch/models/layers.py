"""Core layers: RMSNorm, RoPE, GQA attention (chunked prefill / cached
decode), MLP — the reference's ``repro.models.layers`` in PyTorch.

Parameter conventions are the reference's: every module exposes
``<mod>_specs(cfg, ...) -> dict[name, (shape, logical_axes)]`` and one
initializer consumes those specs.  Attention weights stay 3-D
``[d_model, heads, head_dim]``; activations are ``[B, S, H, hd]``.

Where the reference asks an einsum for an f32 result of bf16 operands
(``preferred_element_type=jnp.float32``), the operands are upcast first,
so the products are exact as there; elsewhere the product stays in the
working type, as the reference's does.  The port runs at world size 1, so
the reference's ``shard_act`` constraints have no counterpart.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attn import flash_attention

Spec = tuple[tuple[int, ...], tuple[str | None, ...]]

NEG = -1e30         # the naive and flash paths mask with this, not -inf

# ---------------------------------------------------------------------------
# generic param plumbing


def init_from_specs(specs: dict[str, Spec], generator: torch.Generator,
                    dtype: torch.dtype, device) -> dict:
    """The reference's rule, name by name in sorted order: ``*_scale`` and
    ``*norm`` ones, ``*_bias`` and ``*_b`` zeros, anything else normal ×
    ``min(0.02, 1/sqrt(fan_in))`` drawn in f32 from ``generator`` (on the
    generator's device) and cast to ``dtype``.  The numbers are not
    ``jax.random``'s: tests carry the reference's parameters across with
    :func:`repro_torch.convert.params_from_numpy` instead."""
    params = {}
    for name, (shape, _axes) in sorted(specs.items()):
        if name.endswith("_scale") or name.endswith("norm"):
            params[name] = torch.ones(shape, dtype=dtype, device=device)
        elif name.endswith("_bias") or name.endswith("_b"):
            params[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
            std = min(0.02, 1.0 / np.sqrt(fan_in))
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=generator.device) * std
            params[name] = w.to(device=device, dtype=dtype)
    return params


def _mm(x: torch.Tensor, w: torch.Tensor, out_f32: bool = False) -> torch.Tensor:
    """``x [..., K] @ w [K, ...]`` with the trailing axes of ``w`` kept:
    in ``x``'s type, or in f32 from upcast operands when ``out_f32``."""
    tail = w.shape[1:]
    w2 = w.reshape(w.shape[0], -1)
    if out_f32:
        y = x.float() @ w2.float()
    else:
        y = x @ w2.to(x.dtype)
    return y.reshape(*x.shape[:-1], *tail)


# ---------------------------------------------------------------------------
# norm


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def norm_specs(prefix: str, d: int) -> dict[str, Spec]:
    return {f"{prefix}_scale": ((d,), ("norm",))}


# ---------------------------------------------------------------------------
# RoPE


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The numpy frequencies (bit for bit the reference's) on ``device``,
    copied once: a copy from pageable host memory per call would stall
    the stream at every layer.  Callers only read the tensor."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] integers."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)              # [hd/2]
    ang = positions[..., None].float() * freqs                      # [..., seq, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention


def attn_specs(cfg) -> dict[str, Spec]:
    D, H, Kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s: dict[str, Spec] = {
        "wq": ((D, H, hd), ("embed", "heads", None)),
        "wk": ((D, Kv, hd), ("embed", "kv_heads", None)),
        "wv": ((D, Kv, hd), ("embed", "kv_heads", None)),
        "wo": ((H, hd, D), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        s["wq_b"] = ((H, hd), ("heads", None))
        s["wk_b"] = ((Kv, hd), ("kv_heads", None))
        s["wv_b"] = ((Kv, hd), ("kv_heads", None))
    return s


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return torch.tanh(scores / cap) * cap
    return scores


def _qkv(p, x, cfg, positions):
    q, k, v = _mm(x, p["wq"]), _mm(x, p["wk"]), _mm(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["wq_b"].to(q.dtype)
        k = k + p["wk_b"].to(k.dtype)
        v = v + p["wv_b"].to(v.dtype)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` in ``o``'s type."""
    B, S, H, hd = o.shape
    return o.reshape(B, S, H * hd) @ wo.reshape(H * hd, -1).to(o.dtype)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, window: int) -> torch.Tensor:
    m = qpos[:, None] >= kpos[None, :]
    if window:
        m &= qpos[:, None] - kpos[None, :] < window
    return m


def _block_naive(qc, k, v, qpos, kpos, scale, cfg, window):
    """[B,C,H,hd] q chunk against the whole [B,S,H,hd] k, v: the f32
    score einsum, softcap, NEG mask, f32 softmax cast to the working type,
    then P·V in the working type."""
    s_ = torch.einsum("bqhk,bthk->bhqt", qc.float(), k.float())
    s_ = _softcap(s_ * scale, cfg.attn_logit_softcap)
    s_ = torch.where(_mask(qpos, kpos, window)[None, None], s_, NEG)
    pr = torch.softmax(s_, dim=-1).to(qc.dtype)
    return torch.einsum("bhqt,bthk->bqhk", pr, v)


def _block_fused(qc, k, v, qpos, kpos, scale, cfg, window):
    """Flash-style at the tensor level: one f32 score tensor, an additive
    -inf mask, unnormalised probabilities cast to the working type at
    once, an f32 P·V from upcast operands, the division deferred to the
    output."""
    s_ = torch.einsum("bqhk,bthk->bhqt", qc.float(), k.float())
    s_ = _softcap(s_ * scale, cfg.attn_logit_softcap)
    m = _mask(qpos, kpos, window)
    s_ = s_ + torch.where(m, 0.0, float("-inf"))[None, None]
    mx = torch.amax(s_, dim=-1, keepdim=True)
    p = torch.exp(s_ - mx).to(qc.dtype)
    l = torch.sum(p.float(), dim=-1)                                # [b,h,q]
    o = torch.einsum("bhqt,bthk->bqhk", p.float(), v.float())
    o = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return o.to(qc.dtype)


def attention_seq_kv(p, x, cfg, *, window: int = 0):
    """Full-sequence (train / prefill) attention.

    x: [B,S,D] -> ([B,S,D], (k_kv, v_kv)) where k_kv/v_kv are the rope'd
    pre-repeat KV tensors [B,S,Kv,hd] (for cache construction).

    KV is repeated to the full head count.  ``attn_impl="flash"`` hands
    ``[B*H, S, hd]`` operands to :func:`flash_attention` with the
    reference's block sizes (the kernel on a CUDA tensor, its plain
    version on a CPU one) and, as the reference's flash branch does,
    applies no ``attn_logit_softcap``.  ``naive`` and ``fused`` process Q
    in ``cfg.q_chunk`` blocks, bounding the live score tensor to
    ``[B, H, q_chunk, S]``.
    """
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    k_kv, v_kv = k, v
    if cfg.group_size > 1:
        k = torch.repeat_interleave(k, cfg.group_size, dim=2)
        v = torch.repeat_interleave(v, cfg.group_size, dim=2)
    scale = float(1.0 / np.sqrt(hd))

    if cfg.attn_impl == "flash":
        bq = bk = min(max(128, cfg.q_chunk // 8), 512, S)
        qf = q.permute(0, 2, 1, 3).reshape(B * H, S, hd)
        kf = k.permute(0, 2, 1, 3).reshape(B * H, S, hd)
        vf = v.permute(0, 2, 1, 3).reshape(B * H, S, hd)
        of = flash_attention(qf, kf, vf, scale, window, bq, bk)
        o = of.reshape(B, H, S, hd).permute(0, 2, 1, 3)
        return _out_proj(o, p["wo"]), (k_kv, v_kv)
    if cfg.attn_impl not in ("naive", "fused"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r} "
                         "(naive | fused | flash)")
    block = _block_fused if cfg.attn_impl == "fused" else _block_naive

    C = min(cfg.q_chunk, S)
    if S % C:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"q chunk {C} (cfg.q_chunk)")
    kpos = torch.arange(S, device=x.device)
    o = torch.cat([block(q[:, s0:s0 + C], k, v, kpos[s0:s0 + C], kpos, scale,
                         cfg, window) for s0 in range(0, S, C)], dim=1)
    return _out_proj(o, p["wo"]), (k_kv, v_kv)


def attention_seq(p, x, cfg, *, window: int = 0):
    out, _ = attention_seq_kv(p, x, cfg, window=window)
    return out


def attn_cache_specs(cfg, batch: int, cache_len: int, *,
                     per_slot: bool = False) -> dict[str, Spec]:
    """KV-cache layout.  ``per_slot=True`` gives every batch row its own
    ``slot_pos`` vector ([batch, cache_len] instead of the shared
    [cache_len]) — the layout continuous batching needs so sequences at
    different positions coexist in one cache."""
    Kv, hd = cfg.num_kv_heads, cfg.head_dim
    sp_shape = (batch, cache_len) if per_slot else (cache_len,)
    sp_axes = ("cache_batch", "cache_seq") if per_slot else ("cache_seq",)
    return {
        "k": ((batch, cache_len, Kv, hd), ("cache_batch", "cache_seq", "cache_kv_heads", None)),
        "v": ((batch, cache_len, Kv, hd), ("cache_batch", "cache_seq", "cache_kv_heads", None)),
        "slot_pos": (sp_shape, sp_axes),
    }


def attention_decode(p, x, cfg, cache, pos, *, window: int = 0):
    """Single-token decode against a (possibly ring) KV cache.

    x: [B,1,D]; cache k/v: [B,W,Kv,hd].  Two layouts, told apart by
    ``slot_pos``'s rank, as in the reference:

    * **wave batching** (``slot_pos: [W]``, shared): ``pos`` is a scalar;
      every row writes ring slot ``pos % W``.
    * **continuous batching** (``slot_pos: [B,W]``): ``pos`` may be a
      ``[B]`` vector; row b writes its own slot ``pos[b] % W`` and masks
      against its own validity row.

    The new token's K, V and position are written into ``cache``'s
    tensors in place (the reference returns updated copies; the serving
    loop donates its cache, so nothing reads the old values).  Returns
    ([B,1,D], cache).
    """
    B = x.shape[0]
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = cfg.group_size
    k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    per_slot = slot_pos.dim() == 2
    W = k.shape[1]
    pos_t = torch.as_tensor(pos, device=x.device).long()
    if per_slot:
        pos_v = torch.broadcast_to(pos_t, (B,))
        q, k_new, v_new = _qkv(p, x, cfg, pos_v[:, None])
        slot = pos_v % W
        b_idx = torch.arange(B, device=x.device)
        k[b_idx, slot] = k_new[:, 0].to(k.dtype)
        v[b_idx, slot] = v_new[:, 0].to(v.dtype)
        slot_pos[b_idx, slot] = pos_v.to(slot_pos.dtype)
        sp = slot_pos.long()
        valid = (sp >= 0) & (sp <= pos_v[:, None])
        if window:
            valid &= sp > pos_v[:, None] - window
        valid = valid[:, None, None, :]
    else:
        if pos_t.dim() != 0:
            raise ValueError("the shared-slot_pos cache takes a scalar pos, "
                             f"got shape {tuple(pos_t.shape)}")
        q, k_new, v_new = _qkv(p, x, cfg, torch.full((B, 1), int(pos_t),
                                                     device=x.device))
        slot = int(pos_t) % W
        k[:, slot:slot + 1] = k_new.to(k.dtype)
        v[:, slot:slot + 1] = v_new.to(v.dtype)
        slot_pos[slot] = int(pos_t)
        sp = slot_pos.long()
        valid = (sp >= 0) & (sp <= pos_t)
        if window:
            valid &= sp > pos_t - window
        valid = valid[None, None, None, :]

    qg = q.reshape(B, Kv, G, hd)
    s_ = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float())
    s_ = _softcap(s_ / np.sqrt(hd), cfg.attn_logit_softcap)
    s_ = torch.where(valid, s_, NEG)
    pr = torch.softmax(s_, dim=-1).to(x.dtype)
    o = torch.einsum("bkgt,btkd->bkgd", pr, v.to(x.dtype))
    o = o.reshape(B, 1, H, hd)
    return _out_proj(o, p["wo"]), cache


# ---------------------------------------------------------------------------
# MLP


def mlp_specs(cfg, hidden: int | None = None, prefix: str = "") -> dict[str, Spec]:
    D, F_ = cfg.d_model, hidden or cfg.d_ff
    s: dict[str, Spec] = {
        f"{prefix}w_up": ((D, F_), ("embed", "ffn")),
        f"{prefix}w_down": ((F_, D), ("ffn", "embed")),
    }
    if cfg.mlp_gated:
        s[f"{prefix}w_gate"] = ((D, F_), ("embed", "ffn"))
    return s


def mlp(p, x, cfg, prefix: str = ""):
    """SwiGLU when ``cfg.mlp_gated``, else gelu — the tanh approximation,
    which is what ``jax.nn.gelu`` computes by default."""
    up = _mm(x, p[f"{prefix}w_up"])
    if cfg.mlp_gated:
        g = _mm(x, p[f"{prefix}w_gate"])
        h = F.silu(g) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return _mm(h, p[f"{prefix}w_down"])
