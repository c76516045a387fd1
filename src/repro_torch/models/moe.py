"""Mixture-of-experts FFN — the reference's ``repro.models.moe`` in PyTorch,
at world size 1.

With no mesh, the reference's ``moe_ffn`` takes ``_moe_dense_fallback``
(``src/repro/models/moe.py:240-261``), and so does the port, always: a
GShard-style router (f32 logits, softmax, top-k renormalised), tokens
binned into per-expert capacity buffers of ``max(4, ceil(t·k·cf/E))``
slots, one grouped product over all experts, the outputs gathered back
and weighted, plus Llama-4's shared expert through ``layers.mlp``.
``cfg.moe_seq_shard`` and ``cfg.moe_expert_resident`` have no effect, as
in the reference without a mesh.  The expert-parallel paths (``a2a``
over the model axis, ``psum`` for decode) come with the port of
``parallel/``.

Drops and ties are the reference's exactly: top-k breaks a tie in
probability toward the lower expert id (``jax.lax.top_k``'s order; a
stable descending sort here), a token copy's rank within its expert is
its place in a stable sort of the expert ids, and a copy ranked at or
past capacity goes to the out-of-range slot ``E·cap``, which reads as a
zero row with weight 0.  No Pallas kernel is involved: the expert
products are plain batched matrix products, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Spec, mlp


def moe_specs(cfg, prefix: str = "") -> dict[str, Spec]:
    D, E, F_ = cfg.d_model, cfg.num_experts, cfg.moe_hidden
    s: dict[str, Spec] = {
        f"{prefix}router": ((D, E), ("embed", None)),
        f"{prefix}we_gate": ((E, D, F_), ("experts", "embed", "expert_ffn")),
        f"{prefix}we_up": ((E, D, F_), ("experts", "embed", "expert_ffn")),
        f"{prefix}we_down": ((E, F_, D), ("experts", "expert_ffn", "embed")),
    }
    if cfg.shared_expert:
        s[f"{prefix}ws_gate"] = ((D, F_), ("embed", "ffn"))
        s[f"{prefix}ws_up"] = ((D, F_), ("embed", "ffn"))
        s[f"{prefix}ws_down"] = ((F_, D), ("ffn", "embed"))
    return s


def capacity(t: int, cfg) -> int:
    """Slots an expert holds for ``t`` tokens: ``max(4, ceil(t·k·cf/E))``."""
    k, E = cfg.experts_per_token, cfg.num_experts
    return max(4, int(-(-t * k * cfg.capacity_factor // E)))


def _router(x_tok, w_router, cfg):
    """x_tok: [T, D] -> (top-k probs [T,k], expert ids [T,k], full probs
    [T,E]), all in f32 but the ids."""
    probs = torch.softmax(x_tok.float() @ w_router.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_e, probs


def _aux_loss(probs, top_e, cfg):
    """GShard load-balance loss: E * sum_e f_e * p_e."""
    E = cfg.num_experts
    f = F.one_hot(top_e, E).float().mean(dim=(0, 1))
    return E * torch.sum(f * probs.mean(dim=0))


def _bin_tokens(x_tok, top_p, top_e, n_exp: int, cap: int):
    """Scatter token copies into per-expert capacity bins.

    Returns (buf [n_exp*cap, D], combine weights [T*k], slot index [T*k]).
    A copy's slot is ``e·cap + rank``, its rank its place among its
    expert's copies in a stable sort, or ``n_exp·cap`` once the bin is
    full: dropped copies all land in one extra row past the bins, cut off
    before the buffer is returned (the reference's ``mode="drop"``)."""
    T, k = top_e.shape
    e_flat = top_e.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    counts = torch.bincount(e_sorted, minlength=n_exp)
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(T * k, device=e_flat.device) - starts[e_sorted]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = rank < cap
    slot = torch.where(keep, e_flat * cap + rank,
                       torch.full_like(rank, n_exp * cap))
    tok_id = torch.arange(T * k, device=x_tok.device) // k
    buf = torch.zeros(n_exp * cap + 1, x_tok.shape[1], dtype=x_tok.dtype,
                      device=x_tok.device)
    buf = buf.index_put((slot,), x_tok[tok_id])[:-1]
    comb_w = torch.where(keep, top_p.reshape(-1), 0.0)
    return buf, comb_w, slot


def _expert_ffn(recv, wg, wu, wd):
    """recv: [E, N, D]; weights [E, D, F] / [E, F, D]; SwiGLU per expert
    in recv's type."""
    g = torch.bmm(recv, wg.to(recv.dtype))
    u = torch.bmm(recv, wu.to(recv.dtype))
    return torch.bmm(F.silu(g) * u, wd.to(recv.dtype))


def moe_ffn(p, x, cfg, prefix: str = ""):
    """x: [B,S,D] -> (y [B,S,D], aux_loss f32 scalar): the reference's
    ``_moe_dense_fallback``."""
    B, S, D = x.shape
    E = cfg.num_experts
    x_tok = x.reshape(-1, D)
    top_p, top_e, probs = _router(x_tok, p[f"{prefix}router"], cfg)
    aux = _aux_loss(probs, top_e, cfg)
    t, k = top_e.shape
    cap = capacity(t, cfg)
    buf, comb_w, slot = _bin_tokens(x_tok, top_p, top_e, E, cap)
    out = _expert_ffn(buf.reshape(E, cap, D), p[f"{prefix}we_gate"],
                      p[f"{prefix}we_up"], p[f"{prefix}we_down"])
    out = torch.cat([out.reshape(E * cap, D), out.new_zeros(1, D)])
    y = (out[slot].reshape(t, k, D)
         * comb_w.reshape(t, k, 1).to(out.dtype)).sum(dim=1).reshape(B, S, D)
    if cfg.shared_expert:
        sh = {"w_gate": p[f"{prefix}ws_gate"], "w_up": p[f"{prefix}ws_up"],
              "w_down": p[f"{prefix}ws_down"]}
        y = y + mlp(sh, x, cfg)
    return y, aux
