"""RG-LRU recurrent block (RecurrentGemma / Griffin) — the reference's
``repro.models.rglru`` in PyTorch.

Train and prefill run the diagonal linear recurrence ``h_t = a_t·h_{t-1}
+ u_t`` in f32 as a log-depth scan over the sequence axis: ``ceil(log2
S)`` doubling steps of whole-tensor products, where the reference runs
``lax.associative_scan`` (both outside any Pallas kernel).  A loop per
token would be S steps of small launches a layer.  Decode is the O(1)
update, written into the cache's tensors in place (the reference
returns updated copies).  ``softplus`` is ``logaddexp(x, 0)`` and
``gelu`` the tanh approximation, as ``jax.nn`` computes them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Spec, _mm
from repro_torch.models.ssm import _causal_conv, _softplus

_C_FACTOR = 8.0  # Griffin's fixed gate exponent scale


def rglru_specs(cfg) -> dict[str, Spec]:
    D, w, cw = cfg.d_model, cfg.rnn_width, 4
    return {
        "wx_in": ((D, w), ("embed", "ffn")),
        "wy_in": ((D, w), ("embed", "ffn")),
        "conv_w": ((cw, w), (None, "ffn")),
        "wa_gate": ((w, w), ("embed", "ffn")),
        "wi_gate": ((w, w), ("embed", "ffn")),
        "a_gate_b": ((w,), ("ffn",)),
        "i_gate_b": ((w,), ("ffn",)),
        "lam": ((w,), ("ffn",)),
        "w_rg_out": ((w, D), ("ffn", "embed")),
    }


def rglru_cache_specs(cfg, batch: int) -> dict[str, Spec]:
    w, cw = cfg.rnn_width, 4
    return {
        "h": ((batch, w), ("cache_batch", "ffn")),
        "conv": ((batch, cw - 1, w), ("cache_batch", None, "ffn")),
    }


def _gates(p, xb):
    """xb: [..., w] conv branch -> (log_a [..., w] f32, gated input
    [..., w] f32)."""
    xf = xb.float()
    r = torch.sigmoid(xf @ p["wa_gate"].float() + p["a_gate_b"].float())
    i = torch.sigmoid(xf @ p["wi_gate"].float() + p["i_gate_b"].float())
    log_a = -_C_FACTOR * r * _softplus(p["lam"].float())
    a2 = torch.exp(2.0 * log_a)
    u = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * xf)
    return log_a, u


def linear_scan(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t·h_{t-1} + u_t`` from ``h_{-1} = 0`` along axis 1, for
    every t at once: Hillis-Steele doubling, each step composing every
    position with the one ``d`` before it.  a, u: [B, S, w] f32."""
    S = a.shape[1]
    d = 1
    while d < S:
        u = torch.cat([u[:, :d], a[:, d:] * u[:, :-d] + u[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return u


def rglru_seq_cached(p, x, cfg, *, want_cache: bool = False):
    """x: [B,S,D] -> ([B,S,D], cache|None) via conv + RG-LRU + output
    gate.  The cache is ``h`` [B, w] f32, the state after the last
    position, and ``conv`` [B, 3, w], the conv branch's last 3 inputs
    before the conv (zeros in front when S < 3)."""
    B, S, _ = x.shape
    xb = _mm(x, p["wx_in"])
    yb = _mm(x, p["wy_in"])
    conv_tail = None
    if want_cache:
        cw = p["conv_w"].shape[0]
        raw = xb
        pad = max(0, (cw - 1) - S)
        if pad:
            raw = torch.cat([raw.new_zeros(B, pad, raw.shape[-1]), raw], dim=1)
        conv_tail = raw[:, -(cw - 1):]
    xb, _ = _causal_conv(xb, p["conv_w"])
    log_a, u = _gates(p, xb)
    h = linear_scan(torch.exp(log_a), u)
    hg = h.to(x.dtype) * F.gelu(yb, approximate="tanh")
    out = _mm(hg, p["w_rg_out"])
    if not want_cache:
        return out, None
    return out, {"h": h[:, -1], "conv": conv_tail}


def rglru_decode(p, x, cfg, cache):
    """x: [B,1,D]; cache {h [B,w] f32, conv [B,3,w]}, both updated in
    place.  Returns ([B,1,D], cache)."""
    xb = _mm(x, p["wx_in"])
    yb = _mm(x, p["wy_in"])
    xb, new_conv = _causal_conv(xb, p["conv_w"], cache["conv"])
    log_a, u = _gates(p, xb[:, 0])
    h = cache["h"].float() * torch.exp(log_a) + u
    y = h[:, None, :].to(x.dtype) * F.gelu(yb, approximate="tanh")
    out = _mm(y, p["w_rg_out"])
    cache["h"].copy_(h)
    cache["conv"].copy_(new_conv)
    return out, cache
