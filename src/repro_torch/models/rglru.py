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

**Tensor parallelism.**  Where ``model`` splits every leaf of
:data:`TP_WEIGHTS` (:func:`tp_split`, ``parallel.sharding.block_group``;
in decode also the cache's ``h`` and ``conv`` along their channels), the
caller (``transformer._gather_block``) gathers them keeping ``model`` and
hands the block the group, ``tp``; it runs its ``w/tp`` channels: their
input projections, conv, gates' columns, scan and output gate; the gates read
the whole conv branch, gathered over the group (``[B, S, w]`` f32), and
``w_rg_out``'s row-split partial output is summed over the group.  A
prefill's cache is the rank's block of the channels, and decode updates
the cache's blocks in place with nothing gathered but the gates' input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Spec, _mm
from repro_torch.models.ssm import _causal_conv, _softplus
from repro_torch.parallel import sharding as SH

_C_FACTOR = 8.0  # Griffin's fixed gate exponent scale

#: the block's own leaves, gathered keeping ``model`` where it runs split
#: (``transformer._gather_block``)
TP_WEIGHTS = ("wx_in", "wy_in", "conv_w", "wa_gate", "wi_gate", "a_gate_b",
              "i_gate_b", "lam", "w_rg_out")


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


def tp_split(p, cache=None) -> SH.TPGroup | None:
    """The group over which the block runs split (see the module), given
    its leaves ``p`` and, in decode, its ``cache``; None: it runs
    whole."""
    dims = () if cache is None else ((cache["h"], 1), (cache["conv"], 2))
    return SH.block_group(p, TP_WEIGHTS, dims)


def _gates(p, xb, tp=None):
    """xb: [..., w] conv branch -> (log_a [..., w] f32, gated input
    [..., w] f32); under ``tp`` the rank's channels of each, from its
    block of ``xb`` gathered over the group."""
    xf = xb.float()
    xw = xf if tp is None else tp.gather(xf, -1, p["wa_gate"].shape[0])
    r = torch.sigmoid(xw @ p["wa_gate"].float() + p["a_gate_b"].float())
    i = torch.sigmoid(xw @ p["wi_gate"].float() + p["i_gate_b"].float())
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


def rglru_seq_cached(p, x, cfg, *, want_cache: bool = False, tp=None):
    """x: [B,S,D] -> ([B,S,D], cache|None) via conv + RG-LRU + output
    gate.  The cache is ``h`` [B, w] f32, the state after the last
    position, and ``conv`` [B, 3, w], the conv branch's last 3 inputs
    before the conv (zeros in front when S < 3); under ``tp``
    (:func:`tp_split`'s group; ``p`` its rank's channels) the rank's
    channels of both."""
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
    log_a, u = _gates(p, xb, tp)
    h = linear_scan(torch.exp(log_a), u)
    hg = h.to(x.dtype) * F.gelu(yb, approximate="tanh")
    out = _mm(hg, p["w_rg_out"])
    if tp is not None:
        out = tp.sum(out)
    if not want_cache:
        return out, None
    return out, {"h": h[:, -1], "conv": conv_tail}


def rglru_decode(p, x, cfg, cache, tp=None):
    """x: [B,1,D]; cache {h [B,w] f32, conv [B,3,w]}, both updated in
    place (under ``tp`` the rank's blocks of the channels,
    ``parallel.sharding.ShardedLeaf`` s).  Returns ([B,1,D], cache)."""
    h0, conv = (SH.local_of(cache[k]) for k in ("h", "conv"))
    xb = _mm(x, p["wx_in"])
    yb = _mm(x, p["wy_in"])
    xb, new_conv = _causal_conv(xb, p["conv_w"], conv)
    log_a, u = _gates(p, xb[:, 0], tp)
    h = h0.float() * torch.exp(log_a) + u
    y = h[:, None, :].to(x.dtype) * F.gelu(yb, approximate="tanh")
    out = _mm(y, p["w_rg_out"])
    if tp is not None:
        out = tp.sum(out)
    h0.copy_(h)
    conv.copy_(new_conv)
    return out, cache
