"""Mamba-2 SSD (state-space duality) mixer — the reference's
``repro.models.ssm`` in PyTorch.

Train and prefill use the chunked dual form (quadratic intra-chunk
attention-like products plus a linear inter-chunk state recurrence);
decode is the O(1) recurrent update.  B and C are shared by all heads
(n_groups = 1).  ``softplus`` is ``logaddexp(x, 0)``, as
``jax.nn.softplus`` computes it, with no threshold.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import Spec, _mm, rmsnorm


def ssd_specs(cfg) -> dict[str, Spec]:
    D, di, ds, nh, cw = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    return {
        "wz": ((D, di), ("embed", "ffn")),
        "wx": ((D, di), ("embed", "ffn")),
        "wB": ((D, ds), ("embed", "ssm_state")),
        "wC": ((D, ds), ("embed", "ssm_state")),
        "wdt": ((D, nh), ("embed", "ssm_heads")),
        "conv_x": ((cw, di), (None, "ffn")),
        "conv_B": ((cw, ds), (None, "ssm_state")),
        "conv_C": ((cw, ds), (None, "ssm_state")),
        "A_log": ((nh,), ("ssm_heads",)),
        "D_skip": ((nh,), ("ssm_heads",)),
        "dt_bias": ((nh,), ("ssm_heads",)),
        "ssd_norm_scale": ((di,), ("norm",)),
        "w_out": ((di, D), ("ffn", "embed")),
    }


def ssd_cache_specs(cfg, batch: int) -> dict[str, Spec]:
    nh, hd, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = cfg.d_inner
    cw = cfg.ssm_conv
    return {
        "state": ((batch, nh, hd, ds), ("cache_batch", "ssm_heads", None, None)),
        "conv": ((batch, cw - 1, di + 2 * ds), ("cache_batch", None, "ffn")),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w, state=None):
    """Depthwise causal conv, width cw, via shifted adds.

    x: [B,S,C]; w: [cw,C]; state: [B,cw-1,C] previous inputs (decode) or None.
    Returns (y [B,S,C], new_state [B,cw-1,C]).
    """
    cw = w.shape[0]
    if state is None:
        state = torch.zeros(x.shape[0], cw - 1, x.shape[2], dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)           # [B, S+cw-1, C]
    S = x.shape[1]
    w = w.to(x.dtype)
    y = xp[:, 0:S] * w[0]
    for j in range(1, cw):
        y = y + xp[:, j:j + S] * w[j]
    return y, xp[:, -(cw - 1):]


def _segsum(la: torch.Tensor) -> torch.Tensor:
    """log-decay segment sums: la [..., Q] -> [..., Q, Q] lower-tri sums."""
    Q = la.shape[-1]
    cs = torch.cumsum(la, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=la.device))
    return torch.where(mask, d, float("-inf"))


def _final_state(bc, lac, dtc, xc):
    """The state after the last chunk, in closed form: each chunk's own
    contribution decayed to its end, then the recurrence over chunks."""
    B, nc, Q, nh, hd = xc.shape
    cum = torch.cumsum(lac, dim=2)
    tail = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bckn,bckh,bckhp->bchpn", bc.float(), tail * dtc,
                          xc.float())
    decay = torch.exp(cum[:, :, -1, :])
    h = torch.zeros(B, nh, hd, bc.shape[-1], dtype=torch.float32,
                    device=xc.device)
    for c in range(nc):
        h = h * decay[:, c, :, None, None] + states[:, c]
    return h


def ssd_seq(p, x, cfg):
    out, _ = ssd_seq_cached(p, x, cfg, want_cache=False)
    return out


def ssd_seq_cached(p, x, cfg, *, want_cache: bool = False):
    """Full-sequence SSD mixer.  x: [B,S,D] -> ([B,S,D], cache|None).

    ``ssd_impl="kernel"`` hands the chunked, Δt-weighted operands to
    :func:`ssd_scan` in the ``[B*nh, nc, Q, ·]`` layout, B and C as one
    group per batch row (``[B, nc, Q, ds]``, shared by its nh heads), all
    f32 (the kernels on a CUDA tensor, the plain version on a CPU one),
    and recomputes the final state in closed form for the
    cache.  ``xla`` runs the dual form in tensor ops.  S must divide by
    ``Q = min(ssm_chunk, S)``."""
    B, S, D = x.shape
    nh, hd, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z = _mm(x, p["wz"])
    xs = _mm(x, p["wx"])
    Bp = _mm(x, p["wB"])
    Cp = _mm(x, p["wC"])
    dt = _mm(x, p["wdt"], out_f32=True)

    conv_tail = None
    if want_cache:
        cw = cfg.ssm_conv
        raw = torch.cat([xs, Bp, Cp], dim=-1)
        pad = max(0, (cw - 1) - S)
        if pad:
            raw = torch.cat([torch.zeros(B, pad, raw.shape[-1], dtype=raw.dtype,
                                         device=raw.device), raw], dim=1)
        conv_tail = raw[:, -(cw - 1):]
    xs, _ = _causal_conv(xs, p["conv_x"])
    Bp, _ = _causal_conv(Bp, p["conv_B"])
    Cp, _ = _causal_conv(Cp, p["conv_C"])
    xs, Bp, Cp = F.silu(xs), F.silu(Bp), F.silu(Cp)

    dt = _softplus(dt + p["dt_bias"].float())                     # [B,S,nh]
    A = -torch.exp(p["A_log"].float())                             # [nh]
    la = dt * A                                                    # [B,S,nh]
    xh = xs.reshape(B, S, nh, hd)

    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD "
                         f"chunk {Q} (cfg.ssm_chunk)")
    nc = S // Q
    xc = xh.reshape(B, nc, Q, nh, hd)
    bc = Bp.reshape(B, nc, Q, ds)
    cc = Cp.reshape(B, nc, Q, ds)
    lac = la.reshape(B, nc, Q, nh)
    dtc = dt.reshape(B, nc, Q, nh)

    if cfg.ssd_impl == "kernel":
        xk = (xc * dtc[..., None].to(xc.dtype)) \
            .permute(0, 3, 1, 2, 4).reshape(B * nh, nc, Q, hd)
        lak = lac.permute(0, 3, 1, 2).reshape(B * nh, nc, Q)
        yk = ssd_scan(xk.float(), lak, bc.float(), cc.float())  # B groups
        y = yk.reshape(B, nh, nc, Q, hd).permute(0, 2, 3, 1, 4).to(x.dtype)
        y = y.reshape(B, S, nh, hd)
        h_fin = _final_state(bc, lac, dtc, xc) if want_cache else None
    elif cfg.ssd_impl == "xla":
        Lseg = torch.exp(_segsum(lac.permute(0, 1, 3, 2)))        # [B,nc,nh,Q,Q]
        scores = torch.einsum("bcqn,bckn->bcqk", cc.float(), bc.float())
        M = scores[:, :, None] * Lseg                              # [B,nc,nh,Q,Q]
        y_intra = torch.einsum("bchqk,bckh,bckhp->bcqhp", M.to(x.dtype),
                               dtc.to(x.dtype), xc)

        cum = torch.cumsum(lac, dim=2)
        tail = torch.exp(cum[:, :, -1:, :] - cum)                  # decay to chunk end
        states = torch.einsum("bckn,bckh,bckhp->bchpn", bc.float(),
                              tail * dtc, xc.float())
        chunk_decay = torch.exp(cum[:, :, -1, :])                  # [B,nc,nh]
        h = torch.zeros(B, nh, hd, ds, dtype=torch.float32, device=x.device)
        h_prev = []
        for c in range(nc):                                        # state BEFORE chunk c
            h_prev.append(h)
            h = h * chunk_decay[:, c, :, None, None] + states[:, c]
        h_prev = torch.stack(h_prev, dim=1)                        # [B,nc,nh,hd,ds]
        y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cc.float(),
                               torch.exp(cum), h_prev).to(x.dtype)
        y = (y_intra + y_inter).reshape(B, S, nh, hd)
        h_fin = h
    else:
        raise ValueError(f"unknown ssd_impl {cfg.ssd_impl!r} (xla | kernel)")

    y = y + xh * p["D_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B, S, cfg.d_inner)
    y = rmsnorm(y * F.silu(z), p["ssd_norm_scale"], cfg.norm_eps)
    out = _mm(y, p["w_out"])
    if not want_cache:
        return out, None
    return out, {"state": h_fin, "conv": conv_tail}


def ssd_decode(p, x, cfg, cache):
    """Single-step SSD.  x: [B,1,D]; cache {state [B,nh,hd,ds] f32, conv
    [B,cw-1,C]}.  The new state and conv window are written into
    ``cache``'s tensors in place (the reference returns updated copies).
    Returns ([B,1,D], cache)."""
    B = x.shape[0]
    nh, hd, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = cfg.d_inner
    z = _mm(x, p["wz"])
    xs = _mm(x, p["wx"])
    Bp = _mm(x, p["wB"])
    Cp = _mm(x, p["wC"])
    dt = _mm(x, p["wdt"], out_f32=True)

    conv_in = torch.cat([xs, Bp, Cp], dim=-1)                      # [B,1,di+2ds]
    w_all = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    y, new_conv = _causal_conv(conv_in, w_all, cache["conv"])
    y = F.silu(y)
    xs, Bp, Cp = y[..., :di], y[..., di:di + ds], y[..., di + ds:]

    dt = _softplus(dt + p["dt_bias"].float())[:, 0]                # [B,nh]
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A)                                      # [B,nh]
    xh = xs.reshape(B, nh, hd).float()
    Bv = Bp[:, 0].float()                                          # [B,ds]
    Cv = Cp[:, 0].float()
    state = cache["state"].float()
    state = state * decay[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, Bv)
    yh = torch.einsum("bn,bhpn->bhp", Cv, state)
    yh = yh + xh * p["D_skip"].float()[None, :, None]
    y = yh.reshape(B, 1, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["ssd_norm_scale"], cfg.norm_eps)
    out = _mm(y, p["w_out"])
    cache["state"].copy_(state)
    cache["conv"].copy_(new_conv)
    return out, cache
