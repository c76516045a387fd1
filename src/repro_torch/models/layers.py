"""Core layers: RMSNorm, RoPE, GQA attention (chunked prefill / cached
decode), MLP — the reference's ``repro.models.layers`` in PyTorch.

Parameter conventions are the reference's: every module exposes
``<mod>_specs(cfg, ...) -> dict[name, (shape, logical_axes)]`` and one
initializer consumes those specs.  Attention weights stay 3-D
``[d_model, heads, head_dim]``; activations are ``[B, S, H, hd]``.

Where the reference asks an einsum for an f32 result of bf16 operands
(``preferred_element_type=jnp.float32``), the operands are upcast first,
so the products are exact as there; elsewhere the product stays in the
working type, as the reference's does.  The reference's ``shard_act``
constraints have no counterpart at the call sites: the port's launcher
runs each rank's forward on plain local tensors (its batch shard, the
weights gathered), where such a constraint changes no number
(``parallel/sharding.py``).

**Tensor parallelism.**  Where the sharded step hands attention or an
MLP a rank's shards whose product ``model`` splits, the module gathers
them keeping ``model`` and runs its own block: attention its tile of the
heads wherever the rules give ``heads`` to ``model``
(``parallel.sharding.tile_group``): ``ceil(H/tp)`` heads, fewer or none
on trailing ranks where ``tp`` does not divide ``H`` (``wq``, ``wo`` and
``wq_b`` kept split where their spec splits them, else cut from the
whole leaves; ``wk`` and ``wv`` kept split where ``kv_heads`` splits
too, else whole and cut to the KV heads its q heads read; an empty tile
launches nothing and adds zeros), the MLP its ``F/tp`` columns of
``w_up`` / ``w_gate`` and rows of ``w_down`` where ``model`` divides
``F`` (``parallel.sharding.tp_group``); the row-split product's partial
output is summed over the group.  :data:`TP_WEIGHTS` are the leaves
these modules gather themselves.  Decode (one token) gathers ``wq``,
``wk`` and ``wv`` whole and splits only ``wo``'s rows; where the KV
cache's slots are split over ``model`` it runs sequence-parallel
(:func:`attention_decode`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.parallel import sharding as SH

Spec = tuple[tuple[int, ...], tuple[str | None, ...]]

#: attention's and the MLP's leaves, which those modules gather themselves
#: where tensor parallelism splits them
MLP_WEIGHTS = ("w_up", "w_gate", "w_down")
TP_WEIGHTS = ("wq", "wk", "wv", "wo", "wq_b", "wk_b", "wv_b") + MLP_WEIGHTS
#: attention's leaves whose q heads tensor parallelism tiles, padded where
#: ``model`` does not divide them, and the dimension of the heads in each
HEAD_DIMS = {"wq": 1, "wq_b": 0, "wo": 0}

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
    :func:`repro_torch.convert.params_from_numpy` instead.

    A drawn leaf is allocated once, in ``dtype`` on ``device``, and filled
    one leading-axis slice at a time, each slice drawn (normal × std) into
    one f32 buffer of a slice's shape: the draw's extra memory is one
    slice in f32 (768 MiB for Qwen3-30B-A3B's [48, 128, 2048, 768] expert
    stacks, which whole in f32 would be 36 GiB).  ``fan_in`` is the whole
    leaf's ``shape[0]``."""
    params = {}
    for name, (shape, _axes) in sorted(specs.items()):
        if name.endswith("_scale") or name.endswith("norm"):
            params[name] = torch.ones(shape, dtype=dtype, device=device)
        elif name.endswith("_bias") or name.endswith("_b"):
            params[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
            std = float(min(0.02, 1.0 / np.sqrt(fan_in)))
            w = torch.empty(shape, dtype=dtype, device=device)
            part = torch.empty(shape[1:], dtype=torch.float32,
                               device=generator.device)
            for row in w:
                row.copy_(part.normal_(0.0, std, generator=generator))
            params[name] = w
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


def _kv(p, x, cfg, positions):
    k, v = _mm(x, p["wk"]), _mm(x, p["wv"])
    if cfg.qkv_bias:
        k = k + p["wk_b"].to(k.dtype)
        v = v + p["wv_b"].to(v.dtype)
    return apply_rope(k, positions, cfg.rope_theta), v


def _qkv(p, x, cfg, positions):
    q = _mm(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["wq_b"].to(q.dtype)
    return (apply_rope(q, positions, cfg.rope_theta),
            *_kv(p, x, cfg, positions))


def cache_kv(p, x, cfg, first: int):
    """K (rope'd) and V of every KV head of ``x`` [B,n,D], the layer's
    normalised input at positions ``first .. first + n - 1``, from
    attention's weights gathered whole: a prefill cache's block where
    tensor parallelism gave the rank only the KV heads its q heads
    read."""
    w = {k: SH.gathered(p[k]) for k in ("wk", "wv", "wk_b", "wv_b")
         if k in p}
    positions = torch.arange(first, first + x.shape[1],
                             device=x.device)[None, :]
    return _kv(w, x, cfg, positions)


def _tp_heads(p, cfg, tp: SH.TPGroup):
    """Attention's weights for this rank's tile of the q heads under
    ``tp`` (``TPGroup.block``: ``ceil(H/tp)`` heads, fewer or none on
    trailing ranks where ``tp`` does not divide ``H``): its tiles of
    ``wq``, ``wo`` and ``wq_b`` (:data:`HEAD_DIMS`); of ``wk``, ``wv``
    and their biases its blocks where ``kv_heads`` splits too, else the
    KV heads its q heads read, cut from the whole leaves.  Returns (the
    weights, the rank's head count, where its q heads start among those
    KV heads repeated ``group_size`` times)."""
    h0, hl = tp.block(cfg.num_heads)
    kv = [k for k in ("wk", "wv", "wk_b", "wv_b") if k in p]
    w = {k: SH.tp_tile(p[k], d, tp) for k, d in HEAD_DIMS.items() if k in p}
    if SH.tp_group(p["wk"]) is not None:
        w.update({k: p[k].gather((SH.TP_AXIS,)) for k in kv})
        return w, hl, 0
    G = cfg.group_size
    lo = h0 // G
    hi = (h0 + hl - 1) // G + 1 if hl else lo
    w.update({k: SH.gathered(p[k]).narrow(0 if k.endswith("_b") else 1, lo,
                                          hi - lo) for k in kv})
    return w, hl, h0 - lo * G


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` in ``o``'s type."""
    B, S, H, hd = o.shape
    return o.reshape(B, S, H * hd) @ wo.reshape(H * hd, wo.shape[-1]).to(
        o.dtype)


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
    ``[B, H, q_chunk, S]``.  Under tensor parallelism ``H`` is the rank's
    tile of the heads (see the module), whose output is summed over the
    group, and ``k_kv`` / ``v_kv`` hold the KV heads they read; a rank
    whose tile of the heads, or of the rows, is empty launches no kernel.
    """
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    tp, first = SH.tile_group(p["wq"], "heads"), 0
    if tp is not None:
        p, H, first = _tp_heads(p, cfg, tp)
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    k_kv, v_kv = k, v
    if cfg.group_size > 1:
        k = torch.repeat_interleave(k, cfg.group_size, dim=2)
        v = torch.repeat_interleave(v, cfg.group_size, dim=2)
    if k.shape[2] != H:
        k, v = k.narrow(2, first, H), v.narrow(2, first, H)
    scale = float(1.0 / np.sqrt(hd))

    def out(o):
        y = _out_proj(o, p["wo"])
        return (y if tp is None else tp.sum(y)), (k_kv, v_kv)

    if H == 0 or B == 0:
        # an empty tile of the heads or of the rows: no launch, zeros [B,
        # S, D] (summed over the group), its weights' gathers still in the
        # graph (their backward's collectives run on every rank)
        return out(q + k + v)
    if cfg.attn_impl == "flash":
        bq = bk = min(max(128, cfg.q_chunk // 8), 512, S)
        qf = q.permute(0, 2, 1, 3).reshape(B * H, S, hd)
        kf = k.permute(0, 2, 1, 3).reshape(B * H, S, hd)
        vf = v.permute(0, 2, 1, 3).reshape(B * H, S, hd)
        of = flash_attention(qf, kf, vf, scale, window, bq, bk)
        return out(of.reshape(B, H, S, hd).permute(0, 2, 1, 3))
    if cfg.attn_impl not in ("naive", "fused"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r} "
                         "(naive | fused | flash)")
    block = _block_fused if cfg.attn_impl == "fused" else _block_naive

    C = min(cfg.q_chunk, S)
    if S % C:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"q chunk {C} (cfg.q_chunk)")
    kpos = torch.arange(S, device=x.device)
    return out(torch.cat([block(q[:, s0:s0 + C], k, v, kpos[s0:s0 + C], kpos,
                                scale, cfg, window)
                          for s0 in range(0, S, C)], dim=1))


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


def _split_softmax(s_: torch.Tensor, seq: SH.TPGroup) -> torch.Tensor:
    """The softmax over the last axis of f32 scores whose slots the ranks
    of ``seq`` hold a block each: the max over the group, the exp against
    it, the sum of exp over the group.  A block wholly masked (``NEG``)
    adds nothing: its exp underflows to 0 against a valid slot's max (the
    new token's own slot is valid on the rank that wrote it)."""
    m = seq.max_(torch.amax(s_, dim=-1, keepdim=True))
    e = torch.exp(s_ - m)
    return e / seq.sum(torch.sum(e, dim=-1, keepdim=True))


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

    **Sequence parallelism.**  Where the cache's entries are a rank's
    shards whose spec splits the slots over ``model`` (``cache_seq``;
    ``parallel.sharding.split_group``), the rank holds slots ``[r W/tp,
    (r+1) W/tp)`` of ``k``, ``v`` and ``slot_pos``: the new token's are
    written only where its slot falls in that block (per row in the
    per-slot layout), the scores run over the block for every q head,
    the softmax's max and sum of exp are taken over the group
    (:func:`_split_softmax`) and the partial ``p·v`` (f32) is summed
    over it.  Every rank computes every head's q and the new K and V
    from ``wq``, ``wk``, ``wv`` gathered whole (one token); where tensor
    parallelism tiles the heads, the rank projects its tile's rows of
    ``wo`` (padded: possibly short or empty) and the output is summed
    over the group.
    """
    B = x.shape[0]
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = cfg.group_size
    seq = SH.split_group(cache["k"], 1)
    k, v, slot_pos = (SH.local_of(cache[n]) for n in ("k", "v", "slot_pos"))
    per_slot = slot_pos.dim() == 2
    Wl = k.shape[1]
    W, r0 = (Wl * seq.size, Wl * seq.index) if seq is not None else (Wl, 0)
    w = {n: SH.gathered(p[n]) for n in ("wq", "wk", "wv", "wq_b", "wk_b",
                                        "wv_b") if n in p}
    pos_t = torch.as_tensor(pos, device=x.device).long()
    if per_slot:
        pos_v = torch.broadcast_to(pos_t, (B,))
        q, k_new, v_new = _qkv(w, x, cfg, pos_v[:, None])
        slot = pos_v % W
        b_idx = torch.arange(B, device=x.device)
        if seq is None:
            k[b_idx, slot] = k_new[:, 0].to(k.dtype)
            v[b_idx, slot] = v_new[:, 0].to(v.dtype)
            slot_pos[b_idx, slot] = pos_v.to(slot_pos.dtype)
        else:
            # a row whose slot lies in another rank's block writes its own
            # block's values back unchanged (one shape on every rank)
            slot = slot - r0
            mine = (slot >= 0) & (slot < Wl)
            slot = slot.clamp(0, Wl - 1)
            k[b_idx, slot] = torch.where(mine[:, None, None],
                                         k_new[:, 0].to(k.dtype),
                                         k[b_idx, slot])
            v[b_idx, slot] = torch.where(mine[:, None, None],
                                         v_new[:, 0].to(v.dtype),
                                         v[b_idx, slot])
            slot_pos[b_idx, slot] = torch.where(
                mine, pos_v.to(slot_pos.dtype), slot_pos[b_idx, slot])
        sp = slot_pos.long()
        valid = (sp >= 0) & (sp <= pos_v[:, None])
        if window:
            valid &= sp > pos_v[:, None] - window
        valid = valid[:, None, None, :]
    else:
        if pos_t.dim() != 0:
            raise ValueError("the shared-slot_pos cache takes a scalar pos, "
                             f"got shape {tuple(pos_t.shape)}")
        # a Python int stays one (no read back, and a meta dry run has
        # no value to read)
        pos_i = pos if isinstance(pos, int) else int(pos_t)
        q, k_new, v_new = _qkv(w, x, cfg, torch.full((B, 1), pos_i,
                                                     device=x.device))
        slot = pos_i % W - r0
        if 0 <= slot < Wl:
            k[:, slot:slot + 1] = k_new.to(k.dtype)
            v[:, slot:slot + 1] = v_new.to(v.dtype)
            slot_pos[slot] = pos_i
        sp = slot_pos.long()
        valid = (sp >= 0) & (sp <= pos_t)
        if window:
            valid &= sp > pos_t - window
        valid = valid[None, None, None, :]

    qg = q.reshape(B, Kv, G, hd)
    s_ = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float())
    s_ = _softcap(s_ / np.sqrt(hd), cfg.attn_logit_softcap)
    s_ = torch.where(valid, s_, NEG)
    if seq is None:
        pr = torch.softmax(s_, dim=-1).to(x.dtype)
        o = torch.einsum("bkgt,btkd->bkgd", pr, v.to(x.dtype))
    else:
        pr = _split_softmax(s_, seq).to(x.dtype)
        o = seq.sum(torch.einsum("bkgt,btkd->bkgd", pr.float(),
                                 v.float())).to(x.dtype)
    o = o.reshape(B, 1, H, hd)
    tp = SH.tile_group(p["wo"], "heads")
    if tp is None:
        return _out_proj(o, SH.gathered(p["wo"])), cache
    h0, hl = tp.block(H)
    return tp.sum(_out_proj(o.narrow(2, h0, hl),
                            SH.tp_tile(p["wo"], 0, tp))), cache


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
    which is what ``jax.nn.gelu`` computes by default.  Under tensor
    parallelism the rank's ``F/tp`` columns, its partial down-projection
    summed over the group (see the module)."""
    tp = SH.tp_group(p[f"{prefix}w_up"])
    if tp is not None:
        p = {f"{prefix}{k}": p[f"{prefix}{k}"].gather((SH.TP_AXIS,))
             for k in MLP_WEIGHTS if f"{prefix}{k}" in p}
    up = _mm(x, p[f"{prefix}w_up"])
    if cfg.mlp_gated:
        g = _mm(x, p[f"{prefix}w_gate"])
        h = F.silu(g) * up
    else:
        h = F.gelu(up, approximate="tanh")
    y = _mm(h, p[f"{prefix}w_down"])
    return y if tp is None else tp.sum(y)
