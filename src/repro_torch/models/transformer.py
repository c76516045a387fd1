"""Unified decoder stack — the reference's ``repro.models.transformer`` in
PyTorch.

The stack is a repeating ``cfg.block_pattern`` super-block run
``cfg.n_super`` times (plus an unrolled remainder); every slot of the
pattern has its own parameters stacked on a leading ``[n_super]`` axis,
in a flat dict keyed ``s{slot}_{name}`` (``t{i}_{name}`` for the
remainder).  The reference's ``lax.scan`` over layers is a Python loop.

Three modes share the block implementations:

* ``train``   — full sequence, no cache.
* ``prefill`` — full sequence, emits a serving cache.
* ``decode``  — one token against the cache, which it updates in place.

In ``train`` mode with grad enabled, each super-block runs under
``cfg.remat``, as the reference's ``_maybe_remat``: ``"none"`` keeps every
activation, ``"block"`` is ``torch.utils.checkpoint`` (non-reentrant),
saving only the block's input and recomputing the rest in the backward,
and ``"dots"`` a selective checkpoint that saves the outputs of the plain
matrix products (``aten.mm``; batched products and everything else are
recomputed), as ``checkpoint_dots_with_no_batch_dims`` does.

This slice carries the dense-attention and SSD blocks (``attn``,
``attn_local``, ``ssd``).  ``attn_moe`` and ``rglru`` blocks raise
``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.utils import checkpoint as C

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

ATTN_KINDS = ("attn", "attn_moe", "attn_local")
_LATER = {"attn_moe": "the MoE block (models/moe.py) is ported with a later "
                      "slice of the model stack",
          "rglru": "the RG-LRU block (models/rglru.py) is ported with a later "
                   "slice of the model stack"}


class TensorSpec(NamedTuple):
    """Shape and type of a cache entry (the reference's ShapeDtypeStruct)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def _not_ported(kind: str):
    if kind in _LATER:
        raise NotImplementedError(f"block kind {kind!r}: {_LATER[kind]}")
    raise ValueError(f"unknown block kind {kind}")


# ---------------------------------------------------------------------------
# specs


def _block_specs(cfg: ModelConfig, kind: str) -> dict[str, L.Spec]:
    D = cfg.d_model
    s: dict[str, L.Spec] = {}
    if kind in ("attn", "attn_local"):
        s.update(L.norm_specs("ln1", D))
        s.update(L.attn_specs(cfg))
        s.update(L.norm_specs("ln2", D))
        s.update(L.mlp_specs(cfg))
    elif kind == "ssd":
        s.update(L.norm_specs("ln1", D))
        s.update(S.ssd_specs(cfg))
    else:
        _not_ported(kind)
    return s


def _stack_specs(specs: dict[str, L.Spec], n: int) -> dict[str, L.Spec]:
    return {k: ((n, *shape), ("stack", *axes)) for k, (shape, axes) in specs.items()}


def param_specs(cfg: ModelConfig) -> dict[str, L.Spec]:
    D, V = cfg.d_model, cfg.vocab_size
    out: dict[str, L.Spec] = {"tok_embed": ((V, D), ("vocab", "embed"))}
    for slot, kind in enumerate(cfg.block_pattern):
        bs = _block_specs(cfg, kind)
        out.update({f"s{slot}_{k}": v for k, v in _stack_specs(bs, cfg.n_super).items()})
    for ti, kind in enumerate(cfg.trailing):
        bs = _block_specs(cfg, kind)
        out.update({f"t{ti}_{k}": v for k, v in bs.items()})
    out.update(L.norm_specs("final", D))
    if not cfg.tie_embeddings:
        out["lm_head"] = ((D, V), ("embed", "vocab"))
    return out


def param_shapes(cfg: ModelConfig) -> dict[str, TensorSpec]:
    return {k: TensorSpec(tuple(shape), cfg.w_dtype)
            for k, (shape, _) in param_specs(cfg).items()}


def param_axes(cfg: ModelConfig) -> dict[str, tuple]:
    return {k: axes for k, (_, axes) in param_specs(cfg).items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters by the reference's rule (see
    :func:`layers.init_from_specs`), drawn from ``generator`` and placed on
    ``device`` in ``cfg.param_dtype``."""
    return L.init_from_specs(param_specs(cfg), generator, cfg.w_dtype,
                             resolve_device(device))


def _cache_entry_specs(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                       per_slot: bool = False):
    if kind in ("attn", "attn_local"):
        W = min(cache_len, cfg.attn_window) if (kind == "attn_local" and cfg.attn_window) else cache_len
        return L.attn_cache_specs(cfg, batch, W, per_slot=per_slot)
    if kind == "ssd":
        return S.ssd_cache_specs(cfg, batch)
    _not_ported(kind)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int, *,
                per_slot: bool = False) -> dict[str, L.Spec]:
    """``per_slot=True`` selects the continuous-batching cache layout:
    attention ``slot_pos`` carries a batch axis so every sequence tracks
    its own ring occupancy (see :func:`layers.attn_cache_specs`)."""
    out: dict[str, L.Spec] = {}
    for slot, kind in enumerate(cfg.block_pattern):
        es = _cache_entry_specs(cfg, kind, batch, cache_len, per_slot)
        out.update({f"s{slot}_{k}": v for k, v in _stack_specs(es, cfg.n_super).items()})
    for ti, kind in enumerate(cfg.trailing):
        es = _cache_entry_specs(cfg, kind, batch, cache_len, per_slot)
        out.update({f"t{ti}_{k}": v for k, v in es.items()})
    return out


def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int, *,
                 per_slot: bool = False) -> dict[str, TensorSpec]:
    out = {}
    for n, (shape, _) in cache_specs(cfg, batch, cache_len, per_slot=per_slot).items():
        if n.endswith("slot_pos"):
            out[n] = TensorSpec(shape, torch.int32)
        elif n.endswith("state") or n.endswith("h"):
            out[n] = TensorSpec(shape, torch.float32)
        else:
            out[n] = TensorSpec(shape, cfg.act_dtype)
    return out


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               per_slot: bool = False, device="cuda") -> dict:
    dev = resolve_device(device)
    out = {}
    for n, sd in cache_shapes(cfg, batch, cache_len, per_slot=per_slot).items():
        if n.endswith("slot_pos"):
            out[n] = torch.full(sd.shape, -1, dtype=torch.int32, device=dev)
        else:
            out[n] = torch.zeros(sd.shape, dtype=sd.dtype, device=dev)
    return out


def _sub(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# block forward


def _attn_seq_with_cache(p, x, cfg, kind, want_cache: bool):
    window = cfg.attn_window if kind == "attn_local" else 0
    y, (k, v) = L.attention_seq_kv(p, x, cfg, window=window)
    if not want_cache:
        return y, None
    Sq = x.shape[1]
    if window and Sq > window:
        k, v = k[:, -window:], v[:, -window:]
        slot_pos = torch.arange(Sq - window, Sq, dtype=torch.int32, device=x.device)
    else:
        slot_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
    return y, {"k": k, "v": v, "slot_pos": slot_pos}


def block_fwd(kind: str, cfg: ModelConfig, p: dict, x, *, mode: str, pos=None,
              cache=None):
    """Returns (x, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("attn", "attn_local"):
        window = cfg.attn_window if kind == "attn_local" else 0
        h = L.rmsnorm(x, p["ln1_scale"], cfg.norm_eps)
        if mode == "decode":
            a, new_cache = L.attention_decode(p, h, cfg, cache, pos, window=window)
        else:
            a, new_cache = _attn_seq_with_cache(p, h, cfg, kind, mode == "prefill")
        x = x + a
        h = L.rmsnorm(x, p["ln2_scale"], cfg.norm_eps)
        x = x + L.mlp(p, h, cfg)
        return x, new_cache, aux
    if kind == "ssd":
        h = L.rmsnorm(x, p["ln1_scale"], cfg.norm_eps)
        if mode == "decode":
            y, new_cache = S.ssd_decode(p, h, cfg, cache)
        else:
            y, new_cache = S.ssd_seq_cached(p, h, cfg, want_cache=mode == "prefill")
        return x + y, new_cache, aux
    _not_ported(kind)


# ---------------------------------------------------------------------------
# stack forward


def _embed_inputs(params, inputs, cfg: ModelConfig):
    emb = params["tok_embed"]
    tokens = torch.as_tensor(inputs["tokens"], device=emb.device).long()
    x = emb[tokens].to(cfg.act_dtype)
    if cfg.ext_embed_len and "ext_embed" in inputs:  # decode past the prefix: tokens only
        ext = torch.as_tensor(inputs["ext_embed"], device=emb.device).to(cfg.act_dtype)
        x = torch.cat([ext, x], dim=1)
    return x


REMAT_MODES = ("none", "block", "dots")
_DOTS = (torch.ops.aten.mm.default,)       # products with no batch dims


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return C.CheckpointPolicy.MUST_SAVE
    return C.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig):
    if cfg.remat not in REMAT_MODES:
        raise ValueError(f"unknown remat {cfg.remat!r} (none | block | dots)")
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            C.create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(C.checkpoint, fn, use_reentrant=False, **kw)


def forward(params: dict, inputs: dict, cfg: ModelConfig, *, mode: str = "train",
            cache: dict | None = None, pos=None):
    """Run the stack.  Returns (logits f32, new_cache, aux_loss).

    inputs: {"tokens": [B,S] integers, optional "ext_embed": [B,L,D]}.
    decode mode: tokens is [B,1]; ``pos`` is a scalar position, or a
    ``[B]`` vector when the cache uses the per-slot (continuous batching)
    layout — see :func:`cache_specs`.  Decode writes into ``cache``'s
    tensors and returns the same tensors as the new cache.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r} (train | prefill | decode)")
    if mode == "decode" and cache is None:
        raise ValueError("decode mode needs a cache")
    x = _embed_inputs(params, inputs, cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: dict = {}
    pattern = cfg.block_pattern

    def super_fwd(x, slot_params, slot_caches):
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        outs = {}
        for slot, kind in enumerate(pattern):
            c = slot_caches[slot] if slot_caches is not None else None
            x, nc, aux = block_fwd(kind, cfg, slot_params[slot], x, mode=mode,
                                   pos=pos, cache=c)
            if nc is not None:
                outs[slot] = nc
            aux_sum = aux_sum + aux
        return x, outs, aux_sum

    body = super_fwd
    if mode == "train" and torch.is_grad_enabled():
        body = _maybe_remat(super_fwd, cfg)
    # one unbind per stacked leaf: its backward stacks the layers' gradients
    # once, where indexing each layer would scatter into a zero tensor of
    # the whole stack per layer
    stacked = [{k: v.unbind(0) for k, v in _sub(params, f"s{slot}_").items()}
               for slot in range(len(pattern))]
    cache_stacked = ([_sub(cache, f"s{slot}_") for slot in range(len(pattern))]
                     if mode == "decode" else None)
    layer_caches: dict[str, list] = {}
    for i in range(cfg.n_super):
        sp = [{k: v[i] for k, v in st.items()} for st in stacked]
        c = ([{k: v[i] for k, v in cs.items()} for cs in cache_stacked]
             if cache_stacked is not None else None)
        x, outs, aux = body(x, sp, c)
        aux_total = aux_total + aux
        if mode == "prefill":
            for slot, nc in outs.items():
                for k, v in nc.items():
                    layer_caches.setdefault(f"s{slot}_{k}", []).append(v)
    if mode == "prefill":
        new_cache = {k: torch.stack(v) for k, v in layer_caches.items()}
    elif mode == "decode" and cfg.n_super > 0:
        new_cache = {k: v for k, v in cache.items() if k.startswith("s")}

    for ti, kind in enumerate(cfg.trailing):
        c = _sub(cache, f"t{ti}_") if (cache and mode == "decode") else None
        x, nc, aux = block_fwd(kind, cfg, _sub(params, f"t{ti}_"), x,
                               mode=mode, pos=pos, cache=c)
        aux_total = aux_total + aux
        if nc is not None:
            for k, v in nc.items():
                new_cache[f"t{ti}_{k}"] = v

    x = L.rmsnorm(x, params["final_scale"], cfg.norm_eps)
    head = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x.float() @ head.to(x.dtype).float()
    return logits, (new_cache if new_cache else None), aux_total
