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

``params`` holds whole tensors, or a rank's shards of them
(``parallel.sharding.ShardedLeaf``, the sharded launcher's step): a
shard is gathered where it is used, a super-block's leaves just before
the block runs (inside its remat), the embedding, ``final_scale`` and
the head where they are read, so that outside the running block a rank
holds only its shards.  Where ``model`` splits a product (tensor
parallelism, ``parallel.sharding.tp_group``), attention, the MLPs and
the MoE's shared expert gather their leaves keeping ``model``
(``layers.py``; attention's q heads in padded tiles where ``model`` does
not divide them, ``parallel.sharding.tile_group``), and so do the RG-LRU
and the SSD mixer where ``model`` splits every one of their own leaves
(``rglru.tp_split``, ``ssm.tp_split``, asked once a block by
:func:`_gather_block`, which hands the block its group; else they are
gathered whole and run whole); the head projects to the rank's tile of
the vocabulary, f32 logits ``[B, S, ceil(V/tp)]`` or fewer on trailing
ranks (:func:`head_split`; ``train/step.py``'s ``cross_entropy`` takes
it), so that no rank holds f32 logits over the whole vocabulary.  The
embedding, the norms and the SSD's B and C leaves are gathered whole.
Whole tensors run the same code, op for op.

Serving on a rank's shards (``train/serve.py``'s steps) runs the same
way, and its KV cache follows the reference's ``cache_seq`` rule: where
it splits a cache's slots over ``model``, a prefill keeps each layer's
block of K, V and slot positions (cut right after the layer, so no rank
holds every layer's whole cache), and decode takes the cache as the
rank's shards and runs attention sequence-parallel over them
(``layers.attention_decode``).  A split RG-LRU's or SSD's prefill cache
is the rank's block of its channels or heads, and its decode runs on the
cache's blocks in place (the SSD's conv window gathered whole and cut
back).  Their caches where the block runs whole, and a cache split
otherwise, are gathered whole but their rows for the block and its block
written back; a prefill returns those whole.

In ``train`` mode with grad enabled, each super-block runs under
``cfg.remat``, as the reference's ``_maybe_remat``: ``"none"`` keeps every
activation, ``"block"`` is ``torch.utils.checkpoint`` (non-reentrant),
saving only the block's input and recomputing the rest in the backward
(under the forward's sharding context: on the card the backward runs in
another thread), and ``"dots"`` a selective checkpoint that saves the outputs of the plain
matrix products (``aten.mm``; batched products and everything else are
recomputed), as ``checkpoint_dots_with_no_batch_dims`` does.

The block kinds are the reference's: ``attn`` and ``attn_local``
(attention, a sliding window for the latter, then an MLP), ``attn_moe``
(attention, then the MoE FFN of :mod:`models.moe`, whose aux loss is
summed into the forward's), ``ssd`` (the Mamba-2 mixer of
:mod:`models.ssm`) and ``rglru`` (the RG-LRU recurrence of
:mod:`models.rglru`, then an MLP).  An unknown kind raises
``ValueError``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.utils import checkpoint as C

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as SH

ATTN_KINDS = ("attn", "attn_moe", "attn_local")


class TensorSpec(NamedTuple):
    """Shape and type of a cache entry (the reference's ShapeDtypeStruct)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# specs


def _block_specs(cfg: ModelConfig, kind: str) -> dict[str, L.Spec]:
    D = cfg.d_model
    s: dict[str, L.Spec] = {}
    if kind in ATTN_KINDS:
        s.update(L.norm_specs("ln1", D))
        s.update(L.attn_specs(cfg))
        s.update(L.norm_specs("ln2", D))
        if kind == "attn_moe":
            s.update(M.moe_specs(cfg))
        else:
            s.update(L.mlp_specs(cfg))
    elif kind == "ssd":
        s.update(L.norm_specs("ln1", D))
        s.update(S.ssd_specs(cfg))
    elif kind == "rglru":
        s.update(L.norm_specs("ln1", D))
        s.update(R.rglru_specs(cfg))
        s.update(L.norm_specs("ln2", D))
        s.update(L.mlp_specs(cfg))
    else:
        raise ValueError(f"unknown block kind {kind}")
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
    if kind in ATTN_KINDS:
        W = min(cache_len, cfg.attn_window) if (kind == "attn_local" and cfg.attn_window) else cache_len
        return L.attn_cache_specs(cfg, batch, W, per_slot=per_slot)
    if kind == "ssd":
        return S.ssd_cache_specs(cfg, batch)
    if kind == "rglru":
        return R.rglru_cache_specs(cfg, batch)
    raise ValueError(f"unknown block kind {kind}")


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


def cache_axes(cfg: ModelConfig, batch: int, cache_len: int, *,
               per_slot: bool = False) -> dict[str, tuple]:
    """The logical axes of each cache entry (the launchers' sharding)."""
    return {n: axes for n, (_, axes) in
            cache_specs(cfg, batch, cache_len, per_slot=per_slot).items()}


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


def _attn_seq_with_cache(p, x, cfg, kind, want_cache: bool, ops=None,
                         rows=None):
    """Attention over the sequence and, for a prefill, its serving cache:
    the last ``attn_window`` positions of a local layer, else all of
    them; of those slots the rank's block where the cache's ``cache_seq``
    splits them over ``model`` (``parallel.sharding.cache_seq_group`` on
    ``ops``, the rank's shards'), a copy that owns only the block's
    bytes.  Where tensor parallelism left the rank only the KV heads its
    q heads read, the block's K and V of every KV head come from the
    layer's input over the block's positions (``layers.cache_kv``).
    With ``rows`` (:func:`forward`'s: ``x`` is the rank's tile of the
    cache's rows) the group's K and V of those positions are gathered
    over the rows first, then cut to the block."""
    window = cfg.attn_window if kind == "attn_local" else 0
    y, (k, v) = L.attention_seq_kv(p, x, cfg, window=window)
    if not want_cache:
        return y, None
    Sq = x.shape[1]
    W = window if window and Sq > window else Sq
    seq = SH.cache_seq_group(ops, W)
    lo, n = seq.block(W) if seq is not None else (0, W)
    first = Sq - W + lo             # the position in the rank's first slot
    slot_pos = torch.arange(first, first + n, dtype=torch.int32,
                            device=x.device)
    if rows is not None:
        if k.shape[2] != cfg.num_kv_heads:
            raise ValueError("a prefill splits its rows or its KV heads "
                             "over model, not both")
        group, n_rows = rows
        k, v = (SH.owned(group.gather(t[:, Sq - W:], 0, n_rows)
                         .narrow(1, lo, n)) for t in (k, v))
        return y, {"k": k, "v": v, "slot_pos": slot_pos}
    if k.shape[2] != cfg.num_kv_heads:
        k, v = L.cache_kv(p, x[:, first:first + n], cfg, first)
    else:
        k, v = k[:, first:first + n], v[:, first:first + n]
        if seq is not None:
            k, v = k.clone(), v.clone()
    return y, {"k": k, "v": v, "slot_pos": slot_pos}


def _whole_cache(kind: str, cache: dict, tp) -> dict | None:
    """A decode cache of a rank's shards (``parallel.sharding.ShardedLeaf``)
    gathered over every axis but its rows' (``cache_batch``) where its
    block runs on whole entries, or None where it runs the shards as
    they are: none is a shard; attention's where its slots split over
    ``model`` (``layers.attention_decode`` runs sequence-parallel); an
    RG-LRU's split over ``tp`` (:func:`_gather_block`'s).  An SSD's split
    over ``tp`` keeps its state's block and gathers its conv window."""
    if not any(isinstance(v, SH.ShardedLeaf) for v in cache.values()) or (
            kind in ATTN_KINDS and SH.split_group(cache["k"], 1) is not None
    ) or (kind == "rglru" and tp is not None):
        return None
    keep = SH.current_rules().get("cache_batch")
    own = ("state",) if kind == "ssd" and tp is not None else ()
    return {k: v if not isinstance(v, SH.ShardedLeaf) else v.local
            if k in own else v.gather(keep) for k, v in cache.items()}


def _put_back(cache: dict, whole: dict) -> None:
    """The rank's block of each entry of ``whole`` (:func:`_whole_cache`,
    updated in place by the block) written back into its shard."""
    keep = SH.current_rules().get("cache_batch")
    for k, v in cache.items():
        if isinstance(v, SH.ShardedLeaf) and whole[k] is not v.local:
            v.local.copy_(v.ops.block(whole[k], v.layout(keep)))


def block_fwd(kind: str, cfg: ModelConfig, p: dict, x, *, mode: str, pos=None,
              cache=None, ops=None, tp=None, rows=None):
    """Returns (x, new_cache, aux_loss).  ``ops``: the rank's
    ``MeshOps`` where ``p`` holds its shards (a prefill cuts its cache to
    the rank's block of slots).  ``tp``: the group over which an RG-LRU
    or SSD block runs split (:func:`_gather_block`'s), else None.
    ``rows``: :func:`forward`'s."""
    if mode == "decode":
        whole = _whole_cache(kind, cache, tp)
        if whole is not None:
            x, _, aux = block_fwd(kind, cfg, p, x, mode=mode, pos=pos,
                                  cache=whole, tp=tp)
            _put_back(cache, whole)
            return x, cache, aux
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ATTN_KINDS:
        window = cfg.attn_window if kind == "attn_local" else 0
        h = L.rmsnorm(x, p["ln1_scale"], cfg.norm_eps)
        if mode == "decode":
            a, new_cache = L.attention_decode(p, h, cfg, cache, pos, window=window)
        else:
            a, new_cache = _attn_seq_with_cache(p, h, cfg, kind,
                                                mode == "prefill", ops, rows)
        x = x + a
        h = L.rmsnorm(x, p["ln2_scale"], cfg.norm_eps)
        if kind == "attn_moe":
            y, aux = M.moe_ffn(p, h, cfg, rows=rows)
        else:
            y = L.mlp(p, h, cfg)
        return x + y, new_cache, aux
    if kind == "ssd":
        h = L.rmsnorm(x, p["ln1_scale"], cfg.norm_eps)
        if mode == "decode":
            y, new_cache = S.ssd_decode(p, h, cfg, cache, tp)
        else:
            y, new_cache = S.ssd_seq_cached(p, h, cfg, tp=tp,
                                            want_cache=mode == "prefill")
        return x + y, _rows_gathered(new_cache, rows), aux
    if kind == "rglru":
        h = L.rmsnorm(x, p["ln1_scale"], cfg.norm_eps)
        if mode == "decode":
            y, new_cache = R.rglru_decode(p, h, cfg, cache, tp)
        else:
            y, new_cache = R.rglru_seq_cached(p, h, cfg, tp=tp,
                                              want_cache=mode == "prefill")
        x = x + y
        h = L.rmsnorm(x, p["ln2_scale"], cfg.norm_eps)
        return x + L.mlp(p, h, cfg), _rows_gathered(new_cache, rows), aux
    raise ValueError(f"unknown block kind {kind}")


def _rows_gathered(cache: dict | None, rows) -> dict | None:
    """A prefill's RG-LRU or SSD cache of the rank's tile of the rows
    gathered over ``rows``' group to all of them (:func:`forward`'s
    ``rows``), in tensors that own only their bytes (the gather's padding
    cut); the cache itself without ``rows``."""
    if cache is None or rows is None:
        return cache
    group, n = rows
    return {k: SH.owned(group.gather(v, 0, n)) for k, v in cache.items()}


# ---------------------------------------------------------------------------
# stack forward


def _embed_inputs(params, inputs, cfg: ModelConfig):
    emb = SH.gathered(params["tok_embed"])
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


_TP_WEIGHTS = L.TP_WEIGHTS + M.SHARED_WEIGHTS
_SPLIT_BLOCKS = {"rglru": R, "ssd": S}     # kind -> its TP_WEIGHTS, tp_split


def _gather_block(p: dict, kind: str, cache=None):
    """(leaves, tp): a block's leaves gathered whole where they are a
    rank's shards (``parallel.sharding.ShardedLeaf``), but those a module
    gathers itself (the experts' weights: the MoE keeps them split over
    ``model``; attention's, the MLP's and the shared expert's where
    ``model`` splits their products, attention's q-head leaves also where
    it tiles them padded) and the RG-LRU's or SSD's own where
    the block runs split, gathered keeping ``model``; whole tensors pass
    unchanged.  ``tp`` is the group over which that block runs split, its
    module's ``tp_split`` of its leaves and decode ``cache``, decided
    here alone; else None."""
    mod = _SPLIT_BLOCKS.get(kind)
    tp = mod.tp_split(p, cache) if mod is not None else None
    own = mod.TP_WEIGHTS if tp is not None else ()

    def module_gathers(k, v):
        return k in M.EXPERT_WEIGHTS or k in _TP_WEIGHTS and (
            SH.tp_group(v) is not None or k in L.HEAD_DIMS
            and SH.tile_group(v, "heads") is not None)

    return {k: v.gather((SH.TP_AXIS,)) if k in own else v
            if module_gathers(k, v) else SH.gathered(v)
            for k, v in p.items()}, tp


def head_split(params: dict, cfg: ModelConfig):
    """The group (``parallel.sharding.TPGroup``) whose ranks each project
    to their padded tile of the vocabulary (``TPGroup.block``), where the
    rules split ``vocab`` over ``model`` (``parallel.sharding.tile_group``
    of ``lm_head``, or of the tied ``tok_embed``); else None."""
    return SH.tile_group(params["tok_embed" if cfg.tie_embeddings
                                else "lm_head"], "vocab")


def _maybe_remat(fn, cfg: ModelConfig):
    if cfg.remat not in REMAT_MODES:
        raise ValueError(f"unknown remat {cfg.remat!r} (none | block | dots)")
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            C.create_selective_checkpoint_contexts, _dots_policy)

    def remat(*args):
        # the backward recomputes ``fn``, on the card in the autograd
        # engine's device thread, where the forward's thread-local sharding
        # context is not installed (the MoE would recompute its dense path
        # there): recompute under the forward's mesh and rules
        ctx = SH.sharding_context(SH.current_mesh(), SH.current_rules())

        def in_forward_context(*a):
            with ctx:
                return fn(*a)

        return C.checkpoint(in_forward_context, *args, use_reentrant=False,
                            **kw)

    return remat


def forward(params: dict, inputs: dict, cfg: ModelConfig, *, mode: str = "train",
            cache: dict | None = None, pos=None, rows=None):
    """Run the stack.  Returns (logits f32, new_cache, aux_loss); the
    logits over the rank's tile of the vocabulary where
    :func:`head_split` gives a group.

    inputs: {"tokens": [B,S] integers, optional "ext_embed": [B,L,D]}.
    decode mode: tokens is [B,1]; ``pos`` is a scalar position, or a
    ``[B]`` vector when the cache uses the per-slot (continuous batching)
    layout — see :func:`cache_specs`.  Decode writes into ``cache``'s
    tensors and returns the same tensors as the new cache.

    ``rows``: ``(group, n)`` where the inputs are the rank's padded tile
    (``TPGroup.block``) of ``n`` rows that the ranks of ``group`` split
    (``parallel.sharding.row_group``; a tile may be short or empty): the
    MoE's bins hold the group's widest tile's tokens, and a prefill's
    cache holds all ``n`` rows, each layer's entries gathered over the
    group (attention's then cut to the rank's block of the slots).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r} (train | prefill | decode)")
    if mode == "decode" and cache is None:
        raise ValueError("decode mode needs a cache")
    x = _embed_inputs(params, inputs, cfg)
    ops = SH.leaf_ops(params)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: dict = {}
    pattern = cfg.block_pattern

    def super_fwd(x, slot_params, slot_caches):
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        outs = {}
        for slot, kind in enumerate(pattern):
            c = slot_caches[slot] if slot_caches is not None else None
            bp, tp = _gather_block(slot_params[slot], kind, c)
            x, nc, aux = block_fwd(kind, cfg, bp, x, mode=mode, pos=pos,
                                   cache=c, ops=ops, tp=tp, rows=rows)
            del bp
            if nc is not None:
                outs[slot] = nc
            aux_sum = aux_sum + aux
        return x, outs, aux_sum

    body = super_fwd
    if mode == "train" and torch.is_grad_enabled():
        body = _maybe_remat(super_fwd, cfg)
    # one unbind per stacked leaf: its backward stacks the layers' gradients
    # once, where indexing each layer would scatter into a zero tensor of
    # the whole stack per layer.  A rank's shard unbinds into its layers'
    # shards, each gathered inside ``body`` (under remat, again in the
    # recompute) and dropped after its block
    stacked = [{k: v.unbind(0) for k, v in _sub(params, f"s{slot}_").items()}
               for slot in range(len(pattern))]
    cache_stacked = ([{k: v.unbind(0) for k, v in
                       _sub(cache, f"s{slot}_").items()}
                      for slot in range(len(pattern))]
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
        new_cache = {k: SH.local_of(v) for k, v in cache.items()
                     if k.startswith("s")}

    for ti, kind in enumerate(cfg.trailing):
        c = _sub(cache, f"t{ti}_") if (cache and mode == "decode") else None
        p, tp = _gather_block(_sub(params, f"t{ti}_"), kind, c)
        x, nc, aux = block_fwd(kind, cfg, p, x, mode=mode, pos=pos, cache=c,
                               ops=ops, tp=tp, rows=rows)
        del p
        aux_total = aux_total + aux
        if nc is not None:
            for k, v in nc.items():
                new_cache[f"t{ti}_{k}"] = SH.local_of(v)

    x = L.rmsnorm(x, SH.gathered(params["final_scale"]), cfg.norm_eps)
    tp = head_split(params, cfg)
    head = (SH.tp_tile(params["tok_embed"], 0, tp).T if cfg.tie_embeddings
            else SH.tp_tile(params["lm_head"], 1, tp))
    logits = x.float() @ head.to(x.dtype).float()
    return logits, (new_cache if new_cache else None), aux_total
