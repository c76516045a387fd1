"""Serving steps: prefill (full sequence -> cache) and decode (one token).

Both run under ``torch.inference_mode()``: parameters that come out of
training may still require a gradient, and a serving step must build no
autograd graph.  The cache and logits they return are inference tensors,
which later steps may read and update in place inside inference mode.

Both run on whole tensors or on a rank's shards: parameters as
``parallel.sharding.ShardedLeaf`` s (``sharded_leaves``), under the
mesh's ``sharding_context``, gathered a layer at a time with the products
split over ``model`` as in the sharded train step
(``models/transformer.py``).  A prefill's cache then holds the rank's
block of each layer's slots where the rules' ``cache_seq`` splits them,
and its logits the rank's tile of the vocabulary where the head splits
(padded: a trailing rank's may be short or empty);
decode takes the cache as ``ShardedLeaf`` s of its blocks and returns
the blocks, updated in place.

Where the rules put the batch over ``model`` and ``model`` does not
divide a prefill's global batch of ``rows`` (``parallel.sharding.
row_group``), each rank of a ``model`` group runs its padded tile of its
shard's rows (short or empty on trailing ranks) and gathers its logits'
rows back over the group; its cache, whose rows have no ``model``
(``cache_batch``), holds every row of the shard, each layer's gathered
over the group and cut to the rank's block of the slots.  So a prefill
returns its output leaves' blocks, also where ``model`` divides the
batch and each rank ran its own rows."""

from __future__ import annotations

import functools

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as SH


def make_prefill_step(cfg: ModelConfig):
    @torch.inference_mode()
    def prefill_step(params, inputs, rows: int | None = None):
        """inputs: the rank's shard of a batch of ``rows`` rows (where
        ``params`` are its shards; else the whole batch) -> (cache, logits
        [B, 1, V] of the last position).  Where the batch splits over
        ``model`` (see the module) the rank runs its tile of the rows."""
        ops = SH.leaf_ops(params)
        split = SH.row_group(ops, rows)
        group = SH.row_group(ops, rows, "cache_batch")
        if split is not None:
            inputs = {k: split.cut(torch.as_tensor(v))
                      for k, v in inputs.items()}
        relay = None if group is None else (
            group, SH.shard_rows(ops.mesh, "cache_batch", rows))
        logits, cache, _ = T.forward(params, inputs, cfg, mode="prefill",
                                     rows=relay)
        logits = logits[:, -1:]
        if split is not None:
            logits = SH.owned(split.gather(
                logits, 0, SH.shard_rows(ops.mesh, "batch", rows)))
        return cache, logits
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.inference_mode()
    def decode_step(params, cache, tokens, pos):
        """tokens [B,1]; pos a scalar (wave batching) or [B] (continuous
        batching over a per-slot cache) -> (cache, logits [B,1,V]).  The
        cache is updated in place."""
        logits, new_cache, _ = T.forward(params, {"tokens": tokens}, cfg,
                                         mode="decode", cache=cache, pos=pos)
        return new_cache, logits
    return decode_step


# -- shared steps --------------------------------------------------------------
# The reference memoises its jitted steps so that every serving peer of a
# config compiles once.  PyTorch runs eagerly and there is nothing to
# compile; the memo keeps the one step object per config (``ModelConfig``
# is frozen, so it keys the cache directly).  ``donate`` is accepted for
# the reference's signature: decode always updates its cache in place.


@functools.lru_cache(maxsize=None)
def jit_prefill_step(cfg: ModelConfig):
    return make_prefill_step(cfg)


@functools.lru_cache(maxsize=None)
def jit_decode_step(cfg: ModelConfig, donate: bool = False):
    return make_decode_step(cfg)


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def pad_cache_to(cache: dict, target: dict) -> dict:
    """Pad a prefill cache (seq width S) into the decode cache layout
    (width W >= S); ``target`` maps names to shape-and-type specs.  Entries
    whose target has one more axis than the source (the per-slot
    ``slot_pos``, which gains a batch axis in the continuous batching
    layout) are expanded with a singleton batch dim before padding; a
    padded ``slot_pos`` is filled with -1, anything else with 0."""
    out = {}
    for k, tgt in target.items():
        src = cache[k]
        tshape = tuple(tgt.shape)
        if src.dim() == len(tshape) - 1:
            src = src[None] if len(tshape) == 2 else src.unsqueeze(-2)
        if tuple(src.shape) == tshape:
            out[k] = src.to(tgt.dtype)
            continue
        if any(s > t for s, t in zip(src.shape, tshape)) or src.dim() != len(tshape):
            raise ValueError(f"cache entry {k}: {tuple(src.shape)} does not "
                             f"pad to {tshape}")
        fill = -1 if k.endswith("slot_pos") else 0
        dst = torch.full(tshape, fill, dtype=tgt.dtype, device=src.device)
        dst[tuple(slice(0, s) for s in src.shape)] = src.to(tgt.dtype)
        out[k] = dst
    return out
