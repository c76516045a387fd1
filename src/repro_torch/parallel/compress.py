"""Error-feedback int8 gradient compression for reductions over a slow
axis — the reference's ``repro.parallel.compress`` in PyTorch.

The pod axis rides the data-center network, so the cross-pod gradient
all-reduce is the one collective worth compressing.
``compressed_psum_mean`` implements the standard EF-int8 scheme:

    s      = g + err_carry          (error feedback)
    scale  = max|s| / 127           (per-tensor)
    q      = round(s / scale) int8
    err'   = s - q * scale
    out    = mean over axis of dequantized q

The reduce is an all-to-all of int8 chunks (the reduce-scatter's wire
pattern), a local dequantised sum, and an all-gather of the re-quantised
int8 chunk, so int8 is what crosses the wire in both phases.  The
collectives run over the mesh axis's process group; each rank passes its
own gradients (the reference's ``shard_map`` body sees the same).

``quantize8_np`` / ``dequantize8_np``, re-exported here, are the
transport's stateless per-chunk twins (``transport/codec.py``'s ``quant8``
wire codec).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.transport.codec import dequantize8_np, quantize8_np  # noqa: F401
#                      (re-export: the wire-codec twins of the torch pair)


def quantize_ef(g, err):
    s = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(s)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(s / scale), -127, 127).to(torch.int8)
    new_err = s - q.float() * scale
    return q, scale, new_err


def dequantize(q, scale):
    return q.float() * scale


def _all_gather(x, group, n: int):
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.stack(out)


def _ring_mean_int8(q, scale, group, n: int):
    """Mean over ``group`` (``n`` ranks) moving int8 (+ one f32 scale) per
    hop: all-to-all of int8 chunks, local dequant-sum, all-gather int8."""
    flat = q.reshape(n, -1).contiguous()                     # chunk per peer
    chunks = torch.empty_like(flat)      # phase 1: int8 on the wire
    dist.all_to_all_single(chunks, flat, group=group)
    scales = _all_gather(scale.reshape(()), group, n)        # n scalars
    part = torch.sum(chunks.float() * scales[:, None], dim=0) / n
    # phase 2: re-quantize the reduced chunk, all-gather int8
    pscale = torch.clamp(torch.max(torch.abs(part)), min=1e-12) / 127.0
    pq = torch.clamp(torch.round(part / pscale), -127, 127).to(torch.int8)
    allq = _all_gather(pq, group, n)                        # [n, chunk] int8
    alls = _all_gather(pscale, group, n)
    return (allq.float() * alls[:, None]).reshape(q.shape)


def _flatten(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _flatten(v, out)
    else:
        out.append(tree)
    return out


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return next(it)


def compressed_psum_mean(grads, err_tree, mesh, axis: str = "pod"):
    """Compressed mean of a grads tree (dicts, lists) over one mesh axis
    of a ``DeviceMesh``.  Returns (mean_grads_f32, new_err_tree)."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    means, errs = [], []
    for g, e in zip(_flatten(grads, []), _flatten(err_tree, [])):
        ql, sl, ne = quantize_ef(g, e)
        pad = (-ql.numel()) % n
        qf = torch.nn.functional.pad(ql.reshape(-1), (0, pad))
        mean = _ring_mean_int8(qf, sl, group, n)
        means.append(mean[:ql.numel()].reshape(g.shape))
        errs.append(ne)
    return (_unflatten(grads, iter(means)), _unflatten(grads, iter(errs)))
