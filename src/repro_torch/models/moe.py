"""Mixture-of-experts FFN — the reference's ``repro.models.moe`` in PyTorch.

With no mesh (or a mesh without a ``model`` axis, or an
``AbstractMesh`` with whole weights, which has no collectives to run),
``moe_ffn`` takes ``_moe_dense_fallback``
(``src/repro/models/moe.py:240-261``): a GShard-style router (f32
logits, softmax, top-k renormalised), tokens binned into per-expert
capacity buffers of ``max(4, ceil(t·k·cf/E))`` slots, one grouped
product over all experts, the outputs gathered back and weighted, plus
Llama-4's shared expert through ``layers.mlp``.

Under a ``sharding_context`` whose mesh has a ``model`` axis it takes
the reference's expert-parallel paths (``:115-237``), with collectives
over the mesh's axes in place of ``shard_map``: those of the expert
leaves' ``MeshOps`` where they are a rank's shards
(``parallel.sharding.ShardedLeaf``; on the dry run's ``AbstractMesh``
its ``DryOps``, which move nothing), else ``MeshOps`` over the
``DeviceMesh``'s process groups.  The rank's place on ``model`` and
``data`` is the ops' ``coordinate()``.  ``x`` is the rank's own shard of
the batch over the rules' batch axes (the launcher feeds each rank its
shard), so where the reference's ``shard_map`` slices the batch by its
``in_specs``, the port is handed the slice:

* ``a2a`` (train / prefill): each model rank takes its slice of the
  sequence (``moe_seq_shard`` takes the same slice, the reference's
  in-spec; the numbers are the same), routes it, bins the copies for all
  E experts, exchanges the bins with one ``all_to_all`` over ``model``,
  runs its ``E/ep`` local experts, sends the outputs back with the
  reverse ``all_to_all``, combines, and ``all_gather``s the sequence.
  Under ``dp_over_model`` (the rules' batch over ``model`` too) every
  rank owns distinct tokens: no slice, no gather.
* ``psum`` (decode: fewer tokens a rank than ``ep``): every rank applies
  its own experts to all its tokens and an ``all_reduce`` over ``model``
  sums the contributions.
* ``moe_expert_resident``: each rank keeps an F-shard of its experts
  (``E/ep`` over ``model``, ``F/dp`` over ``data``); the tokens are
  ``all_gather``ed over ``data`` to visit them and the partial
  down-projections reduce-scattered back.
* ``aux`` is the mean over the ranks along ``model`` and each batch
  axis, weighted by their tokens: the reference's ``pmean`` where every
  rank has as many, and a rank with none adds nothing.  Where the batch
  splits over ``model`` in padded tiles (``parallel.sharding.row_group``:
  tiles of unequal width, some empty), the bins hold the widest tile's
  tokens, so that every rank exchanges the same.

**Gradients.**  The collectives are differentiable, each backward its
forward's adjoint (``all_gather`` <-> sum-and-slice, ``all_reduce`` sum
<-> itself, ``all_to_all`` <-> the reverse ``all_to_all``, a slice <->
zero padding).  So rank r's gradient is the derivative of the sum of
every rank's loss with respect to r's copy of the parameters, and the
mean of the ranks' gradients is the gradient of the mean over the batch
shards' losses: ``tests/test_torch_parallel.py`` holds it to world size
1's.  The sharded launcher hands the experts' weights over as the rank's
shards (``parallel.sharding.ShardedLeaf``): the expert-parallel paths
gather them over every axis but ``model`` (and ``data`` where it splits
F on the resident path), and the gather's backward sums each block's
gradient over the ranks that hold it, so no rank holds every expert;
the dense fallback gathers them whole.  The shared expert is
``layers.mlp``, split over ``model`` as any MLP (tensor parallelism).

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
from repro_torch.parallel.sharding import (AbstractMesh, AllGather,
                                           AllReduce, AllToAll, MeshOps,
                                           ReduceScatter, ShardedLeaf,
                                           current_mesh, current_rules,
                                           gathered, mesh_shape)

#: the leaves the MoE gathers itself when they are a rank's shards: the
#: expert-parallel paths keep the experts split over ``model``
EXPERT_WEIGHTS = ("we_gate", "we_up", "we_down")
#: the shared expert's, which ``layers.mlp`` splits over ``model`` as an
#: MLP's (tensor parallelism)
SHARED_WEIGHTS = ("ws_gate", "ws_up", "ws_down")


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
    """GShard load-balance loss: E * sum_e f_e * p_e; 0 over no token."""
    E = cfg.num_experts
    if not top_e.shape[0]:
        return probs.sum()
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
    # each expert's first place in the sorted ids (a shape-stable bincount:
    # it runs on meta tensors too)
    starts = torch.searchsorted(e_sorted, torch.arange(n_exp,
                                                       device=e_flat.device))
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


def _expert_ffn_src(recv, wg, wu, wd):
    """recv: [src, E_loc, N, D] -> [src, E_loc, N, D]: each local expert's
    rows from every source rank in one product."""
    n_src, e, n, d = recv.shape
    rows = recv.transpose(0, 1).reshape(e, n_src * n, d)
    out = _expert_ffn(rows, wg, wu, wd)
    return out.reshape(e, n_src, n, d).transpose(0, 1)


def _combine(out_buf, slot, comb_w, t: int, k: int):
    """Gather expert outputs back per token-slot and weight-combine.
    Dropped slots carry weight 0; their (clamped) gather reads are
    ignored."""
    D = out_buf.shape[-1]
    flat = out_buf.reshape(-1, D)
    safe = torch.clamp(slot, max=flat.shape[0] - 1)
    return (flat[safe].reshape(t, k, D)
            * comb_w.reshape(t, k, 1).to(flat.dtype)).sum(dim=1)


def moe_ffn(p, x, cfg, prefix: str = "", rows=None):
    """x: [B,S,D] -> (y [B,S,D], aux_loss f32 scalar).  Under a mesh with a
    ``model`` axis, ``x`` is this rank's batch shard and the
    expert-parallel paths run over :func:`expert_ops`' collectives (see
    the module's docstring); otherwise, or where there are none to run
    (an :class:`AbstractMesh` with whole weights), the reference's
    ``_moe_dense_fallback``.  ``rows`` (``transformer.forward``'s
    ``(group, n)``): ``x`` is the rank's padded tile of ``n`` rows split
    over ``model``, maybe short or empty; the bins every rank exchanges
    hold the widest tile's tokens.  ``aux`` is every rank's, the mean over
    ranks weighted by their tokens (a rank with none adds nothing)."""
    ops = expert_ops(p, prefix, current_mesh())
    if ops is None:
        return _moe_dense_fallback(p, x, cfg, prefix)
    sizes = ops.sizes
    B, S, D = x.shape
    ep = sizes["model"]
    batch_rule = current_rules().get("batch")
    dp_over_model = "model" in batch_rule
    # the axes over which ranks hold other tokens, or the same (aux's mean)
    axes = (tuple(a for a in batch_rule if a in sizes) if dp_over_model
            else ("model",) + tuple(a for a in ("pod", "data") if a in sizes))
    E, k = cfg.num_experts, cfg.experts_per_token
    if E % ep:
        raise ValueError(f"experts {E} must divide EP size {ep}")
    e_loc = E // ep
    use_a2a = dp_over_model or (S % ep == 0 and B * S >= ep)
    resident = (cfg.moe_expert_resident and "data" in sizes
                and cfg.moe_hidden % sizes["data"] == 0)

    coord = ops.coordinate()
    mi = coord["model"]
    es = slice(mi * e_loc, (mi + 1) * e_loc)
    fs = None
    if resident:
        f_loc = cfg.moe_hidden // sizes["data"]
        fs = slice(coord["data"] * f_loc, (coord["data"] + 1) * f_loc)
    wg = _local_experts(p[f"{prefix}we_gate"], es, fs, 2)
    wu = _local_experts(p[f"{prefix}we_up"], es, fs, 2)
    wd = _local_experts(p[f"{prefix}we_down"], es, fs, 1)

    if use_a2a and not dp_over_model:
        x_tok = x[:, mi * (S // ep):(mi + 1) * (S // ep)].reshape(-1, D)
    else:
        x_tok = x.reshape(-1, D)
    t = x_tok.shape[0]
    top_p, top_e, probs = _router(x_tok, p[f"{prefix}router"], cfg)
    aux = _aux_loss(probs, top_e, cfg)

    if use_a2a:
        widest = t if rows is None else -(-rows[1] // rows[0].size) * S
        cap = capacity(widest, cfg)
        buf, comb_w, slot = _bin_tokens(x_tok, top_p, top_e, E, cap)
        recv = AllToAll.apply(buf.reshape(ep, e_loc * cap, D), ops, "model")
        recv = recv.reshape(ep, e_loc, cap, D)   # [src, e, cap, D]
        if resident:
            # tokens visit the resident F-shards: gather over data, partial
            # down-projection, reduce-scatter back to the owning data rank
            recv_all = AllGather.apply(recv, ops, "data", 2)
            out = ReduceScatter.apply(
                _expert_ffn_src(recv_all, wg, wu, wd), ops, "data", 2)
        else:
            out = _expert_ffn_src(recv, wg, wu, wd)
        back = AllToAll.apply(out.reshape(ep, e_loc * cap, D), ops,
                              "model")
        y_tok = _combine(back, slot, comb_w, t, k)
        if dp_over_model:
            y = y_tok.reshape(B, S, D)      # tokens never left their owner
        else:
            y = AllGather.apply(y_tok.reshape(B, S // ep, D), ops, "model",
                                1)
    else:
        # psum path: every rank applies its resident experts to all tokens
        cap = t * k  # no drops
        owned = (top_e // e_loc) == mi
        local_e = torch.where(owned, top_e % e_loc, 0)
        p_masked = torch.where(owned, top_p, 0.0)
        buf, comb_w, slot = _bin_tokens(x_tok, p_masked, local_e, e_loc, cap)
        buf = buf.reshape(e_loc, cap, D)
        if resident:
            h = _expert_ffn(AllGather.apply(buf, ops, "data", 1), wg, wu, wd)
            out = ReduceScatter.apply(h, ops, "data", 1)
        else:
            out = _expert_ffn(buf, wg, wu, wd)
        y_tok = _combine(out, slot, comb_w, t, k)
        y = AllReduce.apply(y_tok.reshape(B, S, D), ops, "model", False)
    # sum of aux x tokens and of tokens over every rank, in one reduction
    tot = torch.stack([aux * t, aux.new_tensor(float(t))])
    for a in axes:
        tot = AllReduce.apply(tot, ops, a, False)
    aux = tot[0] / tot[1]

    if cfg.shared_expert:
        y = y + _shared(p, x, cfg, prefix)
    return y, aux


def expert_ops(p, prefix: str, mesh) -> MeshOps | None:
    """The collectives the expert-parallel paths run: the expert leaves'
    own where they are a rank's shards (``ShardedLeaf``, as
    ``parallel.sharding.tp_group`` takes a leaf's), else ``MeshOps`` over
    ``mesh``'s process groups.  None where the paths do not run: no mesh,
    no ``model`` axis, or an :class:`AbstractMesh` (no process group)
    with whole weights."""
    if mesh is None or "model" not in mesh_shape(mesh):
        return None
    w = p[f"{prefix}we_gate"]
    if isinstance(w, ShardedLeaf):
        return w.ops
    return None if isinstance(mesh, AbstractMesh) else MeshOps(mesh)


def _local_experts(w, es: slice, fs: slice | None, f_dim: int):
    """The rank's experts of ``w`` (block ``es`` of its leading axis), cut
    to the F block ``fs`` along ``f_dim`` on the resident path.  A rank's
    shard (``ShardedLeaf``) is gathered over every other axis but keeps
    the split of ``model`` over the experts, and of ``data`` over F where
    its layout has it there: no rank holds every expert."""
    keep = ()
    if isinstance(w, ShardedLeaf):
        keep = ("model",) if w.axes(0) == ("model",) else ()
        if fs is not None and w.axes(f_dim) == ("data",):
            keep += ("data",)
        w = w.gather(keep)
    if "model" not in keep:
        w = w[es]
    if fs is not None and "data" not in keep:
        w = w.narrow(f_dim, fs.start, fs.stop - fs.start)
    return w


def _shared(p, x, cfg, prefix):
    sh = {"w_gate": p[f"{prefix}ws_gate"], "w_up": p[f"{prefix}ws_up"],
          "w_down": p[f"{prefix}ws_down"]}
    return mlp(sh, x, cfg)


def _moe_dense_fallback(p, x, cfg, prefix: str = ""):
    """Single-device / no-mesh path: x [B,S,D] -> (y [B,S,D], aux); a
    rank's shards of the experts' weights are gathered whole."""
    B, S, D = x.shape
    E = cfg.num_experts
    x_tok = x.reshape(-1, D)
    top_p, top_e, probs = _router(x_tok, p[f"{prefix}router"], cfg)
    aux = _aux_loss(probs, top_e, cfg)
    t, k = top_e.shape
    cap = capacity(t, cfg)
    buf, comb_w, slot = _bin_tokens(x_tok, top_p, top_e, E, cap)
    out = _expert_ffn(buf.reshape(E, cap, D), gathered(p[f"{prefix}we_gate"]),
                      gathered(p[f"{prefix}we_up"]),
                      gathered(p[f"{prefix}we_down"]))
    out = torch.cat([out.reshape(E * cap, D), out.new_zeros(1, D)])
    y = (out[slot].reshape(t, k, D)
         * comb_w.reshape(t, k, 1).to(out.dtype)).sum(dim=1).reshape(B, S, D)
    if cfg.shared_expert:
        y = y + _shared(p, x, cfg, prefix)
    return y, aux
