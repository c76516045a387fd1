"""Logical-axis sharding: names -> mesh axes -> DTensor placements — the
reference's ``repro.parallel.sharding`` in PyTorch.

Every parameter / activation dimension carries a *logical* axis name
("embed", "heads", "batch", ...).  An :class:`AxisRules` table maps each
logical name to zero or more mesh axes.  The same table serves the
single-pod ``(data, model)`` mesh and the multi-pod ``(pod, data, model)``
mesh: rules that name a mesh axis absent from the current mesh are dropped
(e.g. "pod" on a single-pod mesh).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (:func:`make_mesh`,
over an initialised process group) or an :class:`AbstractMesh` (names and
sizes, no process group: what a dry run plans against).  A sharding is a
:class:`NamedSharding`: the mesh, the reference's ``PartitionSpec`` as a
plain tuple (``spec``, so that the two packages compare), and the DTensor
placements, one a mesh dimension.

**Activations keep no constraint.**  The reference pins activations with
``shard_act`` at the model's call sites (``models/layers.py``,
``rglru.py``, ``ssm.py``, ``transformer.py``).  The port's launcher gathers
the weights a layer at a time and runs each rank's forward on plain local
tensors (its batch shard), so such a constraint would change no number,
and the port's model code calls none.  :func:`shard_act` exists for
callers holding DTensors: it redistributes one to the spec's placements
and returns a plain tensor unchanged.

**The state stays sharded through a step** (the half of GSPMD's program
that needs no split product).  A :class:`ShardedLeaf` is a rank's block of
one parameter; the model gathers it where it uses it (:func:`gathered`,
a super-block's leaves at a time) and the gather's backward sums the
cotangent over the ranks that hold the block, cuts it to the block and
divides it by the rank count (:class:`MeshOps`).  :class:`StateShards`
gives the optimizer the sums over ranks that stand in for its whole-leaf
reductions.  The ``jax`` version shims (``make_mesh``'s ``axis_types``,
``shard_map``) have no counterpart.

**Products split over ``model``** (tensor parallelism, the reference's
``heads``, ``kv_heads``, ``ffn`` and ``vocab`` rules): where a leaf's
stored spec splits its product's dimension over a ``model`` axis of more
than one rank and the rules' batch leaves ``model`` out, the module that
uses it gathers it keeping ``model`` (:func:`tp_group`) and sums its
partial products over the group (:class:`TPGroup`), through the leaf's
:class:`MeshOps`.  Attention's q heads and the head's vocabulary split
wherever the rules give them ``model`` (:func:`tile_group`), also where
``model`` does not divide them and the stored spec dropped it: each rank
computes its padded tile (:func:`tile`, GSPMD's tiling of the
reference's activations there; trailing tiles short or empty), cut from
the leaf gathered whole (:func:`tp_tile`).  A block that
splits all its leaves at once asks :func:`block_group`; where the rank
holds a block of an activation that it needs whole, it gathers it over
the group (:meth:`TPGroup.gather`), and a norm over such a dimension
sums over the group (:meth:`TPGroup.rmsnorm`).  Each collective's
backward is its exact adjoint (:class:`AllReduce`: a sum's is the sum;
a gather's a reduce-scatter), so a rank's gradient is the derivative of
the sum of every rank's loss, which :meth:`MeshOps.reduce` divides by
the rank count: ranks of one ``model`` group compute the same loss, so
this is the global batch's gradient, as for the MoE's expert-parallel
paths.

**The batch splits over ``model``** where the rules put it there
(``dp_fsdp``, ``dp_all``, ``attn_dp``) and ``model`` does not divide the
global batch, so that the batch's spec drops it (:func:`row_group`):
each rank of a ``model`` group runs its padded tile of its shard's rows
(:meth:`TPGroup.block`), GSPMD's tiling of the reference's activations
there, a trailing tile short or empty; a prefill gathers the rows back
where its outputs hold them (:meth:`TPGroup.gather`).

**A microbatch is a slice of the global batch**, as the reference's
``x.reshape(n, b/n, ...)`` of a batch split over the batch axes: with
more than one microbatch, a rank's shard of the rows is exchanged over
the axes that split it (:func:`batch_axes`, :func:`microbatch_rows`) so
that its i-th slice is its block of the global batch's i-th.

**Serving caches split over ``model``** by the rules' ``cache_seq``
(sequence parallelism in decode): a cache leaf's stored spec decides
(:func:`split_group`), and a prefill, which has no cache leaf yet,
asks the rules for a cache of its length (:func:`cache_seq_group`).
:func:`sharded_leaves` hands a step a rank's blocks as
:class:`ShardedLeaf` s.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field, replace

import torch

# ---------------------------------------------------------------------------
# Rules


@dataclass(frozen=True)
class AxisRules:
    """Mapping of logical axis names to (tuples of) mesh axis names."""

    rules: dict[str, tuple[str, ...]] = field(default_factory=dict)

    def get(self, logical: str | None) -> tuple[str, ...]:
        if logical is None:
            return ()
        return self.rules.get(logical, ())

    def override(self, **kw: tuple[str, ...] | str | None) -> "AxisRules":
        new = dict(self.rules)
        for k, v in kw.items():
            if v is None:
                new[k] = ()
            elif isinstance(v, str):
                new[k] = (v,)
            else:
                new[k] = tuple(v)
        return replace(self, rules=new)


# The baseline production ruleset: DP over (pod, data), FSDP weight sharding
# over data, TP over model, EP (experts) over model, decode-cache SP over
# model — the reference's table, entry for entry.
DEFAULT_RULES = AxisRules(
    {
        # activations
        "batch": ("pod", "data"),
        "seq": (),                 # sequence replicated in train fwd
        "act_embed": (),           # d_model dim of activations
        "act_heads": ("model",),   # per-head activation dims
        "act_ffn": ("model",),
        "act_vocab": ("model",),
        # weights (FSDP dim = "embed"; TP dims = heads/ffn/vocab)
        "embed": ("data",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "qkv_flat": ("model",),
        "ffn": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "expert_ffn": (),
        "layers": (),
        "stack": (),
        # recurrent / ssm state
        "ssm_heads": ("model",),
        "ssm_state": (),
        "conv_dim": ("model",),
        # serving caches
        "cache_batch": ("pod", "data"),
        "cache_seq": ("model",),   # SP over the KV cache during decode
        "cache_kv_heads": (),
        # misc
        "norm": (),
    }
)


# ---------------------------------------------------------------------------
# Meshes


class AbstractMesh:
    """A mesh's axis names and sizes with no process group behind it."""

    def __init__(self, axis_shapes, axis_names):
        axis_shapes, axis_names = tuple(axis_shapes), tuple(axis_names)
        if len(axis_shapes) != len(axis_names):
            raise ValueError(f"mesh shape {axis_shapes} and names "
                             f"{axis_names} differ in length")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, (int(n) for n in axis_shapes)))

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`,
    in the mesh's order."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def make_mesh(axis_shapes, axis_names, *, device="cuda"):
    """A ``DeviceMesh`` of ``axis_shapes`` over the initialised default
    process group, ranks laid out row-major (the last axis fastest, as
    ``jax.make_mesh`` lays out devices)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (launch.mesh "
                           "initialises one)")
    shape = tuple(int(n) for n in axis_shapes)
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"mesh {shape} holds {n} ranks; the process group "
                         f"has {dist.get_world_size()}")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


# ---------------------------------------------------------------------------
# Context


class _Ctx(threading.local):
    mesh = None
    rules: AxisRules | None = None


_CTX = _Ctx()


class sharding_context:
    """Install ``mesh`` + ``rules`` for :func:`logical_sharding` /
    :func:`shard_act` and the MoE's expert-parallel paths.

    Reentrant/reusable (unlike a generator-based contextmanager)."""

    def __init__(self, mesh, rules: AxisRules = DEFAULT_RULES):
        self.mesh, self.rules = mesh, rules
        self._prev: list[tuple] = []

    def __enter__(self):
        self._prev.append((_CTX.mesh, _CTX.rules))
        _CTX.mesh, _CTX.rules = self.mesh, self.rules
        return self

    def __exit__(self, *exc):
        _CTX.mesh, _CTX.rules = self._prev.pop()
        return False


def current_mesh():
    return _CTX.mesh


def current_rules() -> AxisRules:
    return _CTX.rules if _CTX.rules is not None else DEFAULT_RULES


# ---------------------------------------------------------------------------
# Spec construction


def _spec_for(logical_axes: tuple[str | None, ...], mesh, rules: AxisRules,
              shape: tuple[int, ...] | None = None) -> tuple:
    """The reference's PartitionSpec for one array, as a tuple: drops mesh
    axes not in the mesh, never reuses a mesh axis, and — when ``shape``
    is given — drops axes that do not divide the dimension evenly."""
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    parts: list = []
    for i, name in enumerate(logical_axes):
        axes = []
        prod = 1
        for a in rules.get(name):
            if a not in sizes or a in used:
                continue
            n = sizes[a]
            if shape is not None and shape[i] % (prod * n) != 0:
                continue
            axes.append(a)
            prod *= n
        used.update(axes)
        if len(axes) == 0:
            parts.append(None)
        elif len(axes) == 1:
            parts.append(axes[0])
        else:
            parts.append(tuple(axes))
    # trim trailing Nones (canonical form)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _placements(spec: tuple, mesh) -> tuple:
    """DTensor placements, one a mesh dimension: ``Shard(i)`` where the
    spec splits tensor dimension i over that axis, else ``Replicate()``.
    An entry of several axes must name them in the mesh's order (DTensor
    splits a dimension by mesh dimensions, the first outermost, as a jax
    spec's tuple does)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out = [Replicate()] * len(names)
    for i, part in enumerate(spec):
        axes = (part,) if isinstance(part, str) else tuple(part or ())
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {part} splits dimension {i} over "
                             f"axes out of the mesh's order {names}")
        for j in idx:
            out[j] = Shard(i)
    return tuple(out)


def tile(n: int, blocks: int, idx: int) -> tuple[int, int]:
    """(start, width) of tile ``idx`` of a dimension of ``n`` cut into
    ``blocks``: GSPMD's tiling of an uneven split, tiles of ``c =
    ceil(n / blocks)`` from the start, so that trailing tiles are short
    or empty.  An even split's blocks."""
    c = -(-n // blocks)
    start = min(n, idx * c)
    return start, min(n, start + c) - start


@dataclass(frozen=True)
class NamedSharding:
    """The port's ``jax.sharding.NamedSharding``: a mesh, the reference's
    spec (a tuple: entries ``None``, an axis name or a tuple of names,
    trailing ``None`` trimmed) and the DTensor placements it gives."""

    mesh: object
    spec: tuple
    placements: tuple

    def local_slices(self, shape, coordinate) -> tuple[slice, ...]:
        """The slice of a tensor of ``shape`` that the rank at mesh
        ``coordinate`` (one index an axis) holds."""
        sizes = mesh_shape(self.mesh)
        coord = dict(zip(sizes, coordinate))
        out = []
        for i, n in enumerate(shape):
            part = self.spec[i] if i < len(self.spec) else None
            axes = (part,) if isinstance(part, str) else tuple(part or ())
            blocks, idx = 1, 0
            for a in axes:
                blocks *= sizes[a]
                idx = idx * sizes[a] + coord[a]
            if n % blocks:
                raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                                 f"split into {blocks} over {axes}")
            w = n // blocks
            out.append(slice(idx * w, (idx + 1) * w))
        return tuple(out)


def logical_sharding(
    logical_axes: tuple[str | None, ...],
    mesh=None,
    rules: AxisRules | None = None,
    shape: tuple[int, ...] | None = None,
) -> NamedSharding:
    mesh = mesh or _CTX.mesh
    if mesh is None:
        raise RuntimeError("logical_sharding: no mesh (use sharding_context)")
    rules = rules or current_rules()
    spec = _spec_for(tuple(logical_axes), mesh, rules, shape)
    return NamedSharding(mesh, spec, _placements(spec, mesh))


def _is_axes_leaf(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _map(fn, tree, *others):
    if _is_axes_leaf(tree):
        return fn(tree, *others)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    raise TypeError(f"not an axes tree: {tree!r}")


def tree_shardings(axes_tree, shapes_tree=None, mesh=None,
                   rules: AxisRules | None = None):
    """Map a tree (dicts) of logical-axis tuples to a tree of
    :class:`NamedSharding`.  ``shapes_tree`` (a matching tree of leaves
    with a ``shape``) enables divisibility-aware axis dropping."""
    if shapes_tree is None:
        return _map(lambda ax: logical_sharding(ax, mesh, rules), axes_tree)
    return _map(lambda ax, sd: logical_sharding(ax, mesh, rules,
                                                tuple(sd.shape)),
                axes_tree, shapes_tree)


def shard_act(x, *logical_axes: str | None):
    """A DTensor redistributed to the spec's placements under the current
    mesh; a plain tensor, or any tensor outside a sharding_context,
    unchanged."""
    mesh = _CTX.mesh
    if mesh is None or isinstance(mesh, AbstractMesh):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = _spec_for(tuple(logical_axes), mesh, current_rules())
    return x.redistribute(mesh, _placements(spec, mesh))


def distribute(full: torch.Tensor, sharding: NamedSharding, device=None):
    """A DTensor with ``sharding``'s placements whose local tensor is this
    rank's slice of ``full``, which every rank holds whole: cut locally,
    with no communication.  A split leaf's local tensor is a copy that
    owns only its slice's bytes (a view would keep ``full``'s storage
    alive on every rank); where nothing is split it is ``full`` itself."""
    mesh = sharding.mesh
    local = full[sharding.local_slices(full.shape, mesh.get_coordinate())]
    if device is not None:
        local = local.to(device)
    return from_local(owned(local), sharding)


def owned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous in a tensor that owns only its bytes: ``x`` itself
    where it does, else a copy (a view would keep a larger storage
    alive)."""
    x = x.contiguous()
    if x.untyped_storage().nbytes() > x.numel() * x.element_size():
        x = x.clone()
    return x


def from_local(local: torch.Tensor, sharding: NamedSharding):
    """``local``, this rank's block under ``sharding``, as a DTensor whose
    whole shape follows from the block's and the mesh's sizes."""
    from torch.distributed.tensor import DTensor

    sizes = mesh_shape(sharding.mesh)
    shape = tuple(d * math.prod(sizes[a] for a in axes) for d, axes in
                  zip(local.shape, spec_axes(sharding.spec, local.dim())))
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


# ---------------------------------------------------------------------------
# Collectives over a process group, and the differentiable ones built on
# them through a MeshOps and a mesh axis (each one's backward its adjoint):
# the sharded step's gathers and sums, the tensor-parallel blocks and the
# MoE's expert-parallel paths all run these


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (one shape on every rank) concatenated along
    ``dim`` in the group's rank order."""
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [n, ...] over the group's n ranks: block j goes to rank j,
    and block j of the result came from rank j."""
    import torch.distributed as dist

    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def native_reduce_scatter(x: torch.Tensor, group) -> bool:
    """Whether :func:`reduce_scatter` of ``x`` runs the group's own
    reduce-scatter: a CUDA tensor over NCCL.  Elsewhere (gloo, the CPU's
    backend) it all-reduces and cuts, which gloo runs in every PyTorch."""
    import torch.distributed as dist

    return x.device.type == "cuda" and "nccl" in str(dist.get_backend(group))


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the group's ranks of ``x``, cut along ``dim`` to this
    rank's block (the adjoint of :func:`all_gather`), in a tensor that
    owns only the block's bytes.  Where :func:`native_reduce_scatter`
    holds, ``reduce_scatter_tensor`` moves each rank's block and no more
    (``dim`` moved to the front first, a copy unless it is 0); elsewhere
    an all-reduce of a copy of ``x``, then the block."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    w = x.shape[dim] // n
    if native_reduce_scatter(x, group):
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((w,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous()
    s = x.contiguous().clone()
    dist.all_reduce(s, group=group)
    return s.narrow(dim, dist.get_rank(group) * w, w).clone()


def _summed(x: torch.Tensor, ops: "MeshOps", axis: str,
            mean: bool) -> torch.Tensor:
    y = x.contiguous().clone()
    ops.all_reduce(y, axis)
    return y / ops.sizes[axis] if mean else y


class AllReduce(torch.autograd.Function):
    """The sum over the ranks along ``axis`` of ``ops``'s mesh (``mean``:
    divided by their count); backward: the same reduction of the
    cotangents, its adjoint."""

    @staticmethod
    def forward(ctx, x, ops, axis, mean):
        ctx.ops, ctx.axis, ctx.mean = ops, axis, mean
        return _summed(x, ops, axis, mean)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.ops, ctx.axis, ctx.mean), None, None, None


class AllGather(torch.autograd.Function):
    """The blocks of the ranks along ``axis`` of ``ops``'s mesh
    concatenated on ``dim`` (:meth:`MeshOps.all_gather`); backward: the
    sum of every rank's cotangent, this rank's block of it
    (:meth:`MeshOps.reduce_scatter`), its adjoint."""

    @staticmethod
    def forward(ctx, x, ops, axis, dim):
        ctx.ops, ctx.axis, ctx.dim = ops, axis, dim
        return ops.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.ops.reduce_scatter(g, ctx.axis, ctx.dim), None, None, None


class AllToAll(torch.autograd.Function):
    """:meth:`MeshOps.all_to_all` over ``axis``: block j of dimension 0 to
    rank j; backward: the same exchange of the cotangents, its adjoint
    (the exchange is a permutation of the blocks over the ranks, and its
    own inverse)."""

    @staticmethod
    def forward(ctx, x, ops, axis):
        ctx.ops, ctx.axis = ops, axis
        return ops.all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.ops.all_to_all(g, ctx.axis), None, None


class ReduceScatter(torch.autograd.Function):
    """:meth:`MeshOps.reduce_scatter` over ``axis``; backward:
    :meth:`MeshOps.all_gather` of the cotangents, its adjoint."""

    @staticmethod
    def forward(ctx, x, ops, axis, dim):
        ctx.ops, ctx.axis, ctx.dim = ops, axis, dim
        return ops.reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.ops.all_gather(g, ctx.axis, ctx.dim), None, None, None


# ---------------------------------------------------------------------------
# The state kept sharded through a step: a rank's shard of a leaf, gathered
# where the model uses it, its cotangent reduced back to the shard; and the
# reductions an optimizer on the local shards needs


def spec_axes(spec: tuple, ndim: int) -> list[tuple[str, ...]]:
    """The mesh axes that split each of ``ndim`` dimensions under
    ``spec`` (a trimmed spec's missing entries split nothing)."""
    out = []
    for i in range(ndim):
        part = spec[i] if i < len(spec) else None
        out.append((part,) if isinstance(part, str) else tuple(part or ()))
    return out


class MeshOps:
    """The collectives a sharded step runs over ``mesh``'s process groups,
    one mesh axis at a time, and what it builds from them: the gather of a
    :class:`ShardedLeaf` and its adjoint, and the optimizer's sums
    (:class:`StateShards`).  The dry run subclasses it with collectives
    that move nothing (``launch/dryrun.py``)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes = mesh_shape(mesh)
        self.n = math.prod(self.sizes.values())

    # the primitives -------------------------------------------------------
    def coordinate(self) -> dict[str, int]:
        return dict(zip(self.sizes, self.mesh.get_coordinate()))

    def all_reduce(self, x: torch.Tensor, axis: str, op: str = "sum") -> None:
        """Reduces ``x`` in place over the ranks along ``axis``: their sum,
        or their elementwise ``"max"``."""
        import torch.distributed as dist

        red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        dist.all_reduce(x, op=red, group=self.mesh.get_group(axis))

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The blocks of the ranks along ``axis`` concatenated on ``dim``."""
        return all_gather(x, self.mesh.get_group(axis), dim)

    def reduce_scatter(self, x: torch.Tensor, axis: str,
                       dim: int) -> torch.Tensor:
        """``x`` summed over the ranks along ``axis``, this rank's block of
        it along ``dim``."""
        return reduce_scatter(x, self.mesh.get_group(axis), dim)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` [n, ...] over the n ranks along ``axis``: block j of
        dimension 0 goes to rank j, and block j of the result came from
        rank j."""
        return all_to_all(x, self.mesh.get_group(axis))

    # built on them --------------------------------------------------------
    def sum_over(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``x`` (a tensor this rank owns) summed in place over the ranks
        along each of ``axes``, in the mesh's order."""
        for a in self.sizes:
            if a in axes and self.sizes[a] > 1:
                self.all_reduce(x, a)
        return x

    def index(self, axes) -> int:
        """This rank's index along ``axes`` together, the first the most
        significant (a block's place in a dimension they split)."""
        coord, idx = self.coordinate(), 0
        for a in axes:
            idx = idx * self.sizes[a] + coord[a]
        return idx

    def block(self, x: torch.Tensor, layout: list[tuple]) -> torch.Tensor:
        """``x``, whole along each dimension that ``layout`` splits, cut to
        this rank's block there (a view)."""
        for d, axes in enumerate(layout):
            if axes:
                w = x.shape[d] // math.prod(self.sizes[a] for a in axes)
                x = x.narrow(d, self.index(axes) * w, w)
        return x

    def unsplit(self, x: torch.Tensor, layout: list[tuple]) -> torch.Tensor:
        """``x``, this rank's block under ``layout``, gathered whole: the
        innermost axis of a dimension first, as the blocks are laid out."""
        for d, axes in enumerate(layout):
            for a in reversed(axes):
                x = self.all_gather(x, a, d)
        return x

    def relayout(self, x: torch.Tensor, src: list[tuple],
                 dst: list[tuple]) -> torch.Tensor:
        """``x`` in the block layout ``src`` moved to ``dst``: each
        dimension the two split differently gathered whole and cut to this
        rank's block under ``dst``.  ``x`` itself where they agree."""
        if src == dst:
            return x
        diff = [s if s != t else () for s, t in zip(src, dst)]
        whole = self.unsplit(x, diff)
        return self.block(whole, [t if s != t else () for s, t in
                                  zip(src, dst)]).contiguous()

    def gather(self, leaf: "ShardedLeaf", keep: tuple) -> torch.Tensor:
        """``leaf`` gathered over every axis that splits it but ``keep``."""
        return self.unsplit(leaf.local, leaf.layout(keep))

    def reduce(self, leaf: "ShardedLeaf", keep: tuple,
               g: torch.Tensor) -> torch.Tensor:
        """The adjoint of :meth:`gather` averaged over the ranks: ``g``
        summed over every rank that holds the kept block (each mesh axis
        not in ``keep``), cut to this rank's block and divided by the rank
        count, as the launcher's mean of the ranks' gradients.  The axes
        that split the leaf reduce-scatter, in the reverse of the
        gather's order, so that each rank receives its block alone; those
        over which the block has copies then all-reduce the block."""
        if self.n == 1:
            return g
        layout = leaf.layout(keep)
        split = {a for axes in layout for a in axes}
        if any(self.sizes[a] > 1 for a in split):
            for d in reversed(range(len(layout))):
                for a in layout[d]:
                    if self.sizes[a] > 1:
                        g = self.reduce_scatter(g, a, d)
            g = g.div_(self.n)
        else:
            g = g / self.n
        return self.sum_over(g, [a for a in self.sizes
                                 if a not in keep and a not in split])


class ShardedLeaf:
    """A rank's shard of one parameter leaf: ``local``, its block under
    ``sharding``, and ``ops`` (:class:`MeshOps`) to gather it.  The model
    gathers it where it uses it (:func:`gathered`; the MoE keeps its
    experts split, :meth:`gather` with ``keep``); the gather's backward
    reduces the cotangent to the block (:meth:`MeshOps.reduce`).  ``key``
    names the leaf and ``index`` the layer of a stacked leaf that this is
    one slice of."""

    __slots__ = ("local", "sharding", "ops", "key", "index")

    def __init__(self, local, sharding: NamedSharding, ops: MeshOps,
                 key: str = "", index: int | None = None):
        self.local, self.sharding, self.ops = local, sharding, ops
        self.key, self.index = key, index

    def with_local(self, local) -> "ShardedLeaf":
        return ShardedLeaf(local, self.sharding, self.ops, self.key,
                           self.index)

    def axes(self, dim: int) -> tuple[str, ...]:
        """The mesh axes that split dimension ``dim``."""
        return spec_axes(self.sharding.spec, self.local.dim())[dim]

    def layout(self, keep=()) -> list[tuple]:
        """The axes a gather keeping ``keep`` undoes, a dimension each; a
        dimension split over kept and gathered axes at once is refused."""
        out = []
        for d, axes in enumerate(spec_axes(self.sharding.spec,
                                           self.local.dim())):
            kept = [a for a in axes if a in keep]
            if kept and len(kept) != len(axes):
                raise ValueError(f"{self.key}: dimension {d} splits over "
                                 f"{axes}; a gather keeps all or none")
            out.append(() if kept else axes)
        return out

    def unbind(self, dim: int = 0) -> list["ShardedLeaf"]:
        """The layers of a stacked leaf (``dim`` 0, its leading axis, which
        splits over no mesh axis, as the rules' ``stack`` entry gives)."""
        if dim != 0 or self.axes(0):
            raise ValueError(f"{self.key}: the stacked axis splits over "
                             f"{self.axes(0)}")
        spec = self.sharding.spec[1:]
        sh = NamedSharding(self.sharding.mesh, spec,
                           _placements(spec, self.sharding.mesh))
        return [ShardedLeaf(t, sh, self.ops, self.key, i)
                for i, t in enumerate(self.local.unbind(0))]

    def gather(self, keep=()) -> torch.Tensor:
        """The leaf gathered over every axis that splits it but those in
        ``keep``, which stay split as they are."""
        return _Gather.apply(self.local, self, tuple(keep))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, leaf, keep):
        ctx.leaf, ctx.keep = leaf, keep
        return leaf.ops.gather(leaf, keep)

    @staticmethod
    def backward(ctx, g):
        return ctx.leaf.ops.reduce(ctx.leaf, ctx.keep, g), None, None


def gathered(x):
    """A :class:`ShardedLeaf` gathered whole; anything else unchanged."""
    return x.gather() if isinstance(x, ShardedLeaf) else x


# ---------------------------------------------------------------------------
# Tensor parallelism: products split over ``model``

TP_AXIS = "model"


@dataclass(frozen=True)
class TPGroup:
    """The ranks along ``model`` that split a product between them, seen
    from one of them: ``ops`` runs the collectives, over ``size`` ranks,
    of which this one is ``index``."""

    ops: MeshOps
    size: int
    index: int

    def block(self, n: int) -> tuple[int, int]:
        """(start, width) of this rank's padded tile of a dimension of
        ``n`` (:func:`tile`): its block where the group divides ``n``,
        else possibly short or empty."""
        return tile(n, self.size, self.index)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the group (:class:`AllReduce`)."""
        return AllReduce.apply(x, self.ops, TP_AXIS, False)

    def gather(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """The group's tiles of ``x`` concatenated along ``dim`` in rank
        order: the whole of an activation of ``n`` along ``dim`` split
        over the group (:meth:`block`).  Each tile is padded with zeros
        to the widest for the all-gather, and the padding cut after; a
        tile of another width than this rank's of ``n`` is refused."""
        w, c = x.shape[dim], -(-n // self.size)
        if w != self.block(n)[1]:
            raise ValueError(f"a tile of {w} along dimension {dim} is not "
                             f"rank {self.index}'s of {n} over {self.size}")
        if w < c:
            pad = list(x.shape)
            pad[dim] = c - w
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        y = AllGather.apply(x, self.ops, TP_AXIS, dim)
        return y if c * self.size == n else y.narrow(dim, 0, n)

    def cut(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's tile (:meth:`block`) of ``x`` along ``dim`` (a
        view)."""
        return x.narrow(dim, *self.block(x.shape[dim]))

    def rmsnorm(self, x: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
        """``layers.rmsnorm`` over a last dimension split over the group:
        ``x`` is the rank's block of it, ``scale`` the whole norm scale.
        The mean square is the group's sum of the blocks' sums of
        squares over the whole width; the rank scales its block."""
        dt = x.dtype
        x = x.float()
        n = x.shape[-1]
        ms = self.sum(torch.sum(torch.square(x), dim=-1, keepdim=True))
        x = x * torch.rsqrt(ms / (n * self.size) + eps)
        return (x * scale.narrow(-1, self.index * n, n).float()).to(dt)

    def max_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (no gradient) replaced in place by its elementwise max
        over the group."""
        self.ops.all_reduce(x, TP_AXIS, "max")
        return x


def tp_group(x) -> TPGroup | None:
    """The group that splits ``x``'s product: where ``x`` is a
    :class:`ShardedLeaf` whose stored spec splits a dimension over a
    ``model`` axis of more than one rank and the current rules' batch
    leaves ``model`` out.  None elsewhere: whole tensors, a one-rank
    ``model``, a dimension ``model`` does not divide (its spec drops the
    axis), rules that put the batch over ``model`` (``dp_fsdp``,
    ``dp_all``, ``attn_dp``)."""
    if not isinstance(x, ShardedLeaf):
        return None
    n = x.ops.sizes.get(TP_AXIS, 1)
    if n == 1 or TP_AXIS in current_rules().get("batch"):
        return None
    if not any(TP_AXIS in axes for axes in spec_axes(x.sharding.spec,
                                                      x.local.dim())):
        return None
    return _model_group(x.ops)


def tile_group(x, logical: str) -> TPGroup | None:
    """The group whose ranks each compute their padded tile
    (:meth:`TPGroup.block`) of a dimension named ``logical`` of ``x``'s
    product: where ``x`` is a :class:`ShardedLeaf`, the current rules give
    ``logical`` a ``model`` axis of more than one rank alone and their
    batch leaves ``model`` out.  Unlike :func:`tp_group` it holds where
    ``model`` does not divide the dimension and the stored spec dropped
    it: the reference's activations split there all the same, padded by
    GSPMD.  None elsewhere."""
    if not isinstance(x, ShardedLeaf):
        return None
    rules = current_rules()
    if TP_AXIS in rules.get("batch") or _spec_for(
            (logical,), x.ops.mesh, rules) != (TP_AXIS,):
        return None
    return _model_group(x.ops)


def tp_tile(x, dim: int, tp: TPGroup | None) -> torch.Tensor:
    """``x``'s rank's tile along ``dim`` under ``tp`` (:func:`tile_group`):
    its block gathered keeping ``model`` where the stored spec splits
    ``dim`` over it, else cut from ``x`` gathered whole (the cut's
    backward pads the gradient with zeros, which the gather's backward
    sums over ``model``).  Without ``tp``, ``x`` gathered whole."""
    if tp is None:
        return gathered(x)
    if x.axes(dim) == (TP_AXIS,):
        return x.gather((TP_AXIS,))
    whole = gathered(x)
    return whole.narrow(dim, *tp.block(whole.shape[dim]))


def _model_group(ops: MeshOps) -> TPGroup | None:
    """The ranks along ``model`` of ``ops``'s mesh, where it has more than
    one."""
    n = ops.sizes.get(TP_AXIS, 1)
    return TPGroup(ops, n, ops.coordinate()[TP_AXIS]) if n > 1 else None


def split_group(x, dim: int) -> TPGroup | None:
    """The group whose ranks each hold a block of dimension ``dim`` of
    ``x``: where ``x`` is a :class:`ShardedLeaf` whose stored spec splits
    that dimension over ``model`` alone, of more than one rank (a serving
    cache's slots under ``cache_seq``).  None elsewhere."""
    if not isinstance(x, ShardedLeaf) or x.axes(dim) != (TP_AXIS,):
        return None
    return _model_group(x.ops)


def rule_group(ops: MeshOps | None, logical: str, n: int) -> TPGroup | None:
    """The group that splits a dimension of ``n`` named ``logical``, as a
    leaf's spec would (:func:`split_group`): where the current rules give
    it ``model`` alone on ``ops``'s mesh, more than one rank that divides
    ``n``.  None without ``ops``."""
    if ops is None or _spec_for((logical,), ops.mesh, current_rules(),
                                (n,)) != (TP_AXIS,):
        return None
    return _model_group(ops)


def shard_rows(mesh, logical: str, rows: int) -> int:
    """The rows a rank holds of a leaf of ``rows`` rows whose first
    dimension is named ``logical``: ``rows`` over the axes its spec keeps
    (the current rules, ``model`` dropped where it does not divide)."""
    spec = _spec_for((logical,), mesh, current_rules(), (rows,))
    sizes = mesh_shape(mesh)
    return rows // math.prod(sizes[a] for a in spec_axes(spec, 1)[0])


def row_group(ops: MeshOps | None, rows: int | None,
              logical: str = "batch") -> TPGroup | None:
    """The group of ``model`` ranks that split the rows of a rank's shard
    of a leaf named ``logical`` (:func:`shard_rows`, of a global batch of
    ``rows``) between them, each running its padded tile
    (:meth:`TPGroup.block`, the trailing tiles short or empty): where the
    current rules put ``batch`` over a ``model`` axis of more than one
    rank on ``ops``'s mesh (``dp_fsdp``, ``dp_all``, ``attn_dp``) and the
    spec of ``logical`` leaves ``model`` out.  For ``"batch"`` that is
    where ``model`` does not divide the rows: the batch's spec dropped
    it, the rank is handed its shard over the other axes, and GSPMD
    splits the reference's activations over ``model`` all the same,
    padded.  For ``"cache_batch"``, which has no ``model`` under those
    rules, it is wherever the batch splits over ``model``: a prefill's
    cache holds every row of the shard.  None elsewhere, and without
    ``ops`` or ``rows`` (each rank's rows its own)."""
    if ops is None or rows is None:
        return None
    rules = current_rules()
    if TP_AXIS not in rules.get("batch") or TP_AXIS in spec_axes(
            _spec_for((logical,), ops.mesh, rules, (rows,)), 1)[0]:
        return None
    return _model_group(ops)


def batch_axes(ops: MeshOps, rows: int | None) -> tuple[str, ...]:
    """The mesh axes, of more than one rank, whose ranks hold distinct
    shards of a batch's rows: those the batch's spec splits a global batch
    of ``rows`` over under the current rules (``model`` dropped where it
    does not divide them), or with ``rows`` None every batch axis of the
    mesh, as ``launch.train.batch_shard`` gives the loader."""
    if rows is None:
        axes = [a for a in current_rules().get("batch") if a in ops.sizes]
    else:
        axes = spec_axes(_spec_for(("batch",), ops.mesh, current_rules(),
                                   (rows,)), 1)[0]
    return tuple(a for a in axes if ops.sizes[a] > 1)


def microbatch_rows(x: torch.Tensor, ops: MeshOps, axes,
                    n: int) -> torch.Tensor:
    """``x``, a rank's shard of a batch's rows (global rows [r·b/d,
    (r+1)·b/d), r its index over ``axes``, d their ranks), with its rows
    exchanged so that its i-th of ``n`` slices is its block of the global
    batch's i-th: global rows [i·b/n + r·b/(n·d), +b/(n·d)), as GSPMD lays
    out the reference's ``x.reshape(n, b/n, ...)`` of a batch split over
    ``axes``.  The shards are gathered over ``axes`` (the global rows,
    [d, n, c] read as [n, d, c]) and the rank's rows of each slice cut."""
    d = math.prod(ops.sizes[a] for a in axes)
    if x.shape[0] % n:
        raise ValueError(f"a shard of {x.shape[0]} rows does not split into "
                         f"{n} microbatches")
    whole = ops.unsplit(x, [tuple(axes)] + [()] * (x.dim() - 1))
    c = x.shape[0] // n
    return whole.reshape(n, d, c, *x.shape[1:])[:, ops.index(axes)] \
        .reshape(x.shape)


def cache_seq_group(ops: MeshOps | None, n_slots: int) -> TPGroup | None:
    """The group that splits a serving cache of ``n_slots`` slots
    (:func:`rule_group` of ``cache_seq``)."""
    return rule_group(ops, "cache_seq", n_slots)


def block_group(p: dict, names, cache=()) -> TPGroup | None:
    """The group over which a block runs split: where :func:`tp_group`
    splits every leaf of ``p`` named in ``names``, and each (cache entry,
    dimension) of ``cache`` (a decode's) is split along that dimension
    over ``model`` alone (:func:`split_group`).  None elsewhere: the block
    then runs whole."""
    groups = [tp_group(p[k]) for k in names]
    if any(g is None for g in groups) or any(split_group(c, d) is None
                                             for c, d in cache):
        return None
    return groups[0]


def sharded_leaves(local: dict, shardings: dict, ops: MeshOps) -> dict:
    """A rank's blocks (``local``, by key) as :class:`ShardedLeaf` s of
    their ``shardings``; at one rank the blocks themselves, the whole
    leaves."""
    if ops.n == 1:
        return dict(local)
    return {k: ShardedLeaf(v, shardings[k], ops, key=k)
            for k, v in local.items()}


def leaf_ops(tree: dict) -> MeshOps | None:
    """The :class:`MeshOps` of the first :class:`ShardedLeaf` in ``tree``
    (a rank's shards), or None (whole tensors)."""
    return next((v.ops for v in tree.values() if isinstance(v, ShardedLeaf)),
                None)


def local_of(x):
    """The tensor a rank holds of ``x``: a :class:`ShardedLeaf`'s block,
    or ``x`` itself."""
    return x.local if isinstance(x, ShardedLeaf) else x


class StateShards:
    """How each leaf of a train state is split (``shardings``, a tree
    like the state's of :class:`NamedSharding`), and the sums over ranks
    that an optimizer on the local shards takes in place of whole-leaf
    reductions, through ``ops``.  A *layout* lists, a dimension each, the
    mesh axes that split it."""

    def __init__(self, ops: MeshOps, shardings: dict):
        self.ops, self.shardings = ops, shardings

    def layout(self, path: tuple, ndim: int) -> list[tuple]:
        sh = self.shardings
        for p in path:
            sh = sh[p]
        return spec_axes(sh.spec, ndim)

    def leaf_totals(self, keys, sums) -> list[torch.Tensor]:
        """Each parameter leaf's ``sums`` (0-d, of its local block) summed
        over its distinct blocks: a rank adds its block's sum only where
        it sits at coordinate 0 along every axis that does not split the
        leaf (one replica a block), then one sum over every rank."""
        coord = self.ops.coordinate()
        own = []
        for k, s in zip(keys, sums):
            spec = self.shardings["params"][k].spec
            split = {a for axes in spec_axes(spec, len(spec)) for a in axes}
            first = all(coord[a] == 0 for a in coord if a not in split)
            own.append(s if first else torch.zeros_like(s))
        total = self.ops.sum_over(torch.stack(own), list(self.ops.sizes))
        return list(total.unbind(0))

    def mean(self, x: torch.Tensor, dims, layout: list[tuple],
             keepdim: bool = False) -> torch.Tensor:
        """The mean of the whole leaf over ``dims`` (None: all of them)
        from ``x``, this rank's block under ``layout``: the block's mean,
        divided by the number of blocks along those dimensions and summed
        over them (the blocks are equal in size)."""
        dims = tuple(range(x.dim())) if dims is None else dims
        m = torch.mean(x, dim=dims, keepdim=keepdim)
        axes = [a for d in (dims if isinstance(dims, tuple) else (dims,))
                for a in layout[d % x.dim()]]
        if not axes:
            return m
        m = m / math.prod(self.ops.sizes[a] for a in axes)
        return self.ops.sum_over(m, axes)
