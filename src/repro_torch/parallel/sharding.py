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
the weights and runs each rank's forward on plain local tensors (its batch
shard), so such a constraint would change no number, and the port's model
code calls none.  :func:`shard_act` exists for callers holding DTensors:
it redistributes one to the spec's placements and returns a plain tensor
unchanged.  The ``jax`` version shims (``make_mesh``'s ``axis_types``,
``shard_map``) have no counterpart.
"""

from __future__ import annotations

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
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    local = full[sharding.local_slices(full.shape, mesh.get_coordinate())]
    if device is not None:
        local = local.to(device)
    local = local.contiguous()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        local = local.clone()
    return DTensor.from_local(local, mesh, sharding.placements,
                              run_check=False, shape=full.shape,
                              stride=torch.empty(full.shape,
                                                 device="meta").stride())
