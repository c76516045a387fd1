"""Per-device dry run of every (arch x shape x mesh) cell — the reference's
``repro.launch.dryrun`` for the port.

The reference lowers and compiles each cell with GSPMD for a 256- or
512-device TPU pod and keeps XLA's per-device memory and cost analyses.
PyTorch has no such compiler.  The port's dry run runs the program one
rank of the port runs, on ``meta`` tensors (shapes and types, no storage):

* its arguments are the rank's shards of the step's inputs, placed by
  ``parallel.sharding.tree_shardings`` on an ``AbstractMesh`` of
  ``launch/mesh.py``'s production shapes (no process group);
* the train step is ``launch/train.py``'s ``make_sharded_step`` itself,
  the state kept sharded: a parameter is gathered one super-block's
  layer slice at a time where the forward uses it, its gradient reduced
  to the rank's block, and the optimizer updates the blocks, through
  :class:`DryOps`, whose collectives move nothing.  Where ``model``
  splits their products (tensor parallelism, ``baseline``'s ``heads``,
  ``kv_heads``, ``ffn`` and ``vocab``), attention, the MLPs and the
  shared expert gather their block keeping ``model``, so do the RG-LRU
  and the SSD mixer where ``model`` splits all their own leaves
  (``ffn``, ``ssm_heads``), and the head projects to the rank's block of
  the vocabulary; their sums over the group move nothing here and their
  gathers over it repeat the rank's block, so a rank's cross-entropy is
  over its own block.  The MoE takes its expert-parallel paths by the
  same rules as on a process group (``a2a`` in train and prefill,
  ``psum`` in decode, the resident path under ``resident``): it gathers
  its experts keeping ``model`` (rank 0's ``E/ep`` experts a layer) and
  its ``all_to_all`` exchanges move nothing.  Where the
  rules put the batch over ``model`` and ``model`` does not divide the
  global batch (``dp_fsdp``'s multipod ``train_4k``: 8 rows a batch
  shard over 16 ``model`` ranks), the rank runs its padded tile of each
  microbatch's rows (``parallel.sharding.row_group``): coordinate 0's,
  the widest, so the estimate is the largest rank's.  A rank's loss is
  its share of the global batch's masked mean, whose sum over ranks
  moves nothing here: the cross-entropy reads the rank's own mean, and
  the MoE's aux (every rank's on a process group; here the router's over
  the rank's tokens) the rank's own over the rank count;
* prefill and decode (``train/serve.py``'s steps) take the parameters
  as the rank's shards too, gathered a layer at a time where the forward
  uses them, the products split over ``model`` as in the train step.
  Their KV cache follows ``cache_seq``: a prefill keeps each layer's
  block of the slots (cut right after the layer), and decode takes the
  cache's blocks as they are and runs attention sequence-parallel over
  them (the softmax's max and sums over ``model``, which move nothing
  here); a split RG-LRU's or SSD's cache is the rank's block of its
  channels or heads, run in place (the SSD's conv window gathered whole
  but its rows for a layer and cut back).  Where the batch splits over
  ``model`` a prefill runs the rank's tile of the rows as the train step
  does, and its outputs are their leaves' blocks: the logits' rows and
  each layer's cache (whose rows, ``cache_batch``, have no ``model``)
  gathered over the group (:class:`DryOps` repeats the rank's tile, cut
  back to the shard's rows: the gathered rows are counted once), the
  cache then cut to the rank's block of the slots.  Nothing is gathered
  whole before the step;
* the step runs on the rank's batch shard, and each output is cut back
  to the rank's block (a copy; none where it is the block already).

The record has the reference's keys:

* ``argument_bytes``, ``output_bytes`` and ``alias_bytes`` count the
  shards as XLA does: an uneven split padded to its largest shard, 8
  bytes of the output tuple a leaf, donated arguments (the train state,
  the decode cache) aliased to their outputs.  They equal the
  reference's.
* ``temp_bytes`` is the peak of the storage bytes alive while the program
  runs (:class:`LiveBytes`), less the arguments'.  It is the port's own
  program (its products split over ``model`` as above), not the
  reference's number.
* ``cost_analysis.flops`` is ``FlopCounterMode``'s count, the kernels'
  products included (``kernels/meta.py``); ``bytes_accessed`` and
  ``transcendentals`` are ``None``: there is no XLA cost model.
* ``fits``: argument + temp bytes within one card's memory (the card's
  when there is one, else an H100 80GB's); ``lower_s`` times the specs,
  shardings and arguments, ``compile_s`` the run on meta tensors.

``run_cell(..., execute=True)`` then runs the cell's program on the card
at the config's width and depth: each argument is a seeded draw in its
shard's shape (a cache's ``slot_pos`` each slot's own position, and a
decode cell's ``pos`` the cache's last, so that every slot attends), a
gather draws the leaf (one layer of it; a gather keeping ``model``, a
block of rank 0's shape) from the same seeds, nothing drawn whole to be
cut, and the peak (``max_memory_allocated`` after
``reset_peak_memory_stats``, less what was allocated before the
arguments) is held against the estimate.  The ``flash`` and ``ssdk`` tokens select the kernels there
(``attn_impl="flash"``, ``ssd_impl="kernel"``), and the estimate of such
a cell goes through their meta launches.

  python -m repro_torch.launch.dryrun --arch internlm2_1_8b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import pathlib
import time
import traceback
import weakref
import zlib
from dataclasses import dataclass

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as C
from repro_torch.kernels.flash_attn import (flash_bwd_dkv, flash_bwd_dq,
                                            flash_fwd)
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import train as LT
from repro_torch.launch.mesh import PRODUCTION_SHAPES
from repro_torch.models import transformer as T
from repro_torch.models.transformer import TensorSpec
from repro_torch.parallel import sharding as SH
from repro_torch.train import serve as SRV
from repro_torch.train import step as ST
from repro_torch.train.optim import OptConfig

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")
H100_80GB_BYTES = 85_017_493_504   # an H100 80GB HBM3's total_memory
BATCH_AXES = ("batch", "cache_batch")
TUPLE_ENTRY_BYTES = 8              # XLA's output tuple: a pointer a leaf
EXECUTE_HEADROOM = 0.1             # a card run leaves this share free


def apply_policy(cfg, shape: str, policy: str = "baseline"):
    """Policy = '+'-joined hillclimb tokens (the reference's, token for
    token):

      fused     flash-style fused-softmax attention (single f32 crossing)
      flash     the reference's XLA stand-in, ``fused``; ``run_cell``'s
                card run takes the flash kernel (see the module)
      ssdk      no change here; the card run takes the SSD kernel
      msp       MoE input seq-sharded (no bwd psum of replicated dx)
      resident  expert weights resident (E->model, F->data); tokens travel
      dp_all    pure DP over every mesh axis; no TP (small models)
      serve_tp, cache_heads, dp_fsdp, attn_dp   layout overrides
      dots      remat policy 'dots'   | noremat   remat off
      mb2/mb4   gradient-accumulation microbatches
      qc<N>     q chunk N
      statebf16 bf16 optimizer state

    Returns (cfg, rules, microbatches).
    """
    rules = SH.DEFAULT_RULES
    sp = C.SHAPES[shape]
    if sp.kind == "decode" and sp.global_batch == 1:
        # long-context single sequence: nothing to shard on batch
        rules = rules.override(batch=(), cache_batch=())
    mb = 1
    for tok in policy.split("+"):
        if tok in ("baseline", ""):
            continue
        elif tok == "fused":
            cfg = cfg.with_(attn_impl="fused")
        elif tok == "flash":
            # the reference's XLA lowering uses the fused stand-in for the
            # TPU kernel; so does the estimate here
            cfg = cfg.with_(attn_impl="fused")
        elif tok == "ssdk":
            pass
        elif tok == "msp":
            cfg = cfg.with_(moe_seq_shard=True)
        elif tok == "resident":
            cfg = cfg.with_(moe_expert_resident=True)
            rules = rules.override(expert_ffn=("data",))
        elif tok == "dp_all":
            rules = rules.override(
                batch=("pod", "data", "model"), embed=(), heads=(), kv_heads=(),
                ffn=(), vocab=(), act_heads=(), act_ffn=(), act_vocab=())
        elif tok == "serve_tp":
            # serving: weights TP-sharded but NOT FSDP'd
            rules = rules.override(embed=())
        elif tok == "cache_heads":
            # decode: shard the KV cache on heads, not sequence
            rules = rules.override(cache_seq=(), cache_kv_heads=("model",),
                                   act_heads=())
        elif tok == "dp_fsdp":
            # pure DP batch over every axis + FSDP weight sharding over data
            rules = rules.override(
                batch=("pod", "data", "model"), heads=(), kv_heads=(),
                ffn=(), vocab=(), act_heads=(), act_ffn=(), act_vocab=())
        elif tok == "attn_dp":
            # attention/dense weights replicated over model, batch DP over
            # every axis, experts EP over model
            rules = rules.override(
                batch=("pod", "data", "model"), heads=(), kv_heads=(),
                vocab=(), act_heads=(), act_ffn=(), act_vocab=(), ffn=())
        elif tok == "dots":
            cfg = cfg.with_(remat="dots")
        elif tok == "noremat":
            cfg = cfg.with_(remat="none")
        elif tok.startswith("mb"):
            mb = int(tok[2:])
        elif tok.startswith("qc"):
            cfg = cfg.with_(q_chunk=int(tok[2:]))
        elif tok == "statebf16":
            pass  # handled in opt_for
        else:
            raise KeyError(f"unknown policy token {tok!r}")
    return cfg, rules, mb


def opt_for(arch: str, policy: str = "baseline") -> OptConfig:
    kw = {}
    if arch == "minicpm_2b":
        kw["schedule"] = "wsd"
    if arch == "llama4_maverick_400b_a17b" or "statebf16" in policy:
        # 400B: bf16 optimizer state to fit one pod
        kw["state_dtype"] = "bfloat16"
    return OptConfig(**kw)


def kernel_config(cfg, policy: str):
    """``cfg`` with the kernels the policy's ``flash`` and ``ssdk`` tokens
    stand for on the card."""
    toks = policy.split("+")
    if "flash" in toks:
        cfg = cfg.with_(attn_impl="flash")
    if "ssdk" in toks:
        cfg = cfg.with_(ssd_impl="kernel")
    return cfg


def make_abstract_mesh(*, multi_pod: bool = False) -> SH.AbstractMesh:
    """The production mesh's names and sizes, with no process group."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return SH.AbstractMesh(shape, axes)


# ---------------------------------------------------------------------------
# a rank's leaves


@dataclass(frozen=True)
class Leaf:
    """One argument or output leaf of a rank's program: its global spec,
    logical axes and sharding."""

    name: str
    spec: TensorSpec
    axes: tuple
    sharding: SH.NamedSharding

    def _blocks(self) -> list[int]:
        sizes = SH.mesh_shape(self.sharding.mesh)
        spec = self.sharding.spec
        out = []
        for i in range(len(self.spec.shape)):
            part = spec[i] if i < len(spec) else None
            axes = (part,) if isinstance(part, str) else tuple(part or ())
            out.append(math.prod(sizes[a] for a in axes))
        return out

    def _is_batch(self, i: int) -> bool:
        return i < len(self.axes) and self.axes[i] in BATCH_AXES

    @property
    def shard_shape(self) -> tuple[int, ...]:
        """The rank's shard, padded as XLA pads an uneven split."""
        return tuple(-(-d // n) for d, n in zip(self.spec.shape,
                                                self._blocks()))

    @property
    def local_shape(self) -> tuple[int, ...]:
        """Gathered whole but along the batch axes."""
        return tuple(s if self._is_batch(i) else d for i, (d, s) in
                     enumerate(zip(self.spec.shape, self.shard_shape)))

    @property
    def nbytes(self) -> int:
        return math.prod(self.shard_shape) * self.spec.dtype.itemsize

    @property
    def is_int_scalar(self) -> bool:
        """The port keeps int32 scalars (``step``, ``count``, ``pos``) as
        Python ints (``launch/train.py`` ``state_template``)."""
        return self.spec.shape == () and self.spec.dtype == torch.int32

    def place(self, t):
        """The rank's block of ``t`` (its local tensor): a copy that owns
        only the block's bytes where a non-batch axis splits, else ``t``."""
        if not isinstance(t, torch.Tensor):
            return t
        idx = tuple(slice(0, s) for s in self.shard_shape)
        out = t[idx]
        if out.shape == t.shape:
            return t
        return out.clone(memory_format=torch.contiguous_format)


def _leaves(specs, axes, mesh, rules, name=""):
    """A tree (dicts) of :class:`Leaf` from matching trees of specs and
    logical axes."""
    if isinstance(specs, dict):
        return {k: _leaves(specs[k], axes[k], mesh, rules, f"{name}/{k}")
                for k in specs}
    sh = SH.logical_sharding(axes, mesh, rules, tuple(specs.shape))
    return Leaf(name, specs, tuple(axes), sh)


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _flat(v)]
    return [tree]


def _map(fn, tree, *others):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    return fn(tree, *others)


def gather_tree(xs, leaves, gather):
    """``gather(leaf, x)`` over a tree."""
    if isinstance(leaves, dict):
        return {k: gather_tree(xs[k], leaves[k], gather) for k in leaves}
    return gather(leaves, xs)


def place_tree(xs, leaves):
    return _map(lambda leaf, x: leaf.place(x), leaves, xs)


# ---------------------------------------------------------------------------
# the program


class DryOps(SH.MeshOps):
    """The sharded step's collectives on an ``AbstractMesh``, run by the
    dry run's rank (coordinate 0 on every axis): they move nothing.  A
    sum (or max) over ranks leaves the rank's own values, a gather
    repeats its block, a reduce-scatter keeps its first block (in a
    tensor of the block's bytes, as NCCL's gives), an all-to-all keeps
    its blocks where they are (in a fresh tensor of the input's bytes, as
    the exchange's output buffer), and the gather of a
    parameter is ``gather(leaf, x, index, keep)``, the program's own
    (``meta_gather``, ``seeded_gather``) on the parameter's :class:`Leaf`
    (``params``, by key)."""

    def __init__(self, mesh, gather, params: dict):
        super().__init__(mesh)
        self._gather, self.params = gather, params

    def coordinate(self) -> dict[str, int]:
        return {a: 0 for a in self.sizes}

    def all_reduce(self, x, axis, op="sum") -> None:
        pass

    def all_gather(self, x, axis, dim):
        return torch.cat([x] * self.sizes[axis], dim=dim)

    def reduce_scatter(self, x, axis, dim):
        return x.narrow(dim, 0, x.shape[dim] // self.sizes[axis]).clone()

    def all_to_all(self, x, axis):
        return x.clone(memory_format=torch.contiguous_format)

    def gather(self, leaf, keep):
        return self._gather(self.params[leaf.key], leaf.local, leaf.index,
                            keep)


@dataclass
class Lowerable:
    """A rank's program for one cell: ``program(gather, *args)`` with
    ``gather(leaf, shard, index=None, keep=()) -> local tensor``
    (``index``: one layer of a stacked leaf; ``keep``: mesh axes whose
    split stays, rank 0's block along them); ``args`` and ``outs`` are
    trees of :class:`Leaf`, one an argument or output; ``donate`` the
    positions of donated arguments, ``unused`` of those the step never
    reads, which ``jax.jit`` drops from the compiled program
    (``keep_unused=False``): decode's ``pos`` where no layer attends."""

    kind: str
    cfg: object
    program: object
    args: tuple
    outs: tuple
    donate: tuple
    devices: int
    unused: tuple = ()


def metrics_specs() -> dict:
    f32 = torch.float32
    return {"loss": TensorSpec((), f32), "ce": TensorSpec((), f32),
            "aux": TensorSpec((), f32), "grad_norm": TensorSpec((), f32),
            "lr": TensorSpec((), f32), "step": TensorSpec((), torch.int32)}


def build_lowerable(arch: str, shape: str, mesh, policy: str = "baseline",
                    microbatches: int | None = None, *,
                    kernels: bool = False):
    """Returns (sharding context, :class:`Lowerable`).  ``kernels=True``
    selects the kernels of the policy's ``flash`` and ``ssdk`` tokens
    (:func:`kernel_config`)."""
    cfg = C.get_config(arch)
    sp = C.SHAPES[shape]
    cfg, rules, mb = apply_policy(cfg, shape, policy)
    if kernels:
        cfg = kernel_config(cfg, policy)
    microbatches = microbatches or mb
    ctx = SH.sharding_context(mesh, rules)
    devices = math.prod(SH.mesh_shape(mesh).values())

    def leaves(specs, axes, name):
        return _leaves(specs, axes, mesh, rules, name)

    b_specs, b_axes = C.input_specs(cfg, shape), C.batch_axes(cfg, shape)
    if sp.kind == "train":
        opt_cfg = opt_for(arch, policy)
        shapes, axes = ST.train_state_specs(cfg, opt_cfg)
        state, batch = leaves(shapes, axes, "state"), leaves(b_specs, b_axes,
                                                             "batch")
        mets = leaves(metrics_specs(), ST.metrics_axes(), "metrics")
        step_fn = ST.make_train_step(cfg, opt_cfg, microbatches=microbatches,
                                     donate=True)
        # the mean over every rank, its all-reduce moving nothing
        mean = functools.partial(LT._mean_over_ranks, n=devices,
                                 all_reduce=lambda t: None)
        state_sh = _map(lambda leaf: leaf.sharding, state)

        def train_program(gather, st, bt):
            with ctx:
                step = LT.make_sharded_step(
                    step_fn, mesh, state_sh,
                    ops=DryOps(mesh, gather, state["params"]),
                    place=lambda new, _: place_tree(new, state), mean=mean,
                    rows=sp.global_batch)
                return step(st, gather_tree(bt, batch, gather))

        return ctx, Lowerable("train", cfg, train_program, (state, batch),
                              (state, mets), (0,), devices)

    params = leaves(T.param_shapes(cfg), T.param_axes(cfg), "params")
    B, S = sp.global_batch, sp.seq_len
    cache = leaves(T.cache_shapes(cfg, B, S), T.cache_axes(cfg, B, S),
                   "cache")
    logits = leaves(TensorSpec((B, 1, cfg.vocab_size), torch.float32),
                    ("batch" if sp.kind == "prefill" else "cache_batch",
                     None, "act_vocab"), "logits")

    def shards(xs, tree, gather):
        """The rank's blocks as ``ShardedLeaf`` s whose gathers are
        ``gather`` (:class:`DryOps` over ``tree``, :class:`Leaf` s by
        key)."""
        return SH.sharded_leaves(xs, _map(lambda leaf: leaf.sharding, tree),
                                 DryOps(mesh, gather, tree))

    def logits_out(p, lg):
        """The rank's logits as their output leaf holds them: where the
        head projects to a padded tile of a vocabulary that the leaf's
        spec leaves whole (``model`` does not divide it), the group's
        tiles gathered whole, as GSPMD replicates that output."""
        tp = T.head_split(p, cfg)
        if tp is not None and lg.shape[-1] != logits.shard_shape[-1]:
            lg = tp.gather(lg, -1, cfg.vocab_size)
        return logits.place(lg)

    if sp.kind == "prefill":
        batch = leaves(b_specs, b_axes, "batch")
        step = SRV.make_prefill_step(cfg)

        def prefill_program(gather, p, bt):
            with ctx:
                p = shards(p, params, gather)
                c, lg = step(p, gather_tree(bt, batch, gather), rows=B)
                return place_tree(c, cache), logits_out(p, lg)

        return ctx, Lowerable("prefill", cfg, prefill_program, (params, batch),
                              (cache, logits), (), devices)
    # decode
    toks = leaves(b_specs, b_axes, "batch")
    step = SRV.make_decode_step(cfg)

    def decode_program(gather, p, c, tokens, pos):
        with ctx:
            p = shards(p, params, gather)
            new, lg = step(p, shards(c, cache, gather),
                           gather(toks["tokens"], tokens),
                           gather(toks["pos"], pos))
            return place_tree(new, cache), logits_out(p, lg)

    attends = any(k in T.ATTN_KINDS for k in cfg.layer_kinds)
    return ctx, Lowerable("decode", cfg, decode_program,
                          (params, cache, toks["tokens"], toks["pos"]),
                          (cache, logits), (1,), devices,
                          () if attends else (3,))


# ---------------------------------------------------------------------------
# counting


class LiveBytes(TorchDispatchMode):
    """The bytes of tensor storage alive on ``device`` while the mode is
    on, and their peak: each storage an operator returns is counted from
    that operator until it is freed (a weakref finalizer on the storage);
    views and in-place results add nothing.  :meth:`track` counts tensors
    made before the mode (the arguments)."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device).type
        self.live = self.peak = 0
        self._seen: set[int] = set()

    def track(self, t) -> int:
        if not isinstance(t, torch.Tensor) or t.device.type != self.device:
            return 0
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return 0
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)
        return n

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            self.track(t)
        return out


def make_args(low: Lowerable, make) -> tuple:
    """The rank's arguments, ``make(leaf)`` a leaf (int32 scalars as 0)."""
    def one(leaf):
        return 0 if leaf.is_int_scalar else make(leaf)
    return tuple(_map(one, tree) for tree in low.args)


def meta_args(low: Lowerable) -> tuple:
    """The rank's argument shards as meta tensors."""
    return make_args(low, lambda leaf: torch.empty(
        leaf.shard_shape, dtype=leaf.spec.dtype, device="meta"))


def gathered_shape(leaf: Leaf, index=None, keep=()) -> tuple[int, ...]:
    """``leaf``'s local shape, its shard's along the dimensions that the
    axes in ``keep`` split, of one layer where ``index`` is given."""
    split = SH.spec_axes(leaf.sharding.spec, len(leaf.spec.shape))
    shape = tuple(s if set(axes) & set(keep) else d for d, s, axes in
                  zip(leaf.local_shape, leaf.shard_shape, split))
    return shape[1:] if index is not None else shape


def meta_gather(leaf: Leaf, x, index=None, keep=()):
    shape = gathered_shape(leaf, index, keep)
    if not isinstance(x, torch.Tensor) or shape == x.shape:
        return x
    return torch.empty(shape, dtype=x.dtype, device=x.device)


def run_program(low: Lowerable, ctx, args, gather, device):
    """Runs ``low``'s program on ``args`` under :class:`LiveBytes` and
    ``FlopCounterMode``; -> (outputs, live bytes of the arguments, peak
    live bytes, FLOP).  ``args`` is emptied (its trees go to the
    program; donated ones are freed as the program gathers them)."""
    mem = LiveBytes(device)
    arg_bytes = sum(mem.track(t) for t in pytree.tree_leaves(args))
    with FlopCounterMode(display=False) as fc, mem:
        outs = low.program(gather, *_pop_all(args))
    return outs, arg_bytes, mem.peak, fc.get_total_flops()


def _pop_all(args: list):
    out = tuple(args)
    args.clear()
    return out


def card_bytes() -> int:
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return H100_80GB_BYTES


# ---------------------------------------------------------------------------
# the card run of a cell


def _seed(seed: int, name: str) -> int:
    return (seed * 1_000_003 + zlib.crc32(name.encode())) & ((1 << 63) - 1)


def _stacked(leaf: Leaf) -> bool:
    return leaf.axes[:1] == ("stack",)


def seeded_leaf(leaf: Leaf, shape, seed: int, device, vocab: int,
                index=None):
    """``leaf`` drawn in ``shape`` (its shard's, or a gather's), or its
    layer ``index`` (``shape`` = the layer's), from seeds of its own: the
    rule of ``layers.init_from_specs`` (``*_scale``/``*norm`` ones,
    ``*_bias``/``*_b`` zeros, else normal x min(0.02, 1/sqrt(fan_in)) of
    the whole leaf's fan-in) drawn in the leaf's type; the optimizer's
    moments zeros, as a fresh state's; tokens uniform below ``vocab``; a
    cache's ``slot_pos`` each slot's own position (every slot valid; rank
    0's block of the slots is their first).  A stacked leaf draws each
    layer from that layer's seed, so that a layer drawn alone is that
    layer of the whole draw."""
    dt = leaf.spec.dtype
    path = leaf.name.split("/")
    base = path[-1]

    def gen(name):
        return torch.Generator(device=device).manual_seed(_seed(seed, name))

    if base.endswith("slot_pos"):
        # in place: one tensor, as a meta gather's
        return torch.ones(shape, dtype=dt, device=device).cumsum_(-1).sub_(1)
    if not dt.is_floating_point:
        return torch.randint(0, vocab, shape, generator=gen(leaf.name),
                             dtype=dt, device=device)
    t = torch.empty(shape, dtype=dt, device=device)
    if base.endswith("_scale") or base.endswith("norm"):
        return t.fill_(1)
    if base.endswith("_bias") or base.endswith("_b") or "opt" in path:
        return t.zero_()
    gs = leaf.spec.shape
    std = min(0.02, 1.0 / math.sqrt(gs[0] if len(gs) >= 2
                                    else max(gs[-1], 1)))
    if not _stacked(leaf):
        return t.normal_(0.0, std, generator=gen(leaf.name))
    layers = [(index, t)] if index is not None else enumerate(t.unbind(0))
    for i, layer in layers:
        layer.normal_(0.0, std, generator=gen(f"{leaf.name}/{i}"))
    return t


def seeded_args(low: Lowerable, seed: int, device) -> tuple:
    """Each argument drawn in its shard's shape from the leaf's seeds, by
    :func:`seeded_leaf`'s rule (a stacked leaf's layers each from its
    own): no leaf, nor a layer of one, is drawn whole to be cut."""
    vocab = low.cfg.vocab_size
    return make_args(low, lambda leaf: seeded_leaf(
        leaf, leaf.shard_shape, seed, device, vocab))


def seeded_gather(seed: int, device, vocab: int):
    """A gather that draws the leaf's layer again from ``seed``; keeping
    axes, a block of rank 0's shape drawn alone from the same seed, by
    the same rule (the one tensor the gather makes, as in
    ``meta_gather``; a layer of Llama-4's 128 experts is never drawn
    whole)."""
    def gather(leaf: Leaf, x, index=None, keep=()):
        shape = gathered_shape(leaf, index, keep)
        if not isinstance(x, torch.Tensor) or shape == x.shape:
            return x
        return seeded_leaf(leaf, shape, seed, device, vocab, index)
    return gather


def _finite(ts) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in ts
               if isinstance(t, torch.Tensor) and t.is_floating_point())


def _shapes_ok(outs, leaves) -> bool:
    ok = []
    _map(lambda leaf, t: ok.append(not isinstance(t, torch.Tensor)
                                   or tuple(t.shape) == leaf.shard_shape),
         leaves, outs)
    return all(ok)


def decode_pos(low: Lowerable) -> int:
    """The position a decode cell's card run writes: its cache's length
    less one, so that every slot of :func:`seeded_leaf`'s cache
    attends (0 where no layer attends)."""
    return max((leaf.spec.shape[-1] for leaf in _flat(low.args[1])
                if leaf.name.endswith("slot_pos")), default=1) - 1


def execute_cell(low: Lowerable) -> dict:
    """Runs a cell's program on the card from seed 0 (a decode cell's at
    :func:`decode_pos`); -> its measured peak, wall time, kernel
    launches and whether every output is finite (a train cell's metrics:
    its loss among them) and of its shard's shape; a train cell's
    ``loss``, ``ce`` and ``aux``, their mean over ranks moving nothing:
    ``ce`` the rank's own (its share's sums over ranks move nothing),
    ``aux`` the rank's own over the rank count (see the module)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    args = list(seeded_args(low, 0, dev))
    if low.kind == "decode":
        args[3] = decode_pos(low)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = (flash_fwd, flash_bwd_dq, flash_bwd_dkv, ssd_scan)
    n0 = [k.launches for k in kernels]
    t0 = time.perf_counter()
    outs = low.program(seeded_gather(0, dev, low.cfg.vocab_size),
                       *_pop_all(args))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    launches = {k.__name__: k.launches - n for k, n in zip(kernels, n0)}
    if low.kind != "train":
        cache, logits = outs
        finite = _finite(_flat(cache) + [logits])
        shapes_ok = (tuple(logits.shape) == low.outs[1].shard_shape
                     and _shapes_ok(cache, low.outs[0]))
        extra = {}
    else:
        state, mets = outs
        finite = _finite(_flat(mets))
        shapes_ok = _shapes_ok(state, low.outs[0]) and _shapes_ok(
            mets, low.outs[1])
        extra = {k: float(mets[k]) for k in ("loss", "ce", "aux")}
    del outs
    return {"peak_bytes": peak, "wall_s": wall, "launches": launches,
            "finite": finite, "shapes_ok": shapes_ok,
            "device": torch.cuda.get_device_name(dev), **extra}


# ---------------------------------------------------------------------------


def run_cell(arch: str, shape: str, mesh_kind: str, policy: str = "baseline",
             save: bool = True, tag: str = "", out_dir=None, *,
             execute: bool = False) -> dict:
    """One cell's record (see the module).  ``execute=True`` (with a
    card) estimates the cell with the policy's
    kernels and, when that estimate leaves ``EXECUTE_HEADROOM`` of the
    card free, runs it there: the record's ``execute`` holds the
    measured peak, its ratio to the estimate, the wall time and the
    launches."""
    cfg = C.get_config(arch)
    ok, why = C.applicable(cfg, shape)
    cell = f"{arch}__{shape}__{mesh_kind}" + (f"__{tag}" if tag else "")
    if not ok:
        return {"cell": cell, "status": "skipped", "reason": why}
    t0 = time.time()
    mesh = make_abstract_mesh(multi_pod=(mesh_kind == "multipod"))
    ctx, low = build_lowerable(arch, shape, mesh, policy,
                               kernels=execute)
    args = list(meta_args(low))
    t_lower = time.time() - t0
    t0 = time.time()
    _, arg_live, peak, flops = run_program(low, ctx, args, meta_gather,
                                           "meta")
    t_compile = time.time() - t0
    arg_bytes = sum(leaf.nbytes for i, tree in enumerate(low.args)
                    if i not in low.unused for leaf in _flat(tree))
    out_leaves = [leaf for tree in low.outs for leaf in _flat(tree)]
    out_bytes = sum(leaf.nbytes for leaf in out_leaves) \
        + TUPLE_ENTRY_BYTES * len(out_leaves)
    alias = sum(leaf.nbytes for i in low.donate
                for leaf in _flat(low.args[i]))
    temp = peak - arg_live
    limit = card_bytes()
    rec = {
        "cell": cell, "status": "ok", "arch": arch, "shape": shape,
        "mesh": mesh_kind, "policy": policy, "devices": low.devices,
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": temp, "alias_bytes": alias},
        "cost_analysis": {"flops": float(flops), "bytes_accessed": None,
                          "transcendentals": None},
        "param_counts": cfg.param_counts(),
        "fits": arg_bytes + temp <= limit, "card_bytes": limit,
        "attn_impl": low.cfg.attn_impl, "ssd_impl": low.cfg.ssd_impl,
    }
    if execute:
        est = arg_bytes + temp
        if est > (1.0 - EXECUTE_HEADROOM) * limit:
            rec["execute"] = {"skipped": f"estimate {est} B over "
                              f"{1.0 - EXECUTE_HEADROOM:.2f} of {limit} B"}
        else:
            run = execute_cell(low)
            run["estimate_bytes"] = est
            run["ratio"] = run["peak_bytes"] / est
            rec["execute"] = run
    if save:
        out = pathlib.Path(out_dir) if out_dir is not None else OUT_DIR
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{cell}.json").write_text(json.dumps(rec, indent=1))
    return rec


def iter_cells(mesh_kinds):
    for arch in C.ARCH_IDS:
        for shape in C.SHAPES:
            for mk in mesh_kinds:
                yield arch, shape, mk


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--policy", default="baseline")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="where the records go (default %(default)s)")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)

    mesh_kinds = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = list(iter_cells(mesh_kinds))
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape, mk) for mk in mesh_kinds]
    else:
        ap.error("--arch and --shape, or --all")

    n_ok = n_skip = n_fail = 0
    for arch, shape, mk in cells:
        try:
            rec = run_cell(arch, shape, mk, args.policy, tag=args.tag,
                           out_dir=out)
        except Exception as e:  # noqa: BLE001 - record and continue
            rec = {"cell": f"{arch}__{shape}__{mk}", "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            out.mkdir(parents=True, exist_ok=True)
            (out / f"{rec['cell']}.json").write_text(json.dumps(rec, indent=1))
        st = rec["status"]
        n_ok += st == "ok"
        n_skip += st == "skipped"
        n_fail += st == "error"
        extra = ""
        if st == "ok":
            m = rec["memory"]
            extra = (f"run={rec['compile_s']}s "
                     f"arg={m['argument_bytes'] / 2**30:.2f}GiB "
                     f"temp={m['temp_bytes'] / 2**30:.2f}GiB "
                     f"fits={rec['fits']} "
                     f"flops={rec['cost_analysis']['flops']:.3g}")
        elif st == "error":
            extra = rec["error"][:200]
        print(f"[{st:7s}] {rec['cell']} {extra}", flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} failed={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
