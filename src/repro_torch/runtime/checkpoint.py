"""Sharded, fault-tolerant checkpointing of a state of torch tensors.

Design points for 1000-node fleets:

* **per-leaf files + manifest**: every leaf is one ``.npy`` under
  ``step_N/``, with a JSON manifest holding shape/dtype/sha256 — a partial
  or torn write can never masquerade as a complete checkpoint because the
  manifest is written *last* (atomic rename).
* **async save**: the host copy happens inside ``save``; serialization
  runs on a background thread while the train loop keeps stepping
  (``save(..., blocking=False)``).
* **restore**: ``restore`` rebuilds a state shaped like a template whose
  leaves may live on any device (``meta`` included); leaves absent from
  the checkpoint fall back to an initializer callback (new parameters).
* **retention**: keep the newest ``keep`` complete checkpoints.
* **sharded state**: a split DTensor leaf is assembled whole in rank 0's
  host memory, a piece of every rank's block at a time (``dist.gather``
  to rank 0; leading-axis rows, or a part of one row where a row of
  every rank would not fit: at most ``SAVE_GATHER_BYTES`` and less than
  the leaf on a rank's device at once), so that no rank's device ever
  holds a whole leaf; rank 0 alone writes, and the files are those of a
  world-size-1 save of the same state.  A blocking save of such a state
  ends in a barrier, so that every rank returns once the checkpoint
  exists.  ``restore(placements=)`` gives each leaf back as a DTensor
  placed by a tree of ``parallel.sharding.NamedSharding`` (the
  reference's ``shardings=``), each rank's shard cut from the whole array
  on the host.

The files are those of the JAX package's ``CheckpointManager``, byte for
byte, so either package restores the other's checkpoints:

* leaves are taken in the order jax flattens a pytree (dict keys sorted,
  lists and tuples by index) and keyed by their path joined with ``/``;
* each ``.npy`` holds the leaf's raw bytes as a 1-D uint8 array; a bf16
  tensor writes its 16-bit patterns under dtype ``"bfloat16"`` (what an
  ``ml_dtypes`` array writes), and a Python ``int`` leaf (the port's step
  counters) writes as the reference's ``jnp.int32`` scalars do: shape
  ``[]``, dtype ``"int32"``.

A failed background write raises out of the next ``wait`` (or ``save``).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import math
import pathlib
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def _leaves(tree, path=()):
    """(path, leaf) pairs in jax's flattening order; None is an empty
    subtree, as in jax."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _rebuild(tree, values, path=()):
    """``tree``'s structure with each leaf replaced by ``values[path]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return values[path]


def _is_dtensor(leaf) -> bool:
    if not isinstance(leaf, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


SAVE_GATHER_BYTES = 1 << 28   # a sharded save's pieces on rank 0's device


def _is_split(leaf) -> bool:
    return _is_dtensor(leaf) and any(p.is_shard() for p in leaf.placements)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """``t``'s values on the host (bf16 as its 16-bit patterns)."""
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _rank_blocks(leaf) -> dict[int, tuple[slice, ...]]:
    """For each rank of a DTensor's mesh, the slices of the whole leaf
    that its local block holds (a dimension split by several mesh
    dimensions takes the first outermost, as DTensor lays them out)."""
    ranks = leaf.device_mesh.mesh
    local = leaf.to_local().shape
    out = {}
    for coord in itertools.product(*(range(n) for n in ranks.shape)):
        sl = []
        for d, w in enumerate(local):
            idx = 0
            for j, p in enumerate(leaf.placements):
                if p.is_shard(d):
                    idx = idx * ranks.shape[j] + coord[j]
            sl.append(slice(idx * w, (idx + 1) * w))
        out[int(ranks[coord])] = tuple(sl)
    return out


def _pieces(shape: tuple, item: int, world: int) -> list[tuple[slice, ...]]:
    """The pieces, in order, in which each rank sends a block of ``shape``
    (``item`` bytes a value) to rank 0: each at most
    ``SAVE_GATHER_BYTES // (world + 1)`` bytes (rank 0 holds ``world``
    received and the one it sends) and under half the block where the
    block has more than one value.  A piece is ``k`` consecutive indices
    of the first dimension ``d`` of which one index fits, and one index
    of each dimension before ``d``."""
    n = math.prod(shape)
    if n == 0:
        return []
    limit = max(item, min(SAVE_GATHER_BYTES // (world + 1), n * item // 2))
    d = next(i for i in range(len(shape))
             if math.prod(shape[i + 1:]) * item <= limit)
    k = max(1, min(shape[d], limit // (math.prod(shape[d + 1:]) * item)))
    rest = tuple(slice(0, w) for w in shape[d + 1:])
    return [tuple(slice(i, i + 1) for i in idx)
            + (slice(j, min(j + k, shape[d])),) + rest
            for idx in itertools.product(*(range(w) for w in shape[:d]))
            for j in range(0, shape[d], k)]


def _host_sharded(leaf) -> np.ndarray | None:
    """A split DTensor leaf assembled whole in rank 0's host memory (None
    on the other ranks): every rank sends its block a piece at a time
    (:func:`_pieces`) to rank 0 (``dist.gather``), which writes each
    rank's piece where its block lies.  A rank's device holds at most
    ``SAVE_GATHER_BYTES`` of pieces at once, and less than the leaf."""
    local = leaf.to_local().detach()
    world, rank = dist.get_world_size(), dist.get_rank()
    pieces = _pieces(tuple(local.shape), local.element_size(), world)
    host = blocks = bufs = None
    if rank == 0:
        host = np.empty(tuple(leaf.shape), _numpy(local[:0]).dtype)
        blocks = _rank_blocks(leaf)
        # one buffer a rank, reused by every round, so that what the
        # collective still references of a round holds no more memory
        most = local[pieces[0]].numel() if pieces else 0
        bufs = [local.new_empty(most) for _ in range(world)]
    for sl in pieces:
        piece = local[sl].contiguous()
        parts = ([b[:piece.numel()].view(piece.shape) for b in bufs]
                 if rank == 0 else None)
        dist.gather(piece, parts, dst=0)
        if rank == 0:
            for r, part in enumerate(parts):
                at = tuple(slice(b.start + s.start, b.start + s.stop)
                           for b, s in zip(blocks[r], sl))
                host[at] = _numpy(part)
        del piece, parts
    return host


def _host(leaf) -> tuple[np.ndarray, str]:
    """One leaf copied to the host as a contiguous array of its bytes, and
    the dtype string the manifest records (a split DTensor assembled by
    :func:`_host_sharded`, a replicated one from its local tensor)."""
    if _is_split(leaf):
        a = _host_sharded(leaf)
        return a, "bfloat16" if leaf.dtype == torch.bfloat16 else str(a.dtype)
    if _is_dtensor(leaf):
        leaf = leaf.to_local()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", memory_format=torch.contiguous_format,
                             copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        a = np.asarray(leaf, np.int32)
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _flatten(state) -> dict[str, tuple[np.ndarray, str]]:
    return {_key(path): _host(leaf) for path, leaf in _leaves(state)}


def _tensor(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """A leaf's bytes (``raw``, uint8) as a CPU tensor of its type."""
    if dtype == "bfloat16":
        t = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(raw.view(np.dtype(dtype)))
    return t.reshape(shape)


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _placed(full: torch.Tensor, sharding):
    """``full`` (on the host) as a DTensor placed by ``sharding``, on its
    mesh's device."""
    from repro_torch.parallel.sharding import distribute

    mesh = sharding.mesh
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    return distribute(full, sharding, dev)


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        #: one entry per finished write: step, bytes, host_s (the copy
        #: inside ``save``), write_s (files, hashes, rename, retention)
        self.history: list[dict] = []

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, *, blocking: bool = True) -> None:
        t0 = time.perf_counter()
        sharded = any(_is_dtensor(v) for _, v in _leaves(state))
        if sharded and dist.get_rank() != 0:
            # every rank joins the gathers, in rank 0's order; rank 0
            # alone writes, so the others copy nothing to the host
            for _, leaf in _leaves(state):
                if _is_split(leaf):
                    _host_sharded(leaf)
            if blocking:
                dist.barrier()
            return
        flat = _flatten(state)  # host copies happen here, before returning
        host_s = time.perf_counter() - t0
        if blocking:
            self._write(step, flat, host_s)
            if sharded:
                dist.barrier()
            return
        self.wait()
        self._thread = threading.Thread(target=self._write_bg,
                                        args=(step, flat, host_s),
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _write_bg(self, step: int, flat: dict, host_s: float) -> None:
        try:
            self._write(step, flat, host_s)
        except Exception as e:   # noqa: BLE001 — re-raised by wait()
            self._error = e

    def _write(self, step: int, flat: dict, host_s: float = 0.0) -> None:
        t0 = time.perf_counter()
        tmp = self.dir / f".tmp_step_{step}"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {}
        nbytes = 0
        for key, (arr, dtype) in flat.items():
            fname = key.replace("/", "__") + ".npy"
            # raw bytes: exotic dtypes (bfloat16 etc.) don't survive a
            # plain np.save/np.load round trip without pickling
            raw = arr.reshape(-1).view(np.uint8)
            np.save(tmp / fname, raw)
            manifest[key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype,
                "sha256": hashlib.sha256(raw).hexdigest(),
            }
            nbytes += raw.nbytes
        (tmp / "manifest.json").write_text(
            json.dumps({"step": step, "leaves": manifest}))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)          # manifest-last + atomic rename
        self._gc()
        self.history.append({"step": step, "bytes": nbytes, "host_s": host_s,
                             "write_s": time.perf_counter() - t0})

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for d in self.dir.glob("step_*"):
            if (d / "manifest.json").exists():
                out.append(int(d.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like, *, step: int | None = None, device="cuda",
                placements=None, init_missing=None, verify: bool = False):
        """Rebuild a state shaped like ``like``.  A tensor leaf (on any
        device, ``meta`` included) comes back on ``device`` in its own
        dtype; an ``int`` leaf comes back as an ``int``.  ``placements``
        (a tree like ``like`` of ``NamedSharding``, from
        ``parallel.sharding.tree_shardings``) makes each tensor leaf a
        DTensor on its mesh's device instead: this rank's shard, cut from
        the whole array.  ``verify`` checks each file's sha256.  Missing
        leaves use ``init_missing(key, leaf)`` or raise ``KeyError``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        dev = resolve_device(device) if placements is None else None
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())["leaves"]

        values = {}
        for path, leaf in _leaves(like):
            key = _key(path)
            if key in manifest:
                m = manifest[key]
                raw = np.load(d / m["file"])
                if verify:
                    h = hashlib.sha256(raw).hexdigest()
                    if h != m["sha256"]:
                        raise IOError(f"checkpoint corruption in {key}")
                t = _tensor(raw, m["dtype"], m["shape"])
                if isinstance(leaf, int) and not isinstance(leaf, bool):
                    values[path] = int(t)
                    continue
                dtype = (leaf.dtype if isinstance(leaf, torch.Tensor)
                         else t.dtype)
                if placements is not None:
                    values[path] = _placed(t.to(dtype),
                                           _at(placements, path))
                else:
                    values[path] = t.to(dev, dtype)
            elif init_missing is not None:
                v = init_missing(key, leaf)
                if not isinstance(v, (int, torch.Tensor)):
                    a = np.asarray(v)
                    v = _tensor(np.ascontiguousarray(a).reshape(-1)
                                .view(np.uint8), str(a.dtype), a.shape)
                if isinstance(v, torch.Tensor):
                    v = (_placed(v.cpu(), _at(placements, path))
                         if placements is not None else v.to(dev))
                values[path] = v
            else:
                raise KeyError(
                    f"leaf {key} missing from checkpoint step {step}")
        return _rebuild(like, values)
