"""μVM interpreter — the device-tier ifunc executor.

Injected "code" arrives as data: a μVM program (``core.codegen.OPS``)
interpreted over 128x128 f32 payload tiles with 8 tile registers.  Every
tile runs the whole program (data-parallel μcode); ``loade`` reads the
external table, the device GOT of model-resident tensors bound at launch.

:func:`ifunc_vm` launches the CUDA kernel (``csrc/ifunc_vm.cu``) on CUDA
tensors and runs :func:`ifunc_vm_plain` on CPU tensors;
:func:`ifunc_vm_slots` does the same for tiles that lie in the slots of a
mailbox, which the kernel reads where they are.  The kernel runs a plan of
the program (:func:`vm_plan`, made once per program): its registers
renamed onto as few physical tiles as its live values need, its loads
served in place, and the variant that holds those tiles
(``ifunc_vm_smem_kernel`` for at most three, else
``ifunc_vm_global_kernel``).

:func:`ifunc_vm_sweep` and :func:`ifunc_vm_agg_sweep` are the mailbox
sweeps: the same interpreter behind a poll of the tile's slot, one launch
that polls every slot, runs the READY ones, masks the rest and clears
what was consumed in place (``ring_sweep_*_kernel``,
``agg_sweep_*_kernel``).

External tables come per shard, ``[n_shards, n_ext, T, T]``: tile ``t``
reads the table of shard ``t // (n_tiles // n_shards)``, the layout the
mailbox sweep launches with.  A single ``[n_ext, T, T]`` table serves every
tile; an empty one reads as one zero tile.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as TF

from repro_torch.core.codegen import N_OPS, OPS, UVM_REGS, UVM_TILE, UvmProgram
from repro_torch.kernels import _build
from repro_torch.kernels.agg_poll import SUB_READY, agg_ring_poll_plain
from repro_torch.kernels.ring_poll import (BAD, HDR_WORDS, READY,
                                           ring_poll_plain)

T = UVM_TILE
R = UVM_REGS
SMEM_TILES = 3             # physical tiles the shared-memory variant holds
PAYLOAD, EXT0 = 8, 16      # plan locations: 0..7 a tile, 8 the payload,
                           # 16 + j external j
_NAMES = {v: k for k, v in OPS.items()}
_BINARY = ("add", "sub", "mul", "matmul", "max")
_NO_READS = ("halt", "loadp", "loade", "zero")


def _check_program(prog: UvmProgram) -> None:
    """Reject what neither version can run: an unknown opcode or a register
    outside the file (the oracle raises on both)."""
    op = np.asarray(prog.opcode)
    if op.size and (op.min() < 0 or op.max() >= N_OPS):
        raise ValueError(f"μVM opcode out of range [0, {N_OPS})")
    for name in ("dst", "a", "b"):
        r = np.asarray(getattr(prog, name))
        if r.size and (r.min() < 0 or r.max() >= R):
            raise ValueError(f"μVM register operand {name!r} out of range "
                             f"[0, {R})")


def _tables(payload: torch.Tensor, externals: torch.Tensor,
            dtypes=(torch.float32,)) -> torch.Tensor:
    """Validate the operands; return the externals as [n_shards, n_ext, T, T]
    (an empty table becomes one zero tile, as in the reference)."""
    if payload.dtype not in dtypes or externals.dtype != payload.dtype:
        raise TypeError(f"ifunc_vm takes payload and externals of one dtype "
                        f"out of {dtypes}, got {payload.dtype} and "
                        f"{externals.dtype}")
    if payload.dim() != 3 or tuple(payload.shape[1:]) != (T, T):
        raise ValueError(f"payload must be [n_tiles, {T}, {T}], got "
                         f"{tuple(payload.shape)}")
    return _ext_tables(payload.shape[0], payload.device, externals)


def _ext_tables(n_tiles: int, device, externals: torch.Tensor
                ) -> torch.Tensor:
    if externals.device != device:
        raise ValueError(f"externals on {externals.device}, payload on "
                         f"{device}")
    ext = externals
    if ext.dim() == 3:
        ext = ext[None]
    if ext.dim() != 4 or tuple(ext.shape[2:]) != (T, T):
        raise ValueError(f"externals must be [n_ext, {T}, {T}] or "
                         f"[n_shards, n_ext, {T}, {T}], got "
                         f"{tuple(externals.shape)}")
    if ext.shape[1] == 0:
        ext = ext.new_zeros(ext.shape[0], 1, T, T)
    if ext.shape[0] == 0 or n_tiles % ext.shape[0]:
        raise ValueError(f"{n_tiles} tiles do not split evenly over "
                         f"{ext.shape[0]} shard tables")
    return ext


def _apply(op: str, va, vb, vd, imm: float) -> torch.Tensor:
    """The tile-valued result of one arithmetic opcode (every op but halt,
    store and the loads), over a batch of tiles."""
    if op == "add":
        return va + vb
    if op == "sub":
        return va - vb
    if op == "mul":
        return va * vb
    if op == "fma":
        return vd + va * vb
    if op == "relu":
        return torch.clamp_min(va, 0.0)
    if op == "gelu":
        return TF.gelu(va, approximate="tanh")
    if op == "exp":
        return torch.exp(va)
    if op in ("scale", "muli"):
        return va * imm
    if op == "matmul":
        return torch.matmul(va, vb)
    if op == "max":
        return torch.maximum(va, vb)
    if op == "copy":
        return va.clone()
    if op == "zero":
        return torch.zeros_like(va)
    if op == "tanh":
        return torch.tanh(va)
    if op == "rsqrt":
        return torch.rsqrt(va.abs() + 1e-12)
    return va + imm                                    # addi


def _shards(n: int, ext: torch.Tensor, device) -> torch.Tensor:
    return torch.arange(n, device=device) // max(n // ext.shape[0], 1)


def ifunc_vm_plain(prog: UvmProgram, payload: torch.Tensor,
                   externals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the program runs once over all tiles at once,
    register file ``[n_tiles, 8, T, T]``.  Besides float32 it takes float64
    operands, which measure how far float32 rounding alone moves a
    program's result."""
    _check_program(prog)
    ext = _tables(payload, externals, (torch.float32, torch.float64))
    n = payload.shape[0]
    shard = _shards(n, ext, payload.device)
    regs = payload.new_zeros(n, R, T, T)
    out = torch.zeros_like(payload)
    for pc in range(len(prog.opcode)):
        op = _NAMES[int(prog.opcode[pc])]
        d, a, b = int(prog.dst[pc]), int(prog.a[pc]), int(prog.b[pc])
        if op == "halt":
            continue
        if op == "store":
            out.copy_(regs[:, a])
            continue
        if op == "loadp":
            res = payload
        elif op == "loade":
            res = ext[shard, min(a, ext.shape[1] - 1)]
        else:
            res = _apply(op, regs[:, a], regs[:, b], regs[:, d],
                         float(prog.imm[pc]))
        regs[:, d] = res
    return out


@dataclass(frozen=True, eq=False)
class VmPlan:
    """What the kernel runs for one program (see :func:`vm_plan`).

    ``code`` is ``[5, n]`` int32: opcode, dst (a physical tile), a, b, c
    (locations: 0..7 a tile, ``PAYLOAD``, ``EXT0 + j``; c is fma's
    addend, the old value of its dst); ``imm`` ``[n]`` f32."""
    code: np.ndarray
    imm: np.ndarray
    n_tiles: int                          # physical tiles
    zeroed: tuple[int, ...]               # tiles zeroed before the first op
    served: tuple[tuple[int, int, str], ...]   # (pc, register, "payload"
                                               # or "ext j") read in place

    @property
    def variant(self) -> str:
        return "smem" if self.n_tiles <= SMEM_TILES else "global"

    @property
    def kernel(self) -> str:
        """The CUDA kernel that runs this plan."""
        return f"ifunc_vm_{self.variant}_kernel"


def _reads(op: str) -> tuple[str, ...]:
    """The operands an opcode reads ("d": fma's old destination)."""
    if op in _NO_READS:
        return ()
    if op == "fma":
        return ("a", "b", "d")
    return ("a", "b") if op in _BINARY else ("a",)


def vm_plan(prog: UvmProgram) -> VmPlan:
    """The plan of ``prog`` (cached per program): its values are tracked
    from definition to last read; only the last store and what it needs
    are kept; a value loaded by loadp or loade is served in place from the
    payload or the external table; every other value takes the lowest
    free physical tile (a tile freed by an operand that dies at an
    instruction may take that instruction's result: elementwise ops read
    and write each element in one thread, and the product writes after
    its last read); and registers read before any write get tiles zeroed
    at the start."""
    _check_program(prog)
    arrays = [np.ascontiguousarray(x, dt) for x, dt in (
        (prog.opcode, np.int32), (prog.dst, np.int32), (prog.a, np.int32),
        (prog.b, np.int32), (prog.imm, np.float32))]
    return _plan(b"".join(x.tobytes() for x in arrays))


@functools.lru_cache(maxsize=256)
def _plan(key: bytes) -> VmPlan:
    n = len(key) // 20
    op, dst, a, b = (np.frombuffer(key, np.int32, n, 4 * n * i)
                     for i in range(4))
    imm = np.frombuffer(key, np.float32, n, 16 * n)
    names = [_NAMES[int(o)] for o in op]
    operand = {"a": a, "b": b, "d": dst}
    # values: ("init", r) before any write to r, else the pc defining it
    cur = {r: ("init", r) for r in range(R)}
    srcs = []
    for pc, name in enumerate(names):
        srcs.append({role: cur[int(operand[role][pc])]
                     for role in _reads(name)})
        if name not in ("halt", "store"):
            cur[int(dst[pc])] = pc
    stores = [pc for pc, name in enumerate(names) if name == "store"]
    live, needed = [], set()
    if stores:
        live.append(stores[-1])
        needed.add(srcs[stores[-1]]["a"])
        for pc in range(stores[-1] - 1, -1, -1):
            if pc in needed:
                live.append(pc)
                needed.update(srcs[pc].values())
    live.reverse()
    last_read = {}
    for pc in live:
        for v in srcs[pc].values():
            last_read[v] = pc

    loc, free, peak = {}, list(range(R)), 0

    def take() -> int:
        nonlocal peak
        p = free.pop(0)
        peak = max(peak, p + 1)
        return p

    zeroed = tuple(loc.setdefault(("init", r), take()) for r in range(R)
                   if ("init", r) in needed)
    served = []
    for pc in live:
        if names[pc] in ("loadp", "loade"):
            loc[pc] = PAYLOAD if names[pc] == "loadp" else EXT0 + int(a[pc])
            served.append((pc, int(dst[pc]), "payload" if names[pc] == "loadp"
                           else f"ext {int(a[pc])}"))
    rows = []
    for pc in live:
        name, s = names[pc], srcs[pc]
        for v in set(s.values()):             # operands that die here
            if last_read[v] == pc and loc[v] < PAYLOAD:
                free.append(loc[v])
                free.sort()
        if name in ("loadp", "loade"):
            continue
        d = 0 if name == "store" else loc.setdefault(pc, take())
        rows.append((OPS[name], d, *(loc[s[r]] if r in s else 0
                                     for r in ("a", "b", "d")),
                     float(imm[pc])))
    code = np.array([r[:5] for r in rows], np.int32).reshape(-1, 5).T
    return VmPlan(np.ascontiguousarray(code),
                  np.array([r[5] for r in rows], np.float32), peak, zeroed,
                  tuple(served))


def ifunc_vm_planned_plain(plan: VmPlan, payload: torch.Tensor,
                           externals: torch.Tensor) -> torch.Tensor:
    """The plan's instructions run in plain PyTorch, as the kernel runs
    them: its physical tiles, its locations, its one store.  Tiles not
    zeroed by the plan start as NaN, so a plan that reads a tile before
    writing it shows."""
    ext = _tables(payload, externals, (torch.float32, torch.float64))
    n = payload.shape[0]
    shard = _shards(n, ext, payload.device)
    tiles = payload.new_full((n, plan.n_tiles, T, T), float("nan"))
    tiles[:, list(plan.zeroed)] = 0
    out = torch.zeros_like(payload)

    def at(where: int) -> torch.Tensor:
        if where < PAYLOAD:
            return tiles[:, where]
        if where == PAYLOAD:
            return payload
        return ext[shard, min(where - EXT0, ext.shape[1] - 1)]

    for (op, d, a, b, c), imm in zip(plan.code.T.tolist(), plan.imm.tolist()):
        if _NAMES[op] == "store":
            out.copy_(at(a))
        else:
            tiles[:, d] = _apply(_NAMES[op], at(a), at(b), at(c), imm)
    return out


def slot_tiles(slots: torch.Tensor, body_offset: int,
               tiles_per_slot: int) -> torch.Tensor:
    """The f32 tiles ``[n_slots * tiles_per_slot, T, T]`` that lie
    ``body_offset`` words into each row of ``slots`` (``[n_slots, W]``,
    int32 or float32 words), copied out: what :func:`ifunc_vm_slots`
    reads in place."""
    body = slots[:, body_offset:body_offset + tiles_per_slot * T * T]
    return body.contiguous().view(torch.float32).reshape(-1, T, T)


def _prepare(prog: UvmProgram, device, n_tiles: int, ext: torch.Tensor):
    """The plan of ``prog`` with its code and immediates on ``device`` and,
    for the global variant, a scratch for ``n_tiles`` tiles."""
    if ext.dtype != torch.float32 or not ext.is_contiguous():
        raise ValueError("ifunc_vm needs contiguous float32 externals")
    plan = vm_plan(prog)
    code, imm = _device_code(plan, device)
    scratch = None
    if plan.variant == "global":
        scratch = torch.empty(n_tiles, plan.n_tiles, T, T,
                              dtype=torch.float32, device=device)
    return plan, code, imm, scratch


def _launch(prog: UvmProgram, base: torch.Tensor, n_tiles: int,
            slot_stride: int, body_offset: int, tiles_per_slot: int,
            ext: torch.Tensor) -> torch.Tensor:
    """Runs the plan of ``prog`` over the tiles at ``base`` (see
    csrc/ifunc_vm.cu for the layout) with the tables ``ext`` from
    :func:`_ext_tables` -> ``[n_tiles, T, T]`` f32."""
    plan, code, imm, scratch = _prepare(prog, base.device, n_tiles, ext)
    out = torch.empty(n_tiles, T, T, dtype=torch.float32, device=base.device)
    fn = _build.load("ifunc_vm").ifunc_vm_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_uint, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(code.data_ptr(), imm.data_ptr(), code.shape[1], plan.n_tiles,
             sum(1 << p for p in plan.zeroed), int(plan.variant == "smem"),
             base.data_ptr(), n_tiles, slot_stride, body_offset,
             tiles_per_slot, ext.data_ptr(), ext.shape[1],
             max(n_tiles // ext.shape[0], 1),
             0 if scratch is None else scratch.data_ptr(), out.data_ptr(),
             _build.stream_ptr(base.device))
    if err:
        raise RuntimeError(f"{plan.kernel} launch failed: cudaError {err}")
    ifunc_vm.launches += 1
    return out


@functools.lru_cache(maxsize=256)
def _device_code(plan: VmPlan, device: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(plan.code).to(device),
            torch.from_numpy(plan.imm.copy()).to(device))


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")
    return True


def ifunc_vm(prog: UvmProgram, payload: torch.Tensor,
             externals: torch.Tensor) -> torch.Tensor:
    """Execute μcode over payload tiles ``[n_tiles, T, T]`` f32 with the
    external table(s) ``externals``; returns ``[n_tiles, T, T]`` f32.
    Launches the CUDA kernel for CUDA tensors; CPU tensors take the plain
    version."""
    if not _on_cuda(payload, "ifunc_vm"):
        return ifunc_vm_plain(prog, payload, externals)
    ext = _tables(payload, externals)
    if not payload.is_contiguous():
        raise ValueError("ifunc_vm needs a contiguous payload")
    return _launch(prog, payload, payload.shape[0], T * T, 0, 1, ext)


ifunc_vm.launches = 0      # kernel launches since the count was last reset


def ifunc_vm_slots(prog: UvmProgram, slots: torch.Tensor, body_offset: int,
                   tiles_per_slot: int, externals: torch.Tensor
                   ) -> torch.Tensor:
    """:func:`ifunc_vm` over the tiles :func:`slot_tiles` gives, read by
    the kernel where they lie in ``slots`` (``[n_slots, W]`` int32 or
    float32 words, each row one slot, rows at any stride); returns
    ``[n_slots * tiles_per_slot, T, T]`` f32.  CPU tensors take the plain
    version on the copied tiles.  Launches count on ``ifunc_vm``."""
    if slots.dim() != 2 or slots.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"slots must be [n_slots, W] int32 or float32, got "
                        f"{tuple(slots.shape)} {slots.dtype}")
    if tiles_per_slot < 1 or body_offset < 0 or \
            body_offset + tiles_per_slot * T * T > slots.shape[1]:
        raise ValueError(f"{tiles_per_slot} tiles at word {body_offset} do "
                         f"not fit a {slots.shape[1]}-word slot")
    if not _on_cuda(slots, "ifunc_vm_slots"):
        return ifunc_vm_plain(prog, slot_tiles(slots, body_offset,
                                               tiles_per_slot), externals)
    if slots.stride(1) != 1:
        raise ValueError("ifunc_vm_slots needs each slot's words contiguous")
    n = slots.shape[0] * tiles_per_slot
    return _launch(prog, slots, n, slots.stride(0), body_offset,
                   tiles_per_slot, _ext_tables(n, slots.device, externals))


# -- the fused mailbox sweeps ------------------------------------------------

def _check_sweep(slots: torch.Tensor, body_offset: int, tiles_per_slot: int,
                 agg_k: int) -> None:
    if not isinstance(slots, torch.Tensor) or slots.dtype != torch.int32 \
            or slots.dim() != 2:
        raise TypeError("slots must be an int32 [n_slots, W] tensor, got "
                        f"{getattr(slots, 'dtype', type(slots).__name__)} "
                        f"{tuple(getattr(slots, 'shape', ()))}")
    if agg_k < 0 or tiles_per_slot < 1 or (agg_k and tiles_per_slot % agg_k):
        raise ValueError(f"{tiles_per_slot} tiles a slot do not split over "
                         f"agg_k={agg_k} sub-records")
    hdr = HDR_WORDS + 2 * agg_k
    if body_offset < hdr or \
            body_offset + tiles_per_slot * T * T > slots.shape[1]:
        raise ValueError(f"{tiles_per_slot} tiles at word {body_offset} do "
                         f"not fit a {slots.shape[1]}-word slot behind its "
                         f"{hdr} header words")


def ifunc_vm_sweep_plain(prog: UvmProgram, slots: torch.Tensor,
                         body_offset: int, tiles_per_slot: int,
                         externals: torch.Tensor, *, agg_k: int = 0,
                         bound_hash: int = 0):
    """Plain version of one mailbox sweep over ``slots`` (``[n_slots, W]``
    int32, each row a slot): the poll (``ring_poll_plain``, or
    ``agg_ring_poll_plain`` for containers of ``agg_k`` sub-records), the
    program over every body tile copied out (``ifunc_vm_plain`` on
    :func:`slot_tiles`), outputs of slots (sub-records) that are not READY
    set to +0.0, and READY and BAD slots cleared **in place** in
    ``slots``.  Returns ``(status, out)``, or ``(status, sub, out)`` for
    containers, with ``out`` ``[n_slots * tiles_per_slot, T, T]``."""
    _check_sweep(slots, body_offset, tiles_per_slot, agg_k)
    if agg_k:
        status, sub = agg_ring_poll_plain(
            slots[:, :HDR_WORDS + 2 * agg_k], slots[:, -1:], bound_hash)
        keep = (sub == SUB_READY).reshape(-1)
    else:
        status = ring_poll_plain(slots)
        keep = status == READY
    keep = keep.repeat_interleave(tiles_per_slot // max(agg_k, 1))
    out = ifunc_vm_plain(prog, slot_tiles(slots, body_offset, tiles_per_slot),
                         externals)
    out = torch.where(keep[:, None, None], out, 0.0)
    slots.masked_fill_(((status == READY) | (status == BAD))[:, None], 0)
    return (status, sub, out) if agg_k else (status, out)


# per device, the per-slot counters by which a sweep's blocks elect the
# slot's last one; zero between sweeps (the last block resets its slot's).
# Sweeps on one device share them, so they run on one stream.
_COUNTERS: dict[torch.device, torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


def _sweep_launch(prog: UvmProgram, slots: torch.Tensor, body_offset: int,
                  tiles_per_slot: int, externals: torch.Tensor, agg_k: int,
                  bound_hash: int):
    """One launch of ``ring_sweep_*_kernel`` (agg_k = 0) or
    ``agg_sweep_*_kernel`` over the CUDA mailbox ``slots``."""
    if slots.stride(1) != 1 or slots.stride(0) != slots.shape[1]:
        raise ValueError("a sweep needs a contiguous [n_slots, W] mailbox")
    n, dev = slots.shape[0], slots.device
    n_tiles = n * tiles_per_slot
    ext = _ext_tables(n_tiles, dev, externals)
    plan, code, imm, scratch = _prepare(prog, dev, n_tiles, ext)
    status = torch.empty(n, dtype=torch.int32, device=dev)
    sub = torch.empty(n, agg_k, dtype=torch.int32, device=dev) if agg_k \
        else None
    out = torch.empty(n_tiles, T, T, dtype=torch.float32, device=dev)
    fn = _build.load("ifunc_vm").ifunc_vm_sweep_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_uint, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(code.data_ptr(), imm.data_ptr(), code.shape[1], plan.n_tiles,
             sum(1 << p for p in plan.zeroed), int(plan.variant == "smem"),
             slots.data_ptr(), n, slots.shape[1], body_offset,
             tiles_per_slot, agg_k, int(bound_hash) & 0xFFFFFFFF,
             ext.data_ptr(), ext.shape[1], max(n_tiles // ext.shape[0], 1),
             0 if scratch is None else scratch.data_ptr(), status.data_ptr(),
             0 if sub is None else sub.data_ptr(),
             _counters(dev, n).data_ptr(), out.data_ptr(),
             _build.stream_ptr(dev))
    if err:
        raise RuntimeError(f"{sweep_kernel(prog, agg_k)} launch failed: "
                           f"cudaError {err}")
    return (status, sub, out) if agg_k else (status, out)


def sweep_kernel(prog: UvmProgram, agg_k: int = 0) -> str:
    """The CUDA kernel one sweep of ``prog`` launches."""
    return (f"{'agg' if agg_k else 'ring'}_sweep_{vm_plan(prog).variant}"
            f"_kernel")


def ifunc_vm_sweep(prog: UvmProgram, slots: torch.Tensor, body_offset: int,
                   tiles_per_slot: int, externals: torch.Tensor):
    """One sweep of a singleton mailbox ``slots`` (``[n_slots, W]`` int32,
    a contiguous view of the mailbox) -> ``(status [n_slots], out
    [n_slots * tiles_per_slot, T, T])``: every slot polled as
    ``ring_poll`` polls it, the plan of ``prog`` run on the body tiles of
    READY slots where they lie (as :func:`ifunc_vm_slots` runs it), +0.0
    written over every other output tile, and READY and BAD slots cleared
    **in place** in ``slots``; INFLIGHT and EMPTY slots are not written.
    On CUDA tensors one launch (``ring_sweep_smem_kernel`` or
    ``ring_sweep_global_kernel``) does all of it; CPU tensors take
    :func:`ifunc_vm_sweep_plain`."""
    _check_sweep(slots, body_offset, tiles_per_slot, 0)
    if not _on_cuda(slots, "ifunc_vm_sweep"):
        return ifunc_vm_sweep_plain(prog, slots, body_offset, tiles_per_slot,
                                    externals)
    res = _sweep_launch(prog, slots, body_offset, tiles_per_slot, externals,
                        0, 0)
    ifunc_vm_sweep.launches += 1
    return res


ifunc_vm_sweep.launches = 0  # kernel launches since the count was last reset


def ifunc_vm_agg_sweep(prog: UvmProgram, slots: torch.Tensor, agg_k: int,
                       body_offset: int, tiles_per_slot: int,
                       externals: torch.Tensor, bound_hash: int = 0):
    """:func:`ifunc_vm_sweep` for aggregate containers of ``agg_k``
    sub-records, ``tiles_per_slot // agg_k`` tiles each, against the
    bound program hash (0: any) -> ``(status [n_slots], sub [n_slots,
    agg_k], out [n_slots * tiles_per_slot, T, T])``, polled as
    ``agg_ring_poll`` polls them; a sub-record runs when it is SUB_READY.
    On CUDA tensors one launch (``agg_sweep_smem_kernel`` or
    ``agg_sweep_global_kernel``); CPU tensors take
    :func:`ifunc_vm_sweep_plain`."""
    if agg_k < 1:
        raise ValueError(f"agg_k must be at least 1, got {agg_k}")
    _check_sweep(slots, body_offset, tiles_per_slot, agg_k)
    if not _on_cuda(slots, "ifunc_vm_agg_sweep"):
        return ifunc_vm_sweep_plain(prog, slots, body_offset, tiles_per_slot,
                                    externals, agg_k=agg_k,
                                    bound_hash=bound_hash)
    res = _sweep_launch(prog, slots, body_offset, tiles_per_slot, externals,
                        agg_k, bound_hash)
    ifunc_vm_agg_sweep.launches += 1
    return res


ifunc_vm_agg_sweep.launches = 0  # kernel launches since the count was reset
