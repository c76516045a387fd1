"""μVM interpreter — the device-tier ifunc executor.

Injected "code" arrives as data: a μVM program (``core.codegen.OPS``)
interpreted over 128x128 f32 payload tiles with 8 tile registers.  Every
tile runs the whole program (data-parallel μcode); ``loade`` reads the
external table, the device GOT of model-resident tensors bound at launch.

:func:`ifunc_vm` launches the CUDA kernel (``csrc/ifunc_vm.cu``) on CUDA
tensors and runs :func:`ifunc_vm_plain` on CPU tensors.

External tables come per shard, ``[n_shards, n_ext, T, T]``: tile ``t``
reads the table of shard ``t // (n_tiles // n_shards)``, the layout the
mailbox sweep launches with.  A single ``[n_ext, T, T]`` table serves every
tile; an empty one reads as one zero tile.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as TF

from repro_torch.core.codegen import N_OPS, OPS, UVM_REGS, UVM_TILE, UvmProgram
from repro_torch.kernels import _build

T = UVM_TILE
R = UVM_REGS


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
    if externals.device != payload.device:
        raise ValueError(f"externals on {externals.device}, payload on "
                         f"{payload.device}")
    ext = externals
    if ext.dim() == 3:
        ext = ext[None]
    if ext.dim() != 4 or tuple(ext.shape[2:]) != (T, T):
        raise ValueError(f"externals must be [n_ext, {T}, {T}] or "
                         f"[n_shards, n_ext, {T}, {T}], got "
                         f"{tuple(externals.shape)}")
    if ext.shape[1] == 0:
        ext = ext.new_zeros(ext.shape[0], 1, T, T)
    if ext.shape[0] == 0 or payload.shape[0] % ext.shape[0]:
        raise ValueError(f"{payload.shape[0]} tiles do not split evenly over "
                         f"{ext.shape[0]} shard tables")
    return ext


def ifunc_vm_plain(prog: UvmProgram, payload: torch.Tensor,
                   externals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the program runs once over all tiles at once,
    register file ``[n_tiles, 8, T, T]``.  Besides float32 it takes float64
    operands, which measure how far float32 rounding alone moves a
    program's result."""
    _check_program(prog)
    ext = _tables(payload, externals, (torch.float32, torch.float64))
    n = payload.shape[0]
    per_shard = max(n // ext.shape[0], 1)
    shard = torch.arange(n, device=payload.device) // per_shard
    n_ext = ext.shape[1]
    regs = payload.new_zeros(n, R, T, T)
    out = torch.zeros_like(payload)
    inv = {v: k for k, v in OPS.items()}
    for pc in range(len(prog.opcode)):
        op = inv[int(prog.opcode[pc])]
        d, a, b = int(prog.dst[pc]), int(prog.a[pc]), int(prog.b[pc])
        imm = float(prog.imm[pc])
        va, vb, vd = regs[:, a], regs[:, b], regs[:, d]
        if op == "halt":
            continue
        elif op == "store":
            out.copy_(va)
            continue
        elif op == "loadp":
            res = payload
        elif op == "loade":
            res = ext[shard, min(a, n_ext - 1)]
        elif op == "add":
            res = va + vb
        elif op == "sub":
            res = va - vb
        elif op == "mul":
            res = va * vb
        elif op == "fma":
            res = vd + va * vb
        elif op == "relu":
            res = torch.clamp_min(va, 0.0)
        elif op == "gelu":
            res = TF.gelu(va, approximate="tanh")
        elif op == "exp":
            res = torch.exp(va)
        elif op in ("scale", "muli"):
            res = va * imm
        elif op == "matmul":
            res = torch.matmul(va, vb)
        elif op == "max":
            res = torch.maximum(va, vb)
        elif op == "copy":
            res = va.clone()
        elif op == "zero":
            res = torch.zeros_like(va)
        elif op == "tanh":
            res = torch.tanh(va)
        elif op == "rsqrt":
            res = torch.rsqrt(va.abs() + 1e-12)
        else:  # addi
            res = va + imm
        regs[:, d] = res
    return out


def _program_tensors(prog: UvmProgram, device) -> tuple[torch.Tensor,
                                                         torch.Tensor]:
    code = np.stack([prog.opcode, prog.dst, prog.a, prog.b]).astype(np.int32)
    imm = np.asarray(prog.imm, np.float32)
    return (torch.from_numpy(code).to(device),
            torch.from_numpy(imm.copy()).to(device))


def ifunc_vm(prog: UvmProgram, payload: torch.Tensor,
             externals: torch.Tensor) -> torch.Tensor:
    """Execute μcode over payload tiles ``[n_tiles, T, T]`` f32 with the
    external table(s) ``externals``; returns ``[n_tiles, T, T]`` f32.
    Launches the CUDA kernel for CUDA tensors; CPU tensors take the plain
    version."""
    if payload.device.type == "cpu":
        return ifunc_vm_plain(prog, payload, externals)
    if payload.device.type != "cuda":
        raise ValueError(f"ifunc_vm runs on cuda or cpu, not {payload.device}")
    _check_program(prog)
    ext = _tables(payload, externals)
    if not (payload.is_contiguous() and ext.is_contiguous()):
        raise ValueError("ifunc_vm needs a contiguous payload and externals")
    n = payload.shape[0]
    code, imm = _program_tensors(prog, payload.device)
    regs = torch.empty(n, R, T, T, dtype=torch.float32, device=payload.device)
    out = torch.empty_like(payload)
    fn = _build.load("ifunc_vm").ifunc_vm_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(code.data_ptr(), imm.data_ptr(), code.shape[1],
             payload.data_ptr(), n, ext.data_ptr(), ext.shape[1],
             max(n // ext.shape[0], 1), regs.data_ptr(), out.data_ptr(),
             _build.stream_ptr(payload.device))
    if err:
        raise RuntimeError(f"ifunc_vm kernel launch failed: cudaError {err}")
    ifunc_vm.launches += 1
    return out


ifunc_vm.launches = 0      # kernel launches since the count was last reset
