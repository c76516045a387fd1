"""The μVM ISA: device-tier code sections.

A CUDA target, like the TPU before it, runs no shipped machine code: the
injected "code" is a μVM program — data — interpreted by the fixed
``ifunc_vm`` kernel (``repro_torch/kernels/ifunc_vm.py``).  Its
external-table operands (``loade``) are late-bound symbol indices: the
device-tier GOT.

The opcode numbering, the assembler and the wire serialization are those of
``repro.core.codegen``, so a program serialized by either package
deserializes in the other to the same arrays.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field

import numpy as np


class CodeVerifyError(Exception):
    """Code section failed integrity checks."""


UVM_TILE = 128            # μVM register tile: (128, 128) f32

OPS = {
    "halt": 0, "loadp": 1, "loade": 2, "store": 3,
    "add": 4, "sub": 5, "mul": 6, "fma": 7,
    "relu": 8, "gelu": 9, "exp": 10, "scale": 11,
    "matmul": 12, "max": 13, "copy": 14, "zero": 15,
    "tanh": 16, "rsqrt": 17, "addi": 18, "muli": 19,
}
N_OPS = 20
UVM_REGS = 8

_UVM_MAGIC = 0x75564D31  # "uVM1"


@dataclass
class UvmProgram:
    opcode: np.ndarray   # [P] int32
    dst: np.ndarray      # [P] int32
    a: np.ndarray        # [P] int32
    b: np.ndarray        # [P] int32
    imm: np.ndarray      # [P] float32
    n_ext: int = 0       # external-table slots referenced (device GOT size)
    symbols: tuple[str, ...] = field(default=())  # names for ext slots


def assemble(instrs: list[tuple], symbols: tuple[str, ...] = ()) -> UvmProgram:
    """instrs: [(op, dst, a, b, imm), ...] with trailing args optional."""
    P = len(instrs)
    arr = np.zeros((5, P), np.float64)
    for i, ins in enumerate(instrs):
        op, *rest = ins
        rest = list(rest) + [0] * (4 - len(rest))
        arr[0, i] = OPS[op]
        arr[1:4, i] = rest[:3]
        arr[4, i] = rest[3]
    n_ext = int(max([arr[2, i] + 1 for i in range(P)
                     if arr[0, i] == OPS["loade"]] or [0]))
    return UvmProgram(arr[0].astype(np.int32), arr[1].astype(np.int32),
                      arr[2].astype(np.int32), arr[3].astype(np.int32),
                      arr[4].astype(np.float32), n_ext, tuple(symbols))


def serialize_uvm(prog: UvmProgram) -> bytes:
    sym = json.dumps(list(prog.symbols)).encode()
    head = struct.pack("<IIII", _UVM_MAGIC, len(prog.opcode), prog.n_ext,
                       len(sym))
    return (head + sym + prog.opcode.tobytes() + prog.dst.tobytes()
            + prog.a.tobytes() + prog.b.tobytes() + prog.imm.tobytes())


def deserialize_uvm(code) -> UvmProgram:
    code = bytes(code)  # accept zero-copy frame section views
    if len(code) < 16:
        raise CodeVerifyError("uvm code section shorter than its header")
    magic, P, n_ext, ns = struct.unpack_from("<IIII", code, 0)
    if magic != _UVM_MAGIC:
        raise CodeVerifyError("bad uvm magic")
    off = 16
    if len(code) != off + ns + 5 * 4 * P:
        raise CodeVerifyError("uvm code section length mismatch")
    symbols = tuple(json.loads(code[off:off + ns].decode()))
    off += ns
    arrs = []
    for dt in (np.int32, np.int32, np.int32, np.int32, np.float32):
        arrs.append(np.frombuffer(code, dt, P, off).copy())
        off += P * 4
    return UvmProgram(*arrs, n_ext=n_ext, symbols=symbols)
