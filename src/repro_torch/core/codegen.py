"""Code-section serialization and linking — the GOT-patching analogue.

Three code kinds travel inside ifunc frames:

* **PYBC** — marshalled CPython bytecode of the ifunc main function plus a
  *symbol table*: the function's global references, shipped by name.  The
  target re-links them against its local :class:`SymbolSpace` — the
  paper's GOT indirection.  Unresolvable names raise :class:`LinkError`.
  Like the real Two-Chains (same-ISA requirement), PYBC requires matching
  interpreter magic; it is shipped and checked.  The section is byte for
  byte ``repro.core.codegen``'s for the same function of the same file
  (``co_filename`` is part of the marshalled code).

* **HLO** — a ``torch.export`` program, saved to bytes.  Self-contained
  dataflow (empty GOT); the target loads it, moves it to its device and
  runs its module there.  Bytes
  ``torch.export.load`` cannot read (a ``jax.export`` artifact among
  them) raise :class:`LinkError`.

* **UVM** — a μVM program: data interpreted by the fixed ``ifunc_vm``
  kernel (``repro_torch/kernels/ifunc_vm.py``).  Its external-table
  operands (``loade``) are late-bound symbol indices: the device-tier
  GOT.  The opcode numbering, the assembler and the wire serialization are
  those of ``repro.core.codegen``, so a program serialized by either
  package deserializes in the other to the same arrays.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import importlib.util
import io
import json
import marshal
import struct
import types
from dataclasses import dataclass, field

import numpy as np


class LinkError(Exception):
    """A shipped symbol cannot be resolved in the target's symbol space."""


class CodeVerifyError(Exception):
    """Code section failed integrity/authentication checks."""


_PY_MAGIC = importlib.util.MAGIC_NUMBER.hex()

_SAFE_BUILTINS = {
    k: getattr(__builtins__, k) if not isinstance(__builtins__, dict)
    else __builtins__[k]
    for k in ("len", "range", "min", "max", "sum", "abs", "int", "float",
              "bool", "bytes", "bytearray", "memoryview", "zip", "enumerate",
              "print", "isinstance", "tuple", "list", "dict", "set",
              "sorted", "ValueError", "RuntimeError", "Exception", "map",
              "filter", "repr", "str", "divmod")
}


def _default_resident_libs() -> dict:
    """Stdlib modules every target hosts — the libc/libm of this world.
    Shipped code may reference them by name without shipping them."""
    import base64
    import binascii
    import collections
    import hashlib
    import itertools
    import json as _json
    import math
    import struct as _struct
    import time as _time

    return {"struct": _struct, "math": math, "json": _json, "time": _time,
            "hashlib": hashlib, "base64": base64, "binascii": binascii,
            "collections": collections, "itertools": itertools}


class SymbolSpace:
    """Target-process symbol registry (the 'libraries resident on the host').

    ``poll_ifunc`` links shipped code against this — the GOT construction.
    Standard resident libraries (struct/math/json/...) are pre-provided,
    like libc on a real host; pass ``resident_libs=False`` for a bare space."""

    def __init__(self, symbols: dict | None = None, *,
                 resident_libs: bool = True):
        self._syms: dict[str, object] = (
            dict(_default_resident_libs()) if resident_libs else {})
        self._syms.update(symbols or {})

    def provide(self, name: str, obj: object) -> None:
        self._syms[name] = obj

    def provide_module(self, mod, names=None) -> None:
        for n in (names or [n for n in dir(mod) if not n.startswith("_")]):
            self._syms[n] = getattr(mod, n)

    def resolve(self, name: str):
        if name not in self._syms:
            raise LinkError(f"unresolved symbol {name!r} on target")
        return self._syms[name]

    def __contains__(self, name):
        return name in self._syms


# ---------------------------------------------------------------------------
# PYBC


def _code_globals(code: types.CodeType) -> set[str]:
    """Names the code actually loads from globals (its GOT), found via the
    bytecode — co_names alone would also include attribute/method names."""
    import dis

    names = {i.argval for i in dis.get_instructions(code)
             if i.opname in ("LOAD_GLOBAL", "LOAD_NAME")}
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            names |= _code_globals(c)
    return names


_CONST_TYPES = (int, float, str, bytes, bool, type(None), tuple)


class _Missing:
    pass


_MISSING = _Missing()


def serialize_pybc(fn: types.FunctionType, *,
                   hmac_key: bytes | None = None) -> bytes:
    """Package a function like the Two-Chains toolchain packages a library's
    ``.text``: the main's bytecode PLUS any module-local helper functions it
    references (statically bundled, like same-.so symbols), module-level
    constants inlined, and everything else listed in the *symbol table* for
    target-side GOT linking."""
    if fn.__closure__:
        raise ValueError("ifunc main must be closure-free (ship state via "
                         "payload)")
    mod_globals = fn.__globals__
    mod_name = mod_globals.get("__name__")

    locals_: dict[str, types.CodeType] = {}
    consts: dict[str, object] = {}
    symbols: set[str] = set()
    defaults: dict[str, object] = {}

    def visit(f: types.FunctionType):
        if f.__defaults__:
            defaults[f.__name__] = f.__defaults__
        for name in sorted(_code_globals(f.__code__) - set(_SAFE_BUILTINS)):
            if name in locals_ or name in consts or name in symbols:
                continue
            val = mod_globals.get(name, _MISSING)
            if (isinstance(val, types.FunctionType)
                    and val.__module__ == mod_name and not val.__closure__):
                locals_[name] = val.__code__   # static bundle (same-.so)
                visit(val)
            elif isinstance(val, _CONST_TYPES) and not isinstance(val, tuple):
                consts[name] = val             # .rodata
            else:
                symbols.add(name)              # dynamic symbol -> GOT

    visit(fn)
    bundle = {"main": fn.__code__, "locals": locals_, "consts": consts,
              "defaults": defaults, "name": fn.__name__}
    body = marshal.dumps(bundle)
    meta = {"symbols": sorted(symbols), "magic": _PY_MAGIC}
    if hmac_key is not None:
        meta["hmac"] = _hmac.new(hmac_key, body, hashlib.sha256).hexdigest()
    mb = json.dumps(meta).encode()
    return struct.pack("<I", len(mb)) + mb + body


def link_pybc(code: bytes, space: SymbolSpace, *,
              hmac_key: bytes | None = None) -> types.FunctionType:
    """Target-side GOT construction: rebuild the code unit with its global
    table patched to local symbol addresses."""
    code = bytes(code)  # accept zero-copy frame section views
    (n,) = struct.unpack_from("<I", code, 0)
    meta = json.loads(code[4:4 + n].decode())
    body = code[4 + n:]
    if meta["magic"] != _PY_MAGIC:
        raise CodeVerifyError(
            f"interpreter mismatch (code {meta['magic']}, local {_PY_MAGIC}) "
            "— same-ISA requirement, like Two-Chains")
    if hmac_key is not None:
        want = meta.get("hmac")
        have = _hmac.new(hmac_key, body, hashlib.sha256).hexdigest()
        if not (want and _hmac.compare_digest(want, have)):
            raise CodeVerifyError("code section HMAC mismatch")
    bundle = marshal.loads(body)
    got = {"__builtins__": _SAFE_BUILTINS}
    got.update(bundle["consts"])
    for s in meta["symbols"]:
        got[s] = space.resolve(s)          # <- the GOT patch
    for lname, lcode in bundle["locals"].items():
        lf = types.FunctionType(lcode, got, lname)
        if lname in bundle["defaults"]:
            lf.__defaults__ = bundle["defaults"][lname]
        got[lname] = lf                    # shared table: mutual refs work
    fn = types.FunctionType(bundle["main"], got, bundle["name"])
    if bundle["name"] in bundle["defaults"]:
        fn.__defaults__ = bundle["defaults"][bundle["name"]]
    return fn


# ---------------------------------------------------------------------------
# HLO (torch.export)


def serialize_hlo(fn, example_args: tuple) -> bytes:
    """Export ``fn`` (a function or an ``nn.Module``) traced on the tensors
    ``example_args`` and save the program to bytes."""
    import torch

    mod = fn if isinstance(fn, torch.nn.Module) else _exported(fn)
    buf = io.BytesIO()
    torch.export.save(torch.export.export(mod, tuple(example_args)), buf)
    return buf.getvalue()


def link_hlo(code: bytes, device=None):
    """The callable module of a saved ``torch.export`` program, moved to
    ``device`` when one is given (a program traced on CPU tensors asserts
    their device, so it is rewritten to the target's).  Bytes that are
    not one raise :class:`LinkError`."""
    import torch
    from torch.export.passes import move_to_device_pass

    try:
        prog = torch.export.load(io.BytesIO(bytes(code)))
        if device is not None:
            prog = move_to_device_pass(prog, device)
        return prog.module()
    except Exception as e:
        raise LinkError(f"HLO code section is not a torch.export program: "
                        f"{type(e).__name__}: {e}") from e


def _exported(fn):
    import torch

    class Exported(torch.nn.Module):
        def forward(self, *args):
            return fn(*args)

    return Exported()


# ---------------------------------------------------------------------------
# UVM μcode (device tier) — ISA shared with kernels/ifunc_vm.py

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
