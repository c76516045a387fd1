"""ifunc library loading (paper §3.1).

An *ifunc library* is a Python module ``<name>.py`` defining the three
routines of paper Listing 1.2:

    <name>_main(payload: memoryview, payload_size: int, target_args) -> None
    <name>_payload_get_max_size(source_args, source_args_size) -> int
    <name>_payload_init(payload: memoryview, payload_size,
                        source_args, source_args_size) -> int   # used bytes

Optionally: ``IFUNC_KIND = "pybc" | "hlo" | "uvm"`` (default pybc),
``HLO_ARG_SPECS`` (for hlo: example tensors, since ``torch.export``
traces on inputs), ``UVM_PROGRAM`` (an assembled
:class:`~repro_torch.core.codegen.UvmProgram`), ``IFUNC_STREAM = True``
(the main is streaming-aware).

Libraries are searched in ``$REPRO_TORCH_IFUNC_LIB_DIR`` when it is set,
else in this package's own ``ifunc_libs/``.  The variable is not the JAX
package's ``REPRO_IFUNC_LIB_DIR``: some of those libraries import the JAX
package.  A jax-free library of that directory (``rle_insert``,
``counter_bump``) loads here through ``search_dir`` and gives the same
PYBC section as under the reference's registry.
"""

from __future__ import annotations

import importlib.util
import os
import pathlib
from dataclasses import dataclass

from repro_torch.core import codegen as CG
from repro_torch.core.frame import CodeKind, compute_digest

ENV_LIB_DIR = "REPRO_TORCH_IFUNC_LIB_DIR"


class RegistryError(Exception):
    pass


def lib_dir() -> pathlib.Path:
    d = os.environ.get(ENV_LIB_DIR)
    if d:
        return pathlib.Path(d)
    return pathlib.Path(__file__).resolve().parents[1] / "ifunc_libs"


def _load_module(name: str, search_dir: pathlib.Path | None = None):
    d = search_dir or lib_dir()
    path = d / f"{name}.py"
    if not path.exists():
        raise RegistryError(f"ifunc library {name!r} not found in {d}")
    spec = importlib.util.spec_from_file_location(
        f"_repro_torch_ifunc_lib_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class IfuncLibrary:
    """A loaded ifunc library (source side: all three routines; target side
    the main is what matters)."""

    name: str
    main: object
    payload_get_max_size: object
    payload_init: object
    kind: CodeKind
    code: bytes            # serialized code section
    code_digest: bytes     # truncated sha256, hashed ONCE here; travels in
    #                        every frame header (never rehashed per message)
    streaming: bool = False   # IFUNC_STREAM: main executes per chunk on a
    #                           streamed frame (exec-on-arrival opt-in)

    @property
    def code_hash(self) -> str:
        return self.code_digest.hex()

    @classmethod
    def load(cls, name: str, search_dir: pathlib.Path | None = None,
             hmac_key: bytes | None = None) -> "IfuncLibrary":
        mod = _load_module(name, search_dir)
        try:
            main = getattr(mod, f"{name}_main")
            gms = getattr(mod, f"{name}_payload_get_max_size")
            init = getattr(mod, f"{name}_payload_init")
        except AttributeError as e:
            raise RegistryError(
                f"library {name!r} missing required routine: {e}") from e
        kind = {"pybc": CodeKind.PYBC, "hlo": CodeKind.HLO,
                "uvm": CodeKind.UVM}[getattr(mod, "IFUNC_KIND", "pybc")]
        if kind == CodeKind.PYBC:
            code = CG.serialize_pybc(main, hmac_key=hmac_key)
        elif kind == CodeKind.HLO:
            code = CG.serialize_hlo(main, getattr(mod, "HLO_ARG_SPECS"))
        else:
            code = CG.serialize_uvm(getattr(mod, "UVM_PROGRAM"))
        return cls(name, main, gms, init, kind, code, compute_digest(code),
                   streaming=bool(getattr(mod, "IFUNC_STREAM", False)))


class LinkCache:
    """Target-side hash table (paper §3.4): (name, code digest) -> linked
    entry, so only the *first* arrival of an ifunc pays the link cost.
    Keyed additionally by digest — the paper lets code change under the
    same name.  The digest key is the 16-byte value from the frame header,
    so a cache hit never hashes anything.

    SLIM frames resolve exclusively through this table; an eviction (or a
    target restart) makes them miss, which surfaces as ``NACK_UNCACHED``
    and drives the source back to a FULL retransmit.

    ``capacity`` bounds the table with LRU eviction (None = unbounded).
    ``stats()`` surfaces hit/miss/eviction counts so churn is observable."""

    def __init__(self, capacity: int | None = None,
                 entries: dict | None = None):
        if capacity is not None and capacity < 1:
            raise RegistryError(f"LinkCache capacity must be >= 1 or None, "
                                f"got {capacity}")
        self.capacity = capacity
        self.entries: dict[tuple[str, bytes], object] = dict(entries or {})
        self.link_events = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def lookup(self, name: str, digest: bytes):
        fn = self.entries.get((name, digest))
        if fn is None:
            self.misses += 1
            return None
        self.hits += 1
        if self.capacity is not None:           # LRU touch (dicts are ordered)
            key = (name, digest)
            self.entries[key] = self.entries.pop(key)
        return fn

    def insert(self, name: str, digest: bytes, fn) -> None:
        self.entries[(name, digest)] = fn
        self.link_events += 1
        if self.capacity is not None:
            while len(self.entries) > self.capacity:
                self.entries.pop(next(iter(self.entries)))
                self.evictions += 1

    def evict(self, name: str, digest: bytes) -> bool:
        """Drop one entry (cache-pressure / restart simulation)."""
        if self.entries.pop((name, digest), None) is None:
            return False
        self.evictions += 1
        return True

    def invalidate(self, name: str) -> None:
        for k in [k for k in self.entries if k[0] == name]:
            del self.entries[k]
            self.evictions += 1

    def stats(self) -> dict:
        return {"size": len(self.entries), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "links": self.link_events}
