"""ifunc library loading (paper §3.1).

An *ifunc library* is a Python module ``<name>.py`` defining the three
routines of paper Listing 1.2:

    <name>_main(payload: memoryview, payload_size: int, target_args) -> None
    <name>_payload_get_max_size(source_args, source_args_size) -> int
    <name>_payload_init(payload: memoryview, payload_size,
                        source_args, source_args_size) -> int   # used bytes

plus ``IFUNC_KIND = "uvm"`` and ``UVM_PROGRAM`` (an assembled
:class:`~repro_torch.core.codegen.UvmProgram`) for a device-tier ifunc.

Libraries are searched in ``$REPRO_TORCH_IFUNC_LIB_DIR`` when it is set,
else in this package's own ``ifunc_libs/``.  The variable is not the JAX
package's ``REPRO_IFUNC_LIB_DIR``: those libraries import the JAX package.
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
    """A loaded ifunc library (source side: all three routines)."""

    name: str
    main: object
    payload_get_max_size: object
    payload_init: object
    kind: CodeKind
    code: bytes            # serialized code section
    code_digest: bytes     # truncated sha256, hashed ONCE here

    @property
    def code_hash(self) -> str:
        return self.code_digest.hex()

    @classmethod
    def load(cls, name: str,
             search_dir: pathlib.Path | None = None) -> "IfuncLibrary":
        mod = _load_module(name, search_dir)
        try:
            main = getattr(mod, f"{name}_main")
            gms = getattr(mod, f"{name}_payload_get_max_size")
            init = getattr(mod, f"{name}_payload_init")
        except AttributeError as e:
            raise RegistryError(
                f"library {name!r} missing required routine: {e}") from e
        kind = getattr(mod, "IFUNC_KIND", "pybc")
        if kind != "uvm":
            raise RegistryError(
                f"library {name!r}: code kind {kind!r} is not ported yet "
                "(only 'uvm')")
        code = CG.serialize_uvm(getattr(mod, "UVM_PROGRAM"))
        return cls(name, main, gms, init, CodeKind.UVM, code,
                   compute_digest(code))
