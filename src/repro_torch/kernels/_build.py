"""Build the CUDA sources under ``src/repro_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``; ``csrc/*.cuh`` are headers the sources share.  All sources
build together — one ``nvcc`` process each, started at once — on the
first :func:`load` call, into ``build/repro_torch/<hash>/`` at the
repository root, where ``<hash>`` covers the sources, the headers and
the flags, so an edited file rebuilds and an unchanged tree loads at
once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"   # where the toolkit installs it
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}   # loaded libraries, by source stem


class BuildError(RuntimeError):
    pass


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists(CUDA_NVCC):
        nvcc = CUDA_NVCC
    if nvcc is None:
        raise BuildError("nvcc not found: the CUDA kernels build only on a "
                         "machine with the CUDA toolkit")
    return nvcc


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> tuple[pathlib.Path, float]:
    """Compile every source whose library is missing, all in parallel.
    Returns (build directory, seconds spent).  The compiler's report
    (``-Xptxas -v``: registers, shared memory, spills) lands beside each
    library as ``<name>.log``."""
    out = build_dir()
    todo = [s for s in sources() if not (out / f"lib{s.stem}.so").exists()]
    t0 = time.perf_counter()
    if not todo:
        return out, 0.0
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.{os.getpid()}.tmp.so"
        p = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append((src, tmp, p))
    failed = []
    for src, tmp, p in procs:
        log, _ = p.communicate()
        (out / f"{src.stem}.log").write_text(log)
        if p.returncode != 0:
            failed.append(f"--- nvcc {src.name} (exit {p.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out / f"lib{src.stem}.so")
    if failed:
        raise BuildError("\n".join(failed))
    return out, time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building all
    sources first if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        out, _ = build_all()
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        _LIBS[name] = lib
    return lib


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
