"""The port stands alone: importing every module of ``repro_torch`` and
registering its ifunc library loads neither jax nor the JAX package.  The
check runs in a subprocess because this test process has jax loaded
already (``tests/conftest.py``)."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import numpy as np
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
from repro_torch.core import Context, ifunc_msg_create, register_ifunc
h = register_ifunc(Context("probe"), "uvm_affine")
ifunc_msg_create(h, np.zeros((1, 128, 128), np.float32))
args = {"externals": {"W": np.eye(128, dtype=np.float32)}, "device": "cpu"}
h.lib.main(np.ones((1, 128, 128), np.float32).tobytes(), 0, args)
assert float(args["result"].sum()) == 128 * 128
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(
                 ("jax.", "jaxlib.", "repro.")))
print("MODULES", len(mods))
print("FORBIDDEN", bad)
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("REPRO_TORCH_IFUNC_LIB_DIR", None)
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "FORBIDDEN []" in r.stdout, r.stdout
    n = int(re.search(r"MODULES (\d+)", r.stdout).group(1))
    assert n >= 16, r.stdout


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?![\w])",
                     re.M)


def test_static_scan_finds_no_reference_imports():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in _IMPORT.finditer(f.read_text())]
    assert hits == []


def test_no_torch_or_triton_shadow_under_root_or_tests():
    for d in (REPO, REPO / "tests"):
        for name in ("torch", "triton", "torch.py", "triton.py"):
            assert not (d / name).exists(), d / name
