"""The port stands alone: importing every module of ``repro_torch`` (the
model stack's ``models/``, ``configs/``, ``train/`` with the training step
and optimizers, ``data/``, ``serving/`` and ``obs/`` included) and
registering its ifunc library loads neither jax nor the JAX package; nor
does driving the Dispatcher's host lanes from ``repro_torch.obs`` and
``repro_torch.transport`` alone, nor a task future from
``repro_torch.tasks`` alone.  The check runs in a
subprocess because this test process has jax loaded already
(``tests/conftest.py``)."""

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
print("STACK", all(m in mods for m in (
    "repro_torch.models.transformer", "repro_torch.models.ssm",
    "repro_torch.configs.smollm_360m", "repro_torch.configs.mamba2_780m",
    "repro_torch.train.serve", "repro_torch.serving.batcher",
    "repro_torch.kernels.flash_attn", "repro_torch.kernels.ssd_scan",
    "repro_torch.train.step", "repro_torch.train.optim",
    "repro_torch.data.pipeline", "repro_torch.obs.metrics",
    "repro_torch.obs.trace", "repro_torch.obs.recorder",
    "repro_torch.tasks.runtime", "repro_torch.tasks.future",
    "repro_torch.tasks.wire")))
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
    assert n >= 40, r.stdout
    assert "STACK True" in r.stdout, r.stdout


_PROBE_TRANSPORT = r"""
import sys
import repro_torch.obs, repro_torch.transport
from repro_torch.core import Context, register_ifunc
from repro_torch.obs import Obs
from repro_torch.transport import (Dispatcher, LoopbackFabric,
                                   ProgressEngine, RdmaFabric)
d = Dispatcher(Context("src"), ProgressEngine(), obs=Obs("probe", trace=True))
d.set_coalescing(True)
for name, fab in (("rdma", RdmaFabric()), ("loop", LoopbackFabric())):
    d.add_peer(name, fab, Context(name), target_args={"db": []})
h = register_ifunc(d.src_ctx, "rle_insert")
for name in d.peers:
    assert d.send_ifunc(name, h, b"probe")
d.drain()
assert [p.target_args["db"] for p in d.peers.values()] == [[b"probe"]] * 2
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(
                 ("jax.", "jaxlib.", "repro.")))
print("FORBIDDEN", bad, d.obs.snapshot()["counters"]["dispatcher.sent"])
"""


def test_obs_and_transport_import_alone():
    """``repro_torch.obs`` and ``repro_torch.transport`` on their own, a
    host-lane Dispatcher with tracing driven through them: neither jax nor
    the JAX package is loaded."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("REPRO_TORCH_IFUNC_LIB_DIR", None)
    r = subprocess.run([sys.executable, "-c", _PROBE_TRANSPORT], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "FORBIDDEN [] 2" in r.stdout, r.stdout


_PROBE_TASKS = r"""
import sys
import repro_torch.tasks
from repro_torch.core import Context, register_ifunc, submit
from repro_torch.tasks import TaskRuntime
from repro_torch.transport import ProgressEngine, RdmaFabric
rt = TaskRuntime(Context("src"), engine=ProgressEngine(
    inflight_window="trailer"), coalesce=True)
rt.add_peer("rdma", RdmaFabric(), Context("rdma"), target_args={})
h = register_ifunc(rt.ctx, "task_sum")
assert submit(rt, "rdma", h, b"\x01\x02").result() == 3
futs = rt.submit_many("rdma", h, [bytes([i]) for i in range(1, 9)])
assert [f.result() for f in futs] == list(range(1, 9))
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(
                 ("jax.", "jaxlib.", "repro.")))
print("FORBIDDEN", bad, rt.stats["resolved"],
      rt.dispatcher.peers["rdma"].stats["agg_replies"] > 0)
"""


def test_tasks_import_alone():
    """``repro_torch.tasks`` on its own: a future through ``core.submit``
    and a coalesced batch through ``submit_many`` resolve over the RDMA
    fabric's reply ring with the port's own ``task_sum``, and neither jax
    nor the JAX package is loaded."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("REPRO_TORCH_IFUNC_LIB_DIR", None)
    r = subprocess.run([sys.executable, "-c", _PROBE_TASKS], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "FORBIDDEN [] 9 True" in r.stdout, r.stdout


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
