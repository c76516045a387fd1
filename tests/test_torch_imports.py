"""The port stands alone: importing every module of ``repro_torch`` (the
model stack's ``models/`` with the MoE and RG-LRU blocks, ``configs/``, ``train/`` with the training step
and optimizers, ``data/``, ``serving/`` with the KV slab format, the host
server, the workers and the fabric, ``launch/serve`` and ``obs/``
included) and registering its ifunc library (the four ``graph_*`` verbs,
the five serving verbs and the streaming-aware ``stream_sink``,
``host_aggregate`` and ``kv_install`` included) loads
neither jax nor the JAX package; nor
does driving the Dispatcher's host lanes from ``repro_torch.obs`` and
``repro_torch.transport`` alone, nor a task future from
``repro_torch.tasks`` alone, nor a flow chain from ``repro_torch.flow``
alone, nor the runtime (``repro_torch.runtime``: a heartbeat death and
re-admission, a control verb, a checkpoint round trip) alone.  The check
runs in a
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
from repro_torch.tasks.placement import DataDirectory, PlacementEngine
verbs = {n: register_ifunc(Context("probe"), n) for n in (
    "graph_relax", "graph_fetch", "graph_count", "graph_degree",
    "stream_sink", "host_aggregate", "srv_enqueue", "srv_admit",
    "srv_prefill", "srv_complete", "kv_install")}
assert verbs["stream_sink"].lib.streaming
assert verbs["host_aggregate"].lib.streaming
assert verbs["kv_install"].lib.streaming
args = {"externals": {"A": np.eye(128, dtype=np.float32)}, "device": "cpu"}
verbs["graph_degree"].lib.main(np.ones((1, 128, 128), np.float32).tobytes(),
                               0, args)
assert float(args["result"].sum()) == 128 * 128
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(
                 ("jax.", "jaxlib.", "repro.")))
print("MODULES", len(mods))
print("STACK", all(m in mods for m in (
    "repro_torch.models.transformer", "repro_torch.models.ssm",
    "repro_torch.models.moe", "repro_torch.models.rglru",
    "repro_torch.configs.smollm_360m", "repro_torch.configs.mamba2_780m",
    "repro_torch.train.serve", "repro_torch.serving.batcher",
    "repro_torch.kernels.flash_attn", "repro_torch.kernels.ssd_scan",
    "repro_torch.train.step", "repro_torch.train.optim",
    "repro_torch.data.pipeline", "repro_torch.obs.metrics",
    "repro_torch.obs.trace", "repro_torch.obs.recorder",
    "repro_torch.tasks.runtime", "repro_torch.tasks.future",
    "repro_torch.tasks.wire", "repro_torch.tasks.placement",
    "repro_torch.tasks.graph", "repro_torch.transport.codec",
    "repro_torch.flow.descriptor", "repro_torch.flow.node",
    "repro_torch.flow.engine", "repro_torch.serving.kv",
    "repro_torch.serving.host", "repro_torch.serving.workers",
    "repro_torch.serving.fabric", "repro_torch.launch.serve")))
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


_PROBE_FLOW = r"""
import struct, sys
import numpy as np
import repro_torch.flow
from repro_torch.core import Context, register_ifunc
from repro_torch.flow import Flow, FlowEngine
from repro_torch.transport import LoopbackFabric, RdmaFabric
verbs = {n: register_ifunc(Context("probe"), n) for n in (
    "csd_decompress", "dpu_filter", "flow_reduce", "flow_xform")}
eng = FlowEngine(Context("host", device="cpu"), default_timeout=20.0)
eng.add_node("csd", LoopbackFabric())
eng.add_node("dpu", RdmaFabric())
eng.add_node("agg", RdmaFabric())
blob = struct.pack("<I", 1) + struct.pack("<II", 90, 3)
out = eng.submit(Flow("etl").stage("csd_decompress", at="csd")
                 .then("dpu_filter", at="dpu",
                       bind={"mode": "kw", "key": "data",
                             "static": {"threshold": 50}})
                 .then("host_aggregate", at="agg"), blob).result()
assert out == {"count": 3, "sum": 270, "min": 90, "max": 90}, out
assert eng.submit(Flow("x").stage("flow_xform", at="csd"),
                  b"abc").result() == b"cba"
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(
                 ("jax.", "jaxlib.", "repro.")))
print("FORBIDDEN", bad, sorted(verbs))
"""


def test_flow_imports_alone():
    """``repro_torch.flow`` on its own, with the port's four flow verbs
    (``csd_decompress``, ``dpu_filter``, ``flow_reduce``, ``flow_xform``):
    a three-stage chain and a one-stage chain resolve at ``device="cpu"``
    and neither jax nor the JAX package is loaded."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("REPRO_TORCH_IFUNC_LIB_DIR", None)
    r = subprocess.run([sys.executable, "-c", _PROBE_FLOW], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "FORBIDDEN [] ['csd_decompress', 'dpu_filter', 'flow_reduce', " \
        "'flow_xform']" in r.stdout, r.stdout


_PROBE_RUNTIME = r"""
import struct, sys, tempfile
import torch
import repro_torch.runtime as R
from repro_torch.core import Context, register_ifunc
from repro_torch.tasks import TaskRuntime
from repro_torch.transport import FaultInjector, RdmaFabric

rt = TaskRuntime(Context("src", device="cpu"))
ctxs = {n: Context(n, link_mode="remote", device="cpu") for n in "ab"}
fabs = {n: RdmaFabric() for n in "ab"}
for n in "ab":
    rt.add_peer(n, fabs[n], ctxs[n], n_slots=4, slot_size=16 << 10,
                target_args={})
inj = FaultInjector()
ec = R.ElasticController(rt, R.FleetState(["a", "b"], heartbeat_deadline=0.3),
                         injector=inj, auto_poll=False)
for n in "ab":
    ec.watch(n, fabs[n], ctxs[n], now=0.0)
h = register_ifunc(rt.ctx, "task_sum")
f = rt.submit("a", h, b"\x01\x02")
rt.flush()
while not f.done():
    rt.progress()
inj.kill_peer("a")
t, dead = 0.0, []
while not dead:
    t += 0.1
    dead = ec.step(now=t)
peer = ec.readmit("a", RdmaFabric(), Context("a", link_mode="remote",
                                              device="cpu"),
                  target_args={}, now=t, n_slots=4, slot_size=16 << 10)
agent = R.WorkerAgent("w0", Context("w0", device="cpu"))
ctl = R.PodController(Context("ctl", device="cpu"))
ctl.attach(agent)
ctl.inject("ctl_set_lr", struct.pack("<d", 0.5))
agent.poll()
with tempfile.TemporaryDirectory() as d:
    cm = R.CheckpointManager(d)
    cm.save(3, {"w": torch.ones(2, dtype=torch.bfloat16), "step": 3})
    back = cm.restore({"w": torch.empty(2, dtype=torch.bfloat16,
                                        device="meta"), "step": 0},
                      device="cpu", verify=True)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(
                 ("jax.", "jaxlib.", "repro.")))
print("RUNTIME", dead, ec.stats["deaths"], ec.stats["readmissions"],
      peer.fence > 0, agent.hooks["lr_scale"], back["step"],
      bool(back["w"].eq(1).all()))
print("FORBIDDEN", bad)
"""


def test_runtime_imports_alone():
    """``repro_torch.runtime`` on its own, with the port's ``hb_beat`` and
    ``ctl_set_lr``: a heartbeat death and re-admission, a hot LR update
    and a bf16 checkpoint round trip at ``device="cpu"``, and neither jax
    nor the JAX package is loaded."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("REPRO_TORCH_IFUNC_LIB_DIR", None)
    r = subprocess.run([sys.executable, "-c", _PROBE_RUNTIME], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "RUNTIME ['a'] 1 1 True 0.5 3 True" in r.stdout, r.stdout
    assert "FORBIDDEN []" in r.stdout, r.stdout


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


_PROBE_DRYRUN = r"""
import os, runpy, sys
import repro_torch.launch.dryrun
sys.argv = ["dryrun", "--arch", "smollm_360m", "--shape", "decode_32k",
            "--mesh", "both", "--out", sys.argv[1]]
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
except SystemExit as e:
    print("EXIT", e.code)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(
                 ("jax.", "jaxlib.", "repro.")))
print("FORBIDDEN", bad, "XLA_FLAGS" in os.environ)
"""


def test_dryrun_imports_and_runs_alone(tmp_path):
    """``repro_torch.launch.dryrun`` imported, and its command line run on
    both meshes of one cell, load neither jax nor the JAX package and set
    no ``XLA_FLAGS`` (the reference's module sets it when imported)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _PROBE_DRYRUN, str(tmp_path)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "EXIT 0" in r.stdout and "FORBIDDEN [] False" in r.stdout, \
        r.stdout + r.stderr
    assert "done: ok=2 skipped=0 failed=0" in r.stdout, r.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "smollm_360m__decode_32k__multipod.json",
        "smollm_360m__decode_32k__pod.json"]
