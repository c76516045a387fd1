"""The sharded step's collectives over NCCL, on four cards of one host:
``parallel.sharding.reduce_scatter`` through ``reduce_scatter_tensor``
(the route a CUDA tensor takes over NCCL; gloo's all-reduce route is
``tests/test_torch_parallel.py``'s), and two sharded launcher steps of
every ``test_torch_parallel.step_cases(4)`` case against two world-size-1
steps on the same card.  Marked ``cuda``; skips with fewer than four
cards.  The file imports nothing of the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_nccl.py

Each rank is this file run as a script (``--backend gloo --device cpu``
runs the same ranks on the CPU).
"""

from __future__ import annotations

import argparse
import datetime
import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_parallel as TP  # noqa: E402

WORLD = 4


def _rank_checks(rank, device, out):
    """This rank's results: the reduce-scatter of ``TP.rs_inputs`` along
    each dimension over a (4,) mesh (and whether it took the native
    route), and the whole state and losses of two sharded steps of each
    case."""
    from repro_torch.launch import train as LT
    from repro_torch.parallel import sharding as SH
    from repro_torch.train.step import make_train_step, train_state_specs

    res = {"rank": rank}
    mesh = SH.make_mesh((WORLD,), ("pod",), device=device.type)
    x = TP.rs_inputs(WORLD)[rank].to(device)
    group = mesh.get_group("pod")
    res["native"] = SH.native_reduce_scatter(x, group)
    res["reduce_scatter"] = {d: SH.reduce_scatter(x, group, d).cpu()
                             for d in range(x.dim())}
    inp = TP.make_inputs(out / f"inputs{rank}.npz")
    for arch, mname, variant in TP.step_cases(WORLD):
        cfg, opt, mb, rules, bkey = TP.step_setup(arch, mname, variant,
                                                  WORLD)
        mesh = SH.make_mesh(TP.GRAD_MESHES[WORLD][mname][0],
                            ("data", "model"), device=device.type)
        step = make_train_step(cfg, opt, microbatches=mb, donate=True)
        shapes, axes = train_state_specs(cfg, opt)
        whole = _to(LT.init_state(cfg, step, "cpu"), device)
        with SH.sharding_context(mesh, rules):
            idx, n = LT.batch_shard(mesh)
            state_sh = SH.tree_shardings(axes, shapes, mesh)
            state = LT.place(whole, state_sh)
            jstep = LT.make_sharded_step(step, mesh, state_sh)
        del whole
        losses = []
        for i in range(2):
            batch = TP.local_rows(TP.grad_batch(inp, i, bkey), idx, n)
            state, m = jstep(state, batch)
            losses.append(float(m["loss"]))
        res[f"steps/{arch}/{mname}/{variant}"] = {
            "losses": losses, "step": state["step"],
            **{k: v.cpu() for k, v in TP.state_wholes(state).items()}}
    torch.save(res, out / f"rank{rank}.pt")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _rank_main(argv=None):
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    for a in ("--world", "--rank"):
        ap.add_argument(a, type=int)
    for a in ("--store", "--out"):
        ap.add_argument(a)
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    device = torch.device(a.device, a.rank) if a.device == "cuda" \
        else torch.device(a.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    dist.init_process_group(
        a.backend, store=dist.FileStore(a.store, a.world), rank=a.rank,
        world_size=a.world,
        timeout=datetime.timedelta(seconds=TP.GROUP_TIMEOUT_S))
    try:
        _rank_checks(a.rank, device, pathlib.Path(a.out))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA devices")
    return TP.spawn(WORLD, pathlib.Path(__file__),
                    tmp_path_factory.mktemp("nccl"))


@pytest.mark.cuda
def test_reduce_scatter_over_nccl(ranks):
    """Over NCCL a CUDA tensor takes ``reduce_scatter_tensor``, and each
    rank receives its block of the sum along every dimension."""
    total = TP.rs_inputs(WORLD).sum(0)
    for rank, r in enumerate(ranks):
        assert r["native"]
        for d, block in r["reduce_scatter"].items():
            w = total.shape[d] // WORLD
            torch.testing.assert_close(block, total.narrow(d, rank * w, w),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mesh,variant", TP.step_cases(WORLD))
def test_two_sharded_steps_over_nccl(ranks, tmp_path, arch, mesh, variant):
    """``test_torch_parallel.test_two_sharded_steps`` at 4 ranks over
    NCCL, one card a rank, against two world-size-1 steps on the first
    card: losses, parameters and moments within ``TP.TOL_GRAD``."""
    from repro_torch.launch import train as LT
    from repro_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    inp = TP.make_inputs(tmp_path / "inputs.npz")
    cfg, opt, mb, _, bkey = TP.step_setup(arch, mesh, variant, WORLD)
    step = make_train_step(cfg, opt, microbatches=mb)
    state = _to(LT.init_state(cfg, step, "cpu"), torch.device("cuda", 0))
    losses = []
    for i in range(2):
        state, m = step(state, TP.grad_batch(inp, i, bkey))
        losses.append(float(m["loss"]))
    want = {k: v.cpu() for k, v in TP.state_wholes(state).items()}
    for r in ranks:
        got = r[f"steps/{arch}/{mesh}/{variant}"]
        assert got["step"] == 2
        for a, b in zip(got["losses"], losses):
            assert abs(a - b) <= TP.TOL_GRAD * abs(b)
        for k, v in want.items():
            assert TP.rel_l2(got[k], v) < TP.TOL_GRAD, (k, TP.rel_l2(got[k],
                                                                     v))


if __name__ == "__main__":
    _rank_main()
