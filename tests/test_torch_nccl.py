"""The sharded step's collectives over NCCL, on four cards of one host:
``parallel.sharding.reduce_scatter`` through ``reduce_scatter_tensor``
(the route a CUDA tensor takes over NCCL; gloo's all-reduce route is
``tests/test_torch_parallel.py``'s), two sharded launcher steps of every
``test_torch_parallel.step_cases(4)`` case against two world-size-1
steps on the same card (on the ``model`` and ``resident`` meshes the
products split over ``model``: tensor parallelism), and one sharded
step's loss and gradients at published width (``PUBLISHED``:
InternLM2-1.8B at 4 layers, RecurrentGemma-2B and Mamba-2 780M at one
super-block each, their RG-LRU and SSD blocks split too, and MiniCPM-2B
at one layer, in f32 on a (1, 4) mesh, every product split over the four
cards, in padded tiles where 4 does not divide it: RecurrentGemma-2B's
10 heads as 3, 3, 3, 1, MiniCPM-2B's 122,753 words as 30,689 on three
cards and 30,686 on the fourth) against world size 1 on the first card,
and sharded serving on the same mesh (``SERVE``: a reduced Qwen3-30B-A3B
and the same four at published width; prefill, then decode on the
cache's blocks of the slots and the recurrent states' blocks) against
world size 1 there.  Marked
``cuda``; skips with fewer than four cards.  The file imports nothing of
the JAX package:

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
import test_torch_sharded_serve as SS  # noqa: E402

WORLD = 4
# the published-width cases: arch -> (layers, mesh, batch, sequence); f32,
# TF32 off, attention through the flash kernels' f32 route, the SSD
# through its xla form (ssd_scan has no backward); RecurrentGemma-2B and
# Mamba-2 at one super-block (RG-LRU, RG-LRU, local attention; one SSD
# layer)
PUBLISHED = {"internlm2_1_8b": (4, (1, 4), 2, 2048),
             "recurrentgemma_2b": (3, (1, 4), 2, 2048),
             "mamba2_780m": (1, (1, 4), 2, 2048),
             "minicpm_2b": (1, (1, 4), 2, 2048)}
RECURRENT = ("recurrentgemma_2b", "mamba2_780m")
# the published-width cases under dp_fsdp whose batch model does not
# divide: arch -> (layers, mesh, batch, sequence), as PUBLISHED; each rank
# of the (1, 4) mesh runs its padded tile of the 2 rows (1, 1, and two
# empty ranks), the weights gathered whole
PUBLISHED_ROWS = {"recurrentgemma_2b": (3, (1, 4), 2, 2048)}
DP_FSDP = TP.DP_FSDP
# relative L2 of the loss and of each gradient against world size 1
# (measured on four H100s: the loss equal, the worst gradient 8.0e-6)
TOL_PUBLISHED = 1e-4
# sharded serving on a (1, 4) mesh under baseline (test_torch_sharded_serve's
# prefill and decodes): name -> (arch, layers (None: the reduced config),
# relative L2 against world size 1); f32, TF32 off
SERVE = {"qwen3_reduced": ("qwen3", None, TP.TOL_GRAD),
         "internlm2_published": ("internlm2_1_8b", 4, TOL_PUBLISHED),
         "recurrentgemma_published": ("recurrentgemma_2b", 3, TOL_PUBLISHED),
         "mamba2_published": ("mamba2_780m", 1, TOL_PUBLISHED),
         "minicpm_published": ("minicpm_2b", 1, TOL_PUBLISHED)}


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
        cfg, opt, mb, rules, bkey, rows = TP.step_setup(arch, mname, variant,
                                                        WORLD)
        mesh = SH.make_mesh(TP.GRAD_MESHES[WORLD][mname][0],
                            ("data", "model"), device=device.type)
        step = make_train_step(cfg, opt, microbatches=mb, donate=True)
        shapes, axes = train_state_specs(cfg, opt)
        whole = _to(LT.init_state(cfg, step, "cpu"), device)
        with SH.sharding_context(mesh, rules):
            idx, n = TP.spec_shard(mesh, rows)
            state_sh = SH.tree_shardings(axes, shapes, mesh)
            state = LT.place(whole, state_sh)
            jstep = LT.make_sharded_step(step, mesh, state_sh, rows=rows)
        del whole
        losses = []
        for i in range(2):
            batch = TP.local_rows(TP.step_batch(inp, i, bkey, rows), idx, n)
            state, m = jstep(state, batch)
            losses.append(float(m["loss"]))
        res[f"steps/{arch}/{mname}/{variant}"] = {
            "losses": losses, "step": state["step"],
            **{k: v.cpu() for k, v in TP.state_wholes(state).items()}}
    torch.save(res, out / f"rank{rank}.pt")


def published_setup(arch, rows=False):
    """``PUBLISHED[arch]``'s (``rows``: ``PUBLISHED_ROWS[arch]``'s)
    config, step and batch (tokens from a seed)."""
    import numpy as np

    from repro_torch import configs as C
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    layers, _, B, S = (PUBLISHED_ROWS if rows else PUBLISHED)[arch]
    cfg = C.get_config(arch).with_(num_layers=layers, dtype="float32",
                                   param_dtype="float32", attn_impl="flash",
                                   ssd_impl="xla")
    step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1,
                                          total_steps=10))
    t = torch.from_numpy(np.random.default_rng(36).integers(
        0, cfg.vocab_size, (B, S + 1))).long()
    return cfg, step, {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _published_check(rank, device, out):
    """Each ``PUBLISHED`` case's gradients (:func:`_published_case`)."""
    res = {"rank": rank}
    for arch in PUBLISHED:
        res[arch] = _published_case(arch, rank, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for arch in PUBLISHED_ROWS:
        res[f"{arch}/rows"] = _published_case(arch, rank, device, rows=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    torch.save(res, out / f"rank{rank}.pt")


def _published_case(arch, rank, device, rows=False):
    """``PUBLISHED[arch]``'s gradients (``rows``: ``PUBLISHED_ROWS[arch]``'s
    under ``dp_fsdp``, the rank on its tile of the rows): each rank's
    blocks through the sharded step's pieces (its shards as
    ``ShardedLeaf``, the gathers keeping ``model`` where it splits a
    product), assembled whole; rank 0 then takes world size 1's on its
    own card and keeps the loss's and each gradient's relative L2 against
    it."""
    from repro_torch.launch import train as LT
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as SH

    cfg, step, batch = published_setup(arch, rows)
    layers, shape, B, _ = (PUBLISHED_ROWS if rows else PUBLISHED)[arch]
    mesh = SH.make_mesh(shape, ("data", "model"), device=device.type)
    rules = SH.DEFAULT_RULES.override(**DP_FSDP) if rows \
        else SH.DEFAULT_RULES
    params = _to(T.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                 device)
    batch = _to(batch, device)
    with SH.sharding_context(mesh, rules):
        idx, n = TP.spec_shard(mesh, B)
        shs = SH.tree_shardings(T.param_axes(cfg), T.param_shapes(cfg), mesh)
        ops = SH.MeshOps(mesh)
        leaves = {k: SH.ShardedLeaf(SH.distribute(v, shs[k]).to_local(),
                                    shs[k], ops, key=k)
                  for k, v in params.items()}
        split = SS.split_keys(leaves, cfg)
        tile = SH.row_group(ops, B)
        loss, _, grads = step.grads(leaves, TP.local_rows(batch, idx, n),
                                    split=tile)
    del leaves
    loss = float(LT._mean_over_ranks(loss))
    whole = {k: SH.from_local(g, shs[k]).full_tensor() for k, g in
             grads.items()}
    del grads
    res = {"split": split, "loss": loss,
           "tile": None if tile is None else tile.block(B // n)}
    if rank == 0:
        want_loss, _, want = step.grads(params, batch)
        res["want_loss"] = float(want_loss)
        res["rel_l2"] = {k: TP.rel_l2(whole[k], want[k]) for k in want}
    return res


def serve_setup(name, device):
    """``SERVE[name]``'s config, whole parameters on ``device`` (seed 0),
    prompt, decode tokens and decode start caches (its own prefill's,
    padded; numpy).  InternLM2-1.8B at published width attends through
    the flash kernels (their f32 route on the card)."""
    import numpy as np

    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.train import serve as SRV

    arch, layers, _ = SERVE[name]
    if layers is None:
        cfg = SS.port_cfg(arch)
    else:
        cfg = C.get_config(arch).with_(num_layers=layers, dtype="float32",
                                       param_dtype="float32",
                                       attn_impl="flash")
    params = _to(T.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                 device)
    rng = np.random.default_rng(37)
    prompt = rng.integers(0, cfg.vocab_size, (SS.B, SS.S)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size,
                        (SS.B, len(SS.WAVE_POS))).astype(np.int32)
    with torch.inference_mode():
        cache, _ = SRV.make_prefill_step(cfg)(
            params, {"tokens": torch.from_numpy(prompt)})
    return cfg, params, prompt, toks, SS.decode_caches(cfg, cache)


def _serve_check(rank, device, out):
    """``SERVE``'s sharded prefill and decodes on this rank of a (1, 4)
    mesh, each result on the host."""
    from repro_torch.parallel import sharding as SH

    mesh = SH.make_mesh((1, WORLD), ("data", "model"), device=device.type)
    res = {"rank": rank, "coord": tuple(mesh.get_coordinate())}
    for name in SERVE:
        cfg, params, prompt, toks, start = serve_setup(name, device)
        with torch.inference_mode():
            got = SS.sharded_serve(cfg, mesh, SH.DEFAULT_RULES, params,
                                   prompt, toks, start)
        res[name] = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                     for k, v in got.items()}
        del params
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
    ap.add_argument("--published", action="store_true")
    ap.add_argument("--serve", action="store_true")
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
        if a.published:
            _published_check(a.rank, device, pathlib.Path(a.out))
        elif a.serve:
            _serve_check(a.rank, device, pathlib.Path(a.out))
        else:
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
    card: losses, parameters and moments within ``TP.TOL_GRAD``.  The
    row-split cases run ``dp_fsdp``'s batch over ``model`` in padded
    tiles: on (1, 4) 2 rows, two ranks with none (the reduced Qwen3's
    expert-parallel ``all_to_all`` then exchanges bins with ranks that
    send no token).  The microbatch cases split 4 rows over ``data``'s 2
    ranks in 2 microbatches with labels IGNORE unevenly: each rank's
    microbatch i is its block of the global slice i (world size 1's:
    ``TP.world1_step``)."""
    from repro_torch.launch import train as LT

    torch.backends.cuda.matmul.allow_tf32 = False
    inp = TP.make_inputs(tmp_path / "inputs.npz")
    cfg, opt, mb, _, bkey, rows = TP.step_setup(arch, mesh, variant, WORLD)
    step = TP.world1_step(cfg, opt, mb, variant,
                          TP.GRAD_MESHES[WORLD][mesh][0])
    state = _to(LT.init_state(cfg, step, "cpu"), torch.device("cuda", 0))
    losses = []
    for i in range(2):
        state, m = step(state, TP.step_batch(inp, i, bkey, rows))
        losses.append(float(m["loss"]))
    if variant == "mb2_ignore_moe":
        assert sum(step.drops) > 0, step.drops
    want = {k: v.cpu() for k, v in TP.state_wholes(state).items()}
    for r in ranks:
        got = r[f"steps/{arch}/{mesh}/{variant}"]
        assert got["step"] == 2
        for a, b in zip(got["losses"], losses):
            assert abs(a - b) <= TP.TOL_GRAD * abs(b)
        for k, v in want.items():
            assert TP.rel_l2(got[k], v) < TP.TOL_GRAD, (k, TP.rel_l2(got[k],
                                                                     v))


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    if torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA devices")
    return TP.spawn(WORLD, pathlib.Path(__file__),
                    tmp_path_factory.mktemp("published"), "--published")


def _check_published(published, arch, split):
    """``arch``'s loss and every gradient against world size 1's, and
    the leaves ``split`` among those every rank splits."""
    r0 = published[0][arch]
    assert split <= set(r0["split"]), r0["split"]
    for r in published:
        assert r[arch]["split"] == r0["split"] and r[arch]["loss"] == \
            r0["loss"]
    assert abs(r0["loss"] - r0["want_loss"]) <= \
        TOL_PUBLISHED * abs(r0["want_loss"])
    worst = max(r0["rel_l2"].items(), key=lambda kv: kv[1])
    print(f"{arch}: loss {r0['loss']!r} against {r0['want_loss']!r}; worst "
          f"gradient relative L2 {worst[1]:.3e} ({worst[0]})")
    assert worst[1] < TOL_PUBLISHED, worst


@pytest.mark.cuda
def test_tp_step_at_published_width_over_nccl(published):
    """InternLM2-1.8B at published width (4 of its 24 layers, f32, TF32
    off) on a (1, 4) mesh over NCCL: every rank splits attention's 16
    heads and 8 KV heads, the MLP's 8,192 hidden units and the 92,544
    words of the head over the four cards, and its loss and every
    gradient, landed in the blocks and gathered whole, equal world size
    1's on the first card within ``TOL_PUBLISHED`` relative L2."""
    _check_published(published, "internlm2_1_8b",
                     {"s0_wq", "s0_wk", "s0_wo", "s0_w_up", "s0_w_down",
                      "lm_head"})


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT)
def test_tp_recurrent_blocks_at_published_width_over_nccl(published, arch):
    """RecurrentGemma-2B (RG-LRU, RG-LRU, local attention) and Mamba-2
    780M (one SSD layer) at published width, f32, on a (1, 4) mesh over
    NCCL: every rank splits the RG-LRU's 2,560 channels (its gates'
    columns, the output's rows) or the SSD's 48 heads and their 3,072
    channels over the four cards, beside the MLPs and the head (and
    RecurrentGemma-2B's local attention's 10 heads in padded tiles of 3,
    3, 3 and 1), and the loss and every gradient equal world size 1's on
    the first card within ``TOL_PUBLISHED`` relative L2."""
    from repro_torch.models import rglru as R
    from repro_torch.models import ssm as SM

    own = R.TP_WEIGHTS if arch == "recurrentgemma_2b" else SM.TP_WEIGHTS
    attn = {"s2_wq", "s2_wo"} if arch == "recurrentgemma_2b" else set()
    _check_published(published, arch,
                     {f"s0_{k}" for k in own} | {"tok_embed"} | attn)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(PUBLISHED_ROWS))
def test_row_split_at_published_width_over_nccl(published, arch):
    """RecurrentGemma-2B at one super-block of published width (RG-LRU,
    RG-LRU, local attention; f32) under ``dp_fsdp`` on a (1, 4) mesh over
    NCCL, 2 rows: each rank runs its padded tile of them (1, 1, and two
    ranks with none, which still run every gather and reduce-scatter of
    the step), no product split; the loss and every gradient equal world
    size 1's on the first card within ``TOL_PUBLISHED`` relative L2."""
    case = f"{arch}/rows"
    assert [r[case]["tile"] for r in published] == [(0, 1), (1, 1), (2, 0),
                                                      (2, 0)]
    assert not published[0][case]["split"]
    _check_published(published, case, set())


@pytest.mark.cuda
def test_tp_padded_vocabulary_at_published_width_over_nccl(published):
    """MiniCPM-2B at one layer of published width, f32, on a (1, 4) mesh
    over NCCL: its 36 heads and 5,760 hidden units split over the four
    cards, and its tied head's 122,753 words, which 4 does not divide,
    in padded tiles (30,689 words on three cards, 30,686 on the fourth);
    the loss and every gradient equal world size 1's on the first card
    within ``TOL_PUBLISHED`` relative L2."""
    _check_published(published, "minicpm_2b",
                     {"s0_wq", "s0_wo", "s0_w_up", "s0_w_down", "tok_embed"})


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    if torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA devices")
    return TP.spawn(WORLD, pathlib.Path(__file__),
                    tmp_path_factory.mktemp("served"), "--serve")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SERVE))
def test_sharded_serving_over_nccl(served, name):
    """``test_torch_sharded_serve``'s sharded prefill and decodes (six wave
    steps, four per-slot, writing into every rank's block of the slots)
    on a (1, 4) mesh over NCCL, one card a rank: the reduced Qwen3-30B-A3B
    (its MoE's expert-parallel paths, KV heads cut) and InternLM2-1.8B at
    4 layers of published width (16 heads and 8 KV heads, 8,192 hidden
    units and 92,544 words split over the four cards; flash in the
    prefill), RecurrentGemma-2B and Mamba-2 at one super-block and
    MiniCPM-2B at one layer (its words in padded tiles, the padding cut
    where the ranks' logits are assembled).  The prefill's logits and cache and each step's logits and
    the final caches, assembled from the ranks' blocks, equal world size
    1's on the first card within ``SERVE``'s relative L2."""
    from repro_torch.parallel import sharding as SH

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, prompt, toks, start = serve_setup(name,
                                                   torch.device("cuda", 0))
    with torch.inference_mode():
        want = SS.serve_direct(cfg, params, prompt, toks, start)
    del params
    tol = SERVE[name][2]
    parts = [(r["coord"], r[name]) for r in served]
    worst = 0.0
    for k, w in want.items():
        w = torch.from_numpy(w)
        logits = "/logits/" in k or k.endswith("/logits")
        if logits:
            axes = ("batch" if k.startswith("prefill") else "cache_batch",
                    None, "act_vocab")
        else:
            axes = SS.leaf_axes(cfg, k, k.split("/")[0])
        got = SS.assemble(parts, k, tuple(w.shape), axes, (1, WORLD),
                          SH.DEFAULT_RULES, padded=logits)
        err = TP.rel_l2(got, w)
        worst = max(worst, err)
        assert err < tol, (k, err)
    print(f"{name}: worst relative L2 {worst:.3e} against world size 1")


if __name__ == "__main__":
    _rank_main()
