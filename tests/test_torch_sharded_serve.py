"""Sharded serving: ``train/serve.py``'s prefill and decode steps on a
rank's shards held against world size 1, and world size 1 against the
reference's steps.

Each rank is this file run as a script (``test_torch_parallel.spawn``,
gloo over a ``FileStore``): at 2 ranks a (1, 2) ``(data, model)`` mesh,
at 4 ranks (1, 4) and (2, 2) under ``baseline``, and decode on (2, 2)
under ``dp_fsdp``.  A rank hands the steps its blocks of the whole
parameters as ``parallel.sharding.ShardedLeaf`` s (the products split
over ``model`` where ``baseline``'s rules split them) and its rows of the
batch:

* prefill (the wave layout's cache): the ranks' logits and every cache
  entry, assembled by their shardings' blocks (attention's K, V and
  slot positions cut to the rank's block of the slots; the RG-LRU's and
  the SSD's caches whole), equal world size 1's;
* decode from world size 1's prefill cache padded to ``W`` slots and cut
  into the ranks' blocks: six wave steps at ``WAVE_POS`` and four
  per-slot steps at ``SLOT_POS``, which write into every rank's block of
  every ``model`` group and wrap the ring (the global cache's and the
  local window's); each step's logits and the final cache equal world
  size 1's;
* at 4 ranks on (1, 4), under ``LiveBytes``: no tensor a rank makes in
  decode holds a layer's ``W`` slots, none in prefill every layer's
  whole-sequence cache; in RecurrentGemma's and Mamba-2's decode none
  has the RG-LRU's whole width or the SSD's whole head count along a
  dimension, but the gates' gathered input and their weights' columns.

Within ``TOL_W1`` relative L2 in f32.  The configs are the reference
tests' reduced ones: SmolLM-360M (tied head), Qwen3-30B-A3B (the MoE's
expert-parallel paths, at capacity factor E / k so that nothing drops;
its KV heads cut at 4 ranks), RecurrentGemma-2B (a local ring of 8 with
one KV head, cut; the RG-LRU at width 96, which no other dimension has,
split over ``model``), Mamba-2 780M (the SSD cache only, its 8 heads
split over ``model``) and MiniCPM-2B at 3 heads and 511 words, which
``model`` does not divide: its ranks take padded tiles of the heads and
the vocabulary (2 + 1 heads and 256 + 255 words at 2 ranks; 1, 1, 1, 0
and 128, 128, 128, 127 at 4), and the ranks' logits tiles are assembled
with the padding cut.  World size 1 equals the
reference's steps (``jit_prefill_step`` / ``jit_decode_step``) within 2e-4
(``tests/test_torch_models.py``'s), the weights the reference's,
carried across by ``convert.params_from_numpy``; at one rank the steps
are the direct steps bit for bit.

Under ``dp_fsdp`` the rules split the batch over ``model`` but not the
cache's rows: a prefill's cache holds every row of the rank's shard,
each layer's gathered over the ``model`` group, also where ``model``
divides the batch (``2x2_dp_fsdp``: a row a rank, two a cache block).
Where it does not divide it (``SPLIT_MESHES``, Qwen3-30B-A3B,
RecurrentGemma-2B and Mamba-2 780M), each rank runs its padded tile of
its shard's rows, some none, and its logits and cache are still its
output leaves' blocks, equal to world size 1's.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_parallel as TP  # noqa: E402

TOL_W1 = 1e-5                  # relative L2 against world size 1
TOL_REF = 2e-4                 # world size 1 against the reference
B, S, W = 4, 16, 40            # rows, prefill positions, decode slots
# wave decode positions: at W = 40 slots (blocks of 10 at 4 ranks, 20 at
# 2) and at the local window's 8 (blocks of 2 and 4) every block is
# written, 42 wraps both rings
WAVE_POS = (16, 21, 27, 30, 35, 42)
# per-slot decode: row b's position at each of four steps
SLOT_POS = np.array([(16, 17, 18, 19), (21, 27, 30, 35), (27, 30, 35, 42),
                     (35, 42, 50, 61)], np.int64)
ARCHS = {
    "smollm": ("smollm_360m", {}),
    "qwen3": ("qwen3_moe_30b_a3b", {"capacity_factor": 4.0}),
    "recurrentgemma": ("recurrentgemma_2b", {"lru_width": 96}),
    "mamba2": ("mamba2_780m", {}),
    "minicpm": ("minicpm_2b", {"num_heads": 3, "num_kv_heads": 3,
                               "vocab_size": 511}),
}
# name -> (mesh (data, model), policy, runs the prefill)
MESHES = {2: {"1x2": ((1, 2), "baseline", True)},
          4: {"1x4": ((1, 4), "baseline", True),
              "2x2": ((2, 2), "baseline", True),
              "2x2_dp_fsdp": ((2, 2), "dp_fsdp", True)}}
# prefill under dp_fsdp where model does not divide the batch, so that each
# rank of a model group runs its padded tile of its shard's rows: name ->
# (mesh (data, model), global rows): 3 over 2 (2 + 1), 2 over 4 (1, 1 and
# two empty ranks), a shard of 3 of 6 over 2 (2 + 1)
SPLIT_MESHES = {2: {"1x2_rows3": ((1, 2), 3)},
                4: {"1x4_rows2": ((1, 4), 2), "2x2_rows6": ((2, 2), 6)}}
SPLIT_ARCHS = ("qwen3", "recurrentgemma", "mamba2")
SPLIT_B = 6                    # the row-split prompts' rows at most
MEM_CASE = ("1x4", "smollm")   # the 4-rank memory probe
SPLIT_PROBES = ("recurrentgemma", "mamba2")    # and the split blocks' on 1x4
LAYOUTS = ("wave", "per_slot")


def port_cfg(name):
    from repro_torch import configs as PC
    from repro_torch.launch.train import reduced

    arch, kw = ARCHS[name]
    return reduced(PC.get_config(arch)).with_(dtype="float32",
                                              param_dtype="float32", **kw)


def ref_cfg(name):
    from repro import configs as RC
    from test_models import reduced

    arch, kw = ARCHS[name]
    return reduced(RC.get_config(arch)).with_(dtype="float32",
                                              param_dtype="float32", **kw)


def weights(name):
    """The reference's ``init_params`` of ``name`` (numpy), and the same
    as the port's tensors (``convert.params_from_numpy``)."""
    import jax

    from repro.models import transformer as RT
    from repro_torch.convert import params_from_numpy

    init = jax.jit(RT.init_params, static_argnums=0)
    pr = {k: np.asarray(v) for k, v in init(ref_cfg(name),
                                            jax.random.PRNGKey(0)).items()}
    return pr, params_from_numpy(port_cfg(name), pr, "cpu")


def tokens(name):
    """Prompt [B, S] and decode tokens [B, 6], below the vocabulary."""
    rng = np.random.default_rng(37)
    V = port_cfg(name).vocab_size
    return (rng.integers(0, V, (B, S)).astype(np.int32),
            rng.integers(0, V, (B, len(WAVE_POS))).astype(np.int32))


def per_slot(cache: dict) -> dict:
    """A wave cache (numpy) in the per-slot layout: every row's
    ``slot_pos`` the shared one."""
    out = {}
    for k, v in cache.items():
        if k.endswith("slot_pos"):
            v = np.broadcast_to(v[..., None, :], v.shape[:-1] + (B,)
                                + v.shape[-1:]).copy()
        out[k] = v
    return out


def decode_caches(cfg, prefill_cache: dict) -> dict:
    """{layout: the decode's start cache (numpy)}: the prefill cache
    padded to ``W`` slots (``pad_cache_to``), and the same per slot."""
    from repro_torch.convert import cache_to_numpy
    from repro_torch.models import transformer as T
    from repro_torch.train import serve as SRV

    wave = cache_to_numpy(SRV.pad_cache_to(prefill_cache,
                                           T.cache_shapes(cfg, B, W)))
    return {"wave": wave, "per_slot": per_slot(wave)}


def serve_direct(cfg, params, prompt, toks, start):
    """The direct steps on ``params``' device: prefill, then each layout's
    decode from ``start`` (numpy, by layout) -> numpy results."""
    from repro_torch.convert import cache_from_numpy, cache_to_numpy
    from repro_torch.train import serve as SRV

    dev = next(iter(params.values())).device
    out = {}
    cache, lg = SRV.make_prefill_step(cfg)(params,
                                           {"tokens": torch.from_numpy(prompt)})
    out["prefill/logits"] = lg.cpu().numpy()
    out.update({f"prefill/cache/{k}": v
                for k, v in cache_to_numpy(cache).items()})
    decode = SRV.make_decode_step(cfg)
    for layout, c in start.items():
        c = cache_from_numpy(c, dev)
        for i, t in enumerate(steps(layout)):
            c, lg = decode(params, c, torch.from_numpy(toks[:, i:i + 1]), t)
            out[f"{layout}/logits/{i}"] = lg.cpu().numpy()
        out.update({f"{layout}/cache/{k}": v
                    for k, v in cache_to_numpy(c).items()})
    return out


def split_prompt(name):
    """The row-split cases' prompt [SPLIT_B, S], below the vocabulary."""
    rng = np.random.default_rng(41)
    return rng.integers(0, port_cfg(name).vocab_size,
                        (SPLIT_B, S)).astype(np.int32)


def steps(layout):
    """Each decode step's ``pos``: an int (wave) or a [B] tensor."""
    if layout == "wave":
        return list(WAVE_POS)
    return [torch.from_numpy(SLOT_POS[:, i]) for i in range(SLOT_POS.shape[1])]


# ---------------------------------------------------------------------------
# a rank


class _Shapes:
    """``dryrun.LiveBytes`` recording the shape of every tensor an
    operator returns (made on first use: this file imports the port only
    inside functions)."""

    def __new__(cls):
        from torch.utils import _pytree as pytree

        from repro_torch.launch.dryrun import LiveBytes

        class Shapes(LiveBytes):
            def __init__(self):
                super().__init__("cpu")
                self.shapes = set()

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = super().__torch_dispatch__(func, types, args, kwargs)
                self.shapes.update(tuple(t.shape) for t in
                                   pytree.tree_leaves(out)
                                   if isinstance(t, torch.Tensor))
                return out

        return Shapes()


def _blocks(tree, shs, coord):
    """The rank's block of each leaf (a tensor, or a numpy array), a
    copy."""
    out = {}
    for k, v in tree.items():
        b = v[shs[k].local_slices(v.shape, coord)]
        out[k] = b.clone() if isinstance(b, torch.Tensor) else b.copy()
    return out


def sharded_serve(cfg, mesh, rules, whole, prompt, toks, start, *,
                  prefill=True, probe=False):
    """One rank's sharded serving under ``rules`` on ``mesh``: its blocks of
    ``whole`` (the parameters, on the rank's device) as ``ShardedLeaf`` s,
    the prefill of its rows of ``prompt`` (where ``prefill``; the batch's
    spec's, and the rank's tile of them where ``model`` splits them,
    ``rows``), and each layout's decode of its rows of ``toks`` from its
    blocks of ``start`` (numpy, by layout: the whole cache at ``W``
    slots).  -> {key: tensor} (with ``probe``, the shapes every operator
    made in the prefill and the wave decode)."""
    from repro_torch.convert import cache_from_numpy
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import serve as SRV

    dev = next(iter(whole.values())).device
    coord = mesh.get_coordinate()
    res = {}
    with SH.sharding_context(mesh, rules):
        ops = SH.MeshOps(mesh)
        p_sh = SH.tree_shardings(T.param_axes(cfg), T.param_shapes(cfg), mesh)
        params = SH.sharded_leaves(_blocks(whole, p_sh, coord), p_sh, ops)
        res["tp"] = split_keys(params, cfg)
        if prefill:
            rows = SH.logical_sharding(("batch", None), mesh,
                                       shape=prompt.shape).local_slices(
                prompt.shape, coord)
            mode = _Shapes() if probe else None
            with mode or _nothing():
                cache, lg = SRV.make_prefill_step(cfg)(
                    params, {"tokens": torch.from_numpy(prompt[rows]).to(dev)},
                    rows=prompt.shape[0])
            res["prefill/logits"] = lg
            res.update({f"prefill/cache/{k}": v for k, v in cache.items()})
            split = SH.row_group(ops, prompt.shape[0])
            res["tile"] = None if split is None else split.block(
                rows[0].stop - rows[0].start)
            if probe:
                res["prefill/shapes"] = sorted(mode.shapes)
        if not start:
            return res
        rows = SH.logical_sharding(("cache_batch", None), mesh,
                                   shape=toks.shape).local_slices(
            toks.shape, coord)[0]
        decode = SRV.make_decode_step(cfg)
        for layout, c_whole in start.items():
            ps = layout == "per_slot"
            c_sh = SH.tree_shardings(T.cache_axes(cfg, B, W, per_slot=ps),
                                     T.cache_shapes(cfg, B, W, per_slot=ps),
                                     mesh)
            c = SH.sharded_leaves(cache_from_numpy(
                _blocks(c_whole, c_sh, coord), dev), c_sh, ops)
            mode = _Shapes() if probe and layout == "wave" else None
            with mode or _nothing():
                for i, t in enumerate(steps(layout)):
                    pos = t if layout == "wave" else t[rows].to(dev)
                    new, lg = decode(
                        params, c,
                        torch.from_numpy(toks[rows, i:i + 1]).to(dev), pos)
                    c = SH.sharded_leaves(new, c_sh, ops)
                    res[f"{layout}/logits/{i}"] = lg
            if mode is not None:
                res["decode/shapes"] = sorted(mode.shapes)
            res.update({f"{layout}/cache/{k}": v for k, v in new.items()})
    return res


def split_keys(params, cfg):
    """The leaves whose product the rank's ``model`` group splits: where
    ``model`` divides the dimension (``sharding.tp_group``), and
    attention's q-head leaves and the head where the rules tile the heads
    and the vocabulary over ``model``, padded where it does not divide
    them (``sharding.tile_group``)."""
    from repro_torch.models import layers as L
    from repro_torch.parallel import sharding as SH

    head = "tok_embed" if cfg.tie_embeddings else "lm_head"

    def split(k, v):
        if k == head:
            return SH.tile_group(v, "vocab")
        if k.split("_", 1)[1] in L.HEAD_DIMS:
            return SH.tile_group(v, "heads")
        return SH.tp_group(v)

    return sorted(k for k, v in params.items() if split(k, v) is not None)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _sub(inp, prefix, tensors=False):
    return {k[len(prefix):]: torch.from_numpy(v) if tensors else v
            for k, v in inp.items() if k.startswith(prefix)}


def _rank_checks(world, rank, out, inp):
    from repro_torch.launch import dryrun as D
    from repro_torch.parallel import sharding as SH

    res = {"rank": rank}
    for mname, (shape, policy, prefill) in MESHES[world].items():
        mesh = SH.make_mesh(shape, ("data", "model"), device="cpu")
        res[f"{mname}/coord"] = tuple(mesh.get_coordinate())
        for name in ARCHS:
            cfg = port_cfg(name)
            _, rules, _ = D.apply_policy(cfg, "prefill_32k", policy)
            res[f"{mname}/{name}"] = sharded_serve(
                cfg, mesh, rules, _sub(inp, f"{name}/params/", True),
                inp[f"{name}/prompt"], inp[f"{name}/toks"],
                {lay: _sub(inp, f"{name}/{lay}/") for lay in LAYOUTS},
                prefill=prefill, probe=(mname, name) == MEM_CASE or (
                    mname == MEM_CASE[0] and name in SPLIT_PROBES))
    for mname, (shape, rows) in SPLIT_MESHES[world].items():
        mesh = SH.make_mesh(shape, ("data", "model"), device="cpu")
        res[f"{mname}/coord"] = tuple(mesh.get_coordinate())
        for name in SPLIT_ARCHS:
            cfg = port_cfg(name)
            _, rules, _ = D.apply_policy(cfg, "prefill_32k", "dp_fsdp")
            res[f"{mname}/{name}"] = sharded_serve(
                cfg, mesh, rules, _sub(inp, f"{name}/params/", True),
                inp[f"{name}/split_prompt"][:rows], None, {})
    torch.save(res, out / f"rank{rank}.pt")


def _rank_main(argv=None):
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    for a in ("--world", "--rank"):
        ap.add_argument(a, type=int)
    for a in ("--store", "--out", "--inputs"):
        ap.add_argument(a)
    a = ap.parse_args(argv)
    TP.init_rank_group(a.world, a.rank, a.store)
    try:
        with torch.inference_mode():
            _rank_checks(a.world, a.rank, pathlib.Path(a.out),
                         dict(np.load(a.inputs)))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the fixture: world size 1, the reference, and the ranks


def _reference(name, params_np, prompt, toks, start):
    """The reference's steps on the same weights and inputs -> numpy."""
    import jax.numpy as jnp

    from repro.train import serve as RSRV

    cfg = ref_cfg(name)
    pr = {k: jnp.asarray(v) for k, v in params_np.items()}
    out = {}
    cache, lg = RSRV.jit_prefill_step(cfg)(pr,
                                           {"tokens": jnp.asarray(prompt)})
    out["prefill/logits"] = np.asarray(lg)
    out.update({f"prefill/cache/{k}": np.asarray(v)
                for k, v in cache.items()})
    decode = RSRV.jit_decode_step(cfg)
    for layout, c in start.items():
        c = {k: jnp.asarray(v) for k, v in c.items()}
        for i in range(len(steps(layout))):
            pos = (jnp.int32(WAVE_POS[i]) if layout == "wave"
                   else jnp.asarray(SLOT_POS[:, i].astype(np.int32)))
            c, lg = decode(pr, c, jnp.asarray(toks[:, i:i + 1]), pos)
            out[f"{layout}/logits/{i}"] = np.asarray(lg)
        out.update({f"{layout}/cache/{k}": np.asarray(v)
                    for k, v in c.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """World size 1's results (``w1``), the reference's (``ref``, each
    from its own prefill's cache) and the ranks' at 2 and 4."""
    from repro_torch.convert import cache_to_numpy
    from repro_torch.train import serve as SRV

    root = tmp_path_factory.mktemp("sharded_serve")
    inp, w1, ref_in = {}, {}, {}
    for name in ARCHS:
        cfg = port_cfg(name)
        pr, params = weights(name)
        prompt, toks = tokens(name)
        cache, _ = SRV.make_prefill_step(cfg)(
            params, {"tokens": torch.from_numpy(prompt)})
        start = decode_caches(cfg, cache)
        w1[name] = serve_direct(cfg, params, prompt, toks, start)
        if name in SPLIT_ARCHS:
            inp[f"{name}/split_prompt"] = sp = split_prompt(name)
            for rows in {r for m in SPLIT_MESHES.values()
                         for _, r in m.values()}:
                c, lg = SRV.make_prefill_step(cfg)(
                    params, {"tokens": torch.from_numpy(sp[:rows])})
                w1[f"{name}/rows{rows}"] = {
                    "prefill/logits": lg.numpy(),
                    **{f"prefill/cache/{k}": v.numpy()
                       for k, v in c.items()}}
        ref_in[name] = (pr, prompt, toks)
        inp.update({f"{name}/params/{k}": v.numpy()
                    for k, v in params.items()})
        inp.update({f"{name}/prompt": prompt, f"{name}/toks": toks})
        for layout, c in start.items():
            inp.update({f"{name}/{layout}/{k}": v for k, v in c.items()})
        assert cache_to_numpy(cache).keys() == start["wave"].keys()
    inputs = root / "inputs.npz"
    np.savez(inputs, **inp)
    ports = {}
    threads = [threading.Thread(target=lambda n=n: ports.__setitem__(
        n, _spawn(n, root, inputs))) for n in (2, 4)]
    for t in threads:
        t.start()
    try:
        ref = {}
        for name, (pr, prompt, toks) in ref_in.items():
            ref_start = _ref_start(name, pr, prompt)
            ref[name] = _reference(name, pr, prompt, toks, ref_start)
    finally:
        for t in threads:
            t.join()
    for n in (2, 4):
        if isinstance(ports.get(n), BaseException):
            raise ports[n]
    return {"w1": w1, "ref": ref, **ports}


def _spawn(n, root, inputs):
    try:
        return TP.spawn(n, pathlib.Path(__file__), root / f"port{n}",
                        "--inputs", inputs)
    except BaseException as e:  # noqa: BLE001 - re-raised by the fixture
        return e


def _ref_start(name, pr, prompt):
    """The reference's decode start caches, from its own prefill."""
    import jax.numpy as jnp

    from repro.models import transformer as RT
    from repro.train import serve as RSRV

    cfg = ref_cfg(name)
    p = {k: jnp.asarray(v) for k, v in pr.items()}
    cache, _ = RSRV.jit_prefill_step(cfg)(p, {"tokens": jnp.asarray(prompt)})
    wave = {k: np.asarray(v) for k, v in RSRV.pad_cache_to(
        cache, RT.cache_shapes(cfg, B, W)).items()}
    return {"wave": wave, "per_slot": per_slot(wave)}


# ---------------------------------------------------------------------------
# the tests


def mesh_cases(prefill_only=False):
    return [(n, m) for n in (2, 4) for m, (_, _, pf) in MESHES[n].items()
            if pf or not prefill_only]


def assemble(parts, key, shape, spec_axes, mesh_shape, rules,
             padded=False):
    """The blocks of ``key`` in ``parts`` ((mesh coordinate, results) of
    each rank of a ``(data, model)`` mesh of ``mesh_shape``), the leaf of
    global ``shape`` and logical axes ``spec_axes`` under ``rules``,
    assembled whole; a rank's tensor whole but its rows (a prefill's
    RG-LRU and SSD caches) read at its rows.  With ``padded`` (logits) a
    dimension the rules split is cut into padded tiles where the mesh
    does not divide it, and each rank's tile lands at its place, the
    padding cut.  Copies of one block must agree."""
    from repro_torch.parallel import sharding as SH

    mesh = SH.AbstractMesh(mesh_shape, ("data", "model"))
    sh = SH.logical_sharding(spec_axes, mesh, rules,
                             None if padded else shape)
    out = torch.full(shape, float("nan"), dtype=torch.float64)
    for coord, res in parts:
        t = res[key].double().cpu()
        sl = (padded_slices(sh, shape, coord) if padded
              else sh.local_slices(shape, coord))
        if tuple(t.shape) != tuple(out[sl].shape):
            sl = tuple(s if a in ("batch", "cache_batch") else slice(None)
                       for s, a in zip(sl, spec_axes))
        done = out[sl]
        if not torch.isnan(done).any():
            torch.testing.assert_close(done, t, rtol=1e-6, atol=1e-6)
        out[sl] = t
    assert not torch.isnan(out).any(), key
    return out


def padded_slices(sh, shape, coord):
    """The rank's slice of a tensor of ``shape`` under the sharding
    ``sh``, a dimension its blocks do not divide cut into padded tiles
    (``sharding.tile``)."""
    from repro_torch.parallel import sharding as SH

    sizes = SH.mesh_shape(sh.mesh)
    at = dict(zip(sizes, coord))
    out = []
    for n, axes in zip(shape, SH.spec_axes(sh.spec, len(shape))):
        blocks, idx = 1, 0
        for a in axes:
            blocks, idx = blocks * sizes[a], idx * sizes[a] + at[a]
        start, w = SH.tile(n, blocks, idx)
        out.append(slice(start, start + w))
    return tuple(out)


def _assemble(runs, n, mesh, name, key, shape, spec_axes, padded=False):
    from repro_torch.launch import dryrun as D

    shp, policy, _ = MESHES[n][mesh]
    _, rules, _ = D.apply_policy(port_cfg(name), "prefill_32k", policy)
    return assemble([(r[f"{mesh}/coord"], r[f"{mesh}/{name}"])
                     for r in runs[n]], key, shape, spec_axes, shp, rules,
                    padded)


def leaf_axes(cfg, key, layout):
    """The logical axes of a result's cache entry (``key``: its layout's
    ``.../cache/<entry>``)."""
    from repro_torch.models import transformer as T

    cache_key = key.split("/cache/")[1]
    if key.startswith("prefill/"):
        return T.cache_axes(cfg, B, S)[cache_key]
    return T.cache_axes(cfg, B, W, per_slot=layout == "per_slot")[cache_key]


@pytest.mark.parametrize("name", list(ARCHS))
def test_world_size_1_equals_reference(runs, name):
    """World size 1's prefill logits and cache, and each layout's decode
    logits (six wave steps, four per-slot steps from the padded prefill
    cache) and final cache, equal the reference's within ``TOL_REF``."""
    got, want = runs["w1"][name], runs["ref"][name]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].astype(np.float32),
                                   want[k].astype(np.float32), rtol=TOL_REF,
                                   atol=TOL_REF, err_msg=k)


@pytest.mark.parametrize("n,mesh,name", [
    (n, m, a) for n, m in mesh_cases(prefill_only=True) for a in ARCHS])
def test_sharded_prefill_equals_world_size_1(runs, n, mesh, name):
    """The ranks' prefill logits (their rows, their block of the
    vocabulary where ``model`` splits the head) and every cache entry
    (attention's cut to the rank's block of the slots), assembled, equal
    world size 1's within ``TOL_W1`` relative L2."""
    cfg = port_cfg(name)
    w1 = runs["w1"][name]
    V = cfg.vocab_size
    got = _assemble(runs, n, mesh, name, "prefill/logits", (B, 1, V),
                    ("batch", None, "act_vocab"), padded=True)
    assert TP.rel_l2(got, torch.from_numpy(w1["prefill/logits"])) < TOL_W1
    keys = [k for k in w1 if k.startswith("prefill/cache/")]
    assert keys and all(k in runs[n][0][f"{mesh}/{name}"] for k in keys)
    for k in keys:
        want = torch.from_numpy(w1[k]).double()
        got = _assemble(runs, n, mesh, name, k, tuple(want.shape),
                        leaf_axes(cfg, k, "wave"))
        assert TP.rel_l2(got, want) < TOL_W1, (k, TP.rel_l2(got, want))
        if k.endswith("slot_pos"):
            assert torch.equal(got, want), k


@pytest.mark.parametrize("n,mesh,name", [
    (n, m, a) for n in (2, 4) for m in SPLIT_MESHES[n] for a in SPLIT_ARCHS])
def test_row_split_prefill_equals_world_size_1(runs, n, mesh, name):
    """Under ``dp_fsdp`` on batches that ``model`` does not divide
    (``SPLIT_MESHES``), each rank of a ``model`` group runs its padded
    tile of its shard's rows (at 4 ranks on (1, 4) two ranks run none),
    and its outputs are the output leaves' blocks: the logits of every
    row of its shard, the cache of every row and the rank's block of the
    slots.  Assembled, they equal world size 1's prefill of the same
    rows within ``TOL_W1`` relative L2, the slot positions exactly."""
    from repro_torch.launch import dryrun as D
    from repro_torch.parallel import sharding as SH

    cfg = port_cfg(name)
    shape, rows = SPLIT_MESHES[n][mesh]
    w1 = runs["w1"][f"{name}/rows{rows}"]
    _, rules, _ = D.apply_policy(cfg, "prefill_32k", "dp_fsdp")
    parts = [(r[f"{mesh}/coord"], r[f"{mesh}/{name}"]) for r in runs[n]]
    shard = rows // shape[0]
    assert [res["tile"] for _, res in parts] == [
        SH.tile(shard, shape[1], c[1]) for c, _ in parts]
    assert {k for k in parts[0][1] if k.startswith("prefill/")} == set(w1)
    for k, want in w1.items():
        want = torch.from_numpy(want).double()
        axes = (("batch", None, "act_vocab") if k == "prefill/logits"
                else leaf_axes(cfg, k, "wave"))
        got = assemble(parts, k, tuple(want.shape), axes, shape, rules)
        assert TP.rel_l2(got, want) < TOL_W1, (k, TP.rel_l2(got, want))
        if k.endswith("slot_pos"):
            assert torch.equal(got, want), k
        sh = SH.logical_sharding(axes, SH.AbstractMesh(shape, (
            "data", "model")), rules, tuple(want.shape))
        rows_at = [i for i, a in enumerate(axes)
                   if a in ("batch", "cache_batch")]
        for coord, res in parts:
            # the rank's block of the leaf's rows: every row of its shard
            # (a whole-run SSD cache keeps its heads whole, as at 1 row)
            block = want[sh.local_slices(tuple(want.shape), coord)]
            assert [res[k].shape[i] for i in rows_at] == [
                block.shape[i] for i in rows_at], (k, coord)
            if "/cache/s0_k" in k or "/cache/s0_v" in k:
                assert res[k].shape == block.shape, (k, coord)


@pytest.mark.parametrize("n,mesh,name,layout", [
    (n, m, a, lay) for n, m in mesh_cases() for a in ARCHS
    for lay in ("wave", "per_slot")])
def test_sharded_decode_equals_world_size_1(runs, n, mesh, name, layout):
    """Each decode step's logits and the final cache, assembled from the
    ranks' blocks, equal world size 1's within ``TOL_W1`` relative L2,
    its slot positions exactly; every rank's block of the slots was
    written (a position past the prefill's 16 in it) and the ring
    wrapped (a slot below 16 holds a position past ``W``)."""
    cfg = port_cfg(name)
    w1 = runs["w1"][name]
    V = cfg.vocab_size
    for i in range(len(steps(layout))):
        k = f"{layout}/logits/{i}"
        got = _assemble(runs, n, mesh, name, k, (B, 1, V),
                        ("cache_batch", None, "act_vocab"), padded=True)
        assert TP.rel_l2(got, torch.from_numpy(w1[k])) < TOL_W1, k
    keys = [k for k in w1 if k.startswith(f"{layout}/cache/")]
    for k in keys:
        want = torch.from_numpy(w1[k]).double()
        got = _assemble(runs, n, mesh, name, k, tuple(want.shape),
                        leaf_axes(cfg, k, layout))
        assert TP.rel_l2(got, want) < TOL_W1, (k, TP.rel_l2(got, want))
        if not k.endswith("slot_pos"):
            continue
        assert torch.equal(got, want), k
        for r in runs[n]:
            block = r[f"{mesh}/{name}"][k]
            assert (block >= S).any(), (k, r["rank"])
        assert (got[..., :S] >= W).any(), k
    assert any(k.endswith("slot_pos") for k in keys) == any(
        kind in ("attn", "attn_moe", "attn_local") for kind in cfg.layer_kinds)


@pytest.mark.parametrize("n,mesh,name", [
    (n, m, a) for n, m in mesh_cases() for a in ARCHS])
def test_products_split_over_model(runs, n, mesh, name):
    """Under ``baseline`` (nothing under ``dp_fsdp``) the rank's ``model``
    group splits attention's q heads and the head's vocabulary, in padded
    tiles where ``model`` does not divide them (MiniCPM's 3 heads and 511
    words: the rank's logits hold its tile), the MLPs' hidden units, and
    every leaf of the RG-LRU and the SSD mixer that the reference splits
    over ``model`` (the SSD's B, C and norm scale stay whole)."""
    from repro_torch.models import rglru as R
    from repro_torch.models import ssm as SM
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as SH

    cfg = port_cfg(name)
    tp = set(runs[n][0][f"{mesh}/{name}"]["tp"])
    for r in runs[n]:
        assert set(r[f"{mesh}/{name}"]["tp"]) == tp
    if MESHES[n][mesh][1] == "dp_fsdp":
        assert not tp
        return
    attends = any(k.startswith("attn") for k in cfg.layer_kinds)
    assert ("s0_wq" in tp or "s2_wq" in tp) == attends
    head = "tok_embed" if cfg.tie_embeddings else "lm_head"
    assert head in tp
    model = MESHES[n][mesh][0][1]
    for r in runs[n]:
        tile = SH.tile(cfg.vocab_size, model, r[f"{mesh}/coord"][1])[1]
        assert r[f"{mesh}/{name}"]["prefill/logits"].shape[-1] == tile
    keys = T.param_specs(cfg)
    own = {k for k in keys if k.split("_", 1)[1] in R.TP_WEIGHTS
           + SM.TP_WEIGHTS}
    assert bool(own) == (name in SPLIT_PROBES) and own <= tp
    assert not {k for k in keys if k.split("_", 1)[1] in (
        "wB", "wC", "conv_B", "conv_C", "ssd_norm_scale")} & tp


def test_no_rank_holds_a_whole_cache(runs):
    """At 4 ranks on (1, 4) (SmolLM, under ``LiveBytes``): no tensor a
    rank makes in six wave decode steps has the cache's ``W`` slots along
    any dimension, and none in the prefill holds every layer's cache of
    the whole sequence; the prefill's cache is the stacked layers' block
    of ``S / 4`` slots."""
    mesh, name = MEM_CASE
    cfg = port_cfg(name)
    L, Kv, hd = cfg.n_super, cfg.num_kv_heads, cfg.head_dim
    for r in runs[4]:
        e = r[f"{mesh}/{name}"]
        assert e["decode/shapes"]
        assert not [s for s in e["decode/shapes"] if W in s]
        assert (L, B, S, Kv, hd) not in e["prefill/shapes"]
        assert (L, B, S // 4, Kv, hd) in e["prefill/shapes"]
        assert tuple(e["prefill/cache/s0_k"].shape) == (L, B, S // 4, Kv, hd)


@pytest.mark.parametrize("name", SPLIT_PROBES)
def test_split_recurrent_decode_holds_no_whole_width(runs, name):
    """At 4 ranks on (1, 4) (under ``LiveBytes``): no tensor a rank makes
    in six wave decode steps has the RG-LRU's whole width ``w`` along a
    dimension but the gates' input gathered over the group ``[B, w]`` and
    their weights' columns ``[w, w/4]``, and none has the SSD's whole
    head count (the gathered x column and the conv window have
    ``d_inner`` and ``d_inner + 2 ds`` columns); the updated state is the
    rank's block of the channels or heads."""
    mesh, _ = MEM_CASE
    cfg = port_cfg(name)
    for r in runs[4]:
        shapes = r[f"{mesh}/{name}"]["decode/shapes"]
        assert shapes
        if name == "recurrentgemma":
            w = cfg.rnn_width
            assert w not in (cfg.d_model, cfg.d_ff, cfg.vocab_size // 4)
            assert {s for s in shapes if w in s} <= {(B, w), (w, w // 4)}
            assert (B, w // 4) in shapes
        else:
            nh, hd, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            assert not [s for s in shapes if nh in s], shapes
            assert (B, nh // 4, hd, ds) in shapes
            assert (B, 1, cfg.d_inner) in shapes


@pytest.fixture(scope="module")
def group1():
    """A one-rank gloo group in this process (``launch.mesh``'s own)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_one_rank_group

    if not dist.is_initialized():
        init_one_rank_group("cpu")
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ["smollm", "recurrentgemma"])
def test_one_rank_steps_are_the_direct_steps(runs, group1, name):
    """On a one-rank (1, 1) mesh the sharded pieces hand the steps the
    whole tensors (``sharded_leaves``), and prefill and both layouts'
    decode equal the direct steps bit for bit."""
    from repro_torch.convert import cache_from_numpy
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import serve as SRV

    cfg = port_cfg(name)
    w1 = runs["w1"][name]
    prompt, toks = tokens(name)
    _, whole = weights(name)
    mesh = SH.make_mesh((1, 1), ("data", "model"), device="cpu")
    with SH.sharding_context(mesh):
        ops = SH.MeshOps(mesh)
        p_sh = SH.tree_shardings(T.param_axes(cfg), T.param_shapes(cfg), mesh)
        params = SH.sharded_leaves(whole, p_sh, ops)
        assert all(params[k] is whole[k] for k in whole)
        cache, lg = SRV.make_prefill_step(cfg)(
            params, {"tokens": torch.from_numpy(prompt)})
    assert np.array_equal(lg.numpy(), w1["prefill/logits"])
    for k, v in cache.items():
        assert np.array_equal(v.numpy(), w1[f"prefill/cache/{k}"]), k
    for layout, c in decode_caches(cfg, cache).items():
        c = cache_from_numpy(c, "cpu")
        with SH.sharding_context(mesh):
            c_sh = SH.tree_shardings(
                T.cache_axes(cfg, B, W, per_slot=layout == "per_slot"),
                T.cache_shapes(cfg, B, W, per_slot=layout == "per_slot"),
                mesh)
            c = SH.sharded_leaves(c, c_sh, ops)
            for i, t in enumerate(steps(layout)):
                c, lg = SRV.make_decode_step(cfg)(
                    params, c, torch.from_numpy(toks[:, i:i + 1]), t)
                assert np.array_equal(lg.numpy(),
                                      w1[f"{layout}/logits/{i}"])
        for k, v in c.items():
            assert np.array_equal(v.numpy(), w1[f"{layout}/cache/{k}"]), k


if __name__ == "__main__":
    _rank_main()
