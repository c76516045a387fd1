"""``repro_torch.launch.dryrun`` against the reference's
``repro.launch.dryrun`` and against itself on real tensors.

* For the cells of ``CELLS`` the port's record has the reference's
  ``status``, ``devices``, ``argument_bytes``, ``output_bytes``,
  ``alias_bytes`` and ``param_counts``, exactly.  The reference lowers
  and compiles each cell for its 256/512-device pod in a subprocess
  (its module sets ``XLA_FLAGS`` when imported), started before the port
  runs its side so that the two overlap.
* The port's meta estimate of a small cell (a reduced config, 64
  positions, a (2, 2) mesh) equals the same tracker on a real CPU run of
  the same program with seeded tensors, byte for byte and FLOP for FLOP,
  for each kind of step.
* ``FlopCounterMode``'s count of a small dense prefill equals a hand
  count of its products; the kernels' meta launches count theirs.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import configs as PC
from repro_torch.configs import ShapeSpec
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import ssd_scan as SS
from repro_torch.launch import dryrun as D
from repro_torch.launch.train import reduced
from repro_torch.models import layers as PL
from repro_torch.parallel.sharding import AbstractMesh

REPO = pathlib.Path(__file__).resolve().parents[1]

CELLS = (("mamba2_780m", "decode_32k", "pod"),
         ("mamba2_780m", "decode_32k", "multipod"),
         ("smollm_360m", "train_4k", "pod"),
         ("qwen1_5_4b", "prefill_32k", "pod"),
         ("qwen1_5_4b", "prefill_32k", "multipod"),
         ("qwen3_moe_30b_a3b", "train_4k", "pod"),
         ("phi3_vision_4_2b", "prefill_32k", "pod"),
         ("recurrentgemma_2b", "long_500k", "multipod"),
         ("smollm_360m", "long_500k", "pod"))

_REF_SCRIPT = r"""
import json, pathlib, sys
from repro.launch import dryrun as D
D.OUT_DIR = pathlib.Path(sys.argv[1])
out = {}
for cell in json.loads(sys.argv[2]):
    rec = D.run_cell(*cell, save_hlo=False)
    out["__".join(cell)] = {k: rec.get(k) for k in (
        "status", "devices", "memory", "param_counts")}
print("REF", json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's records of ``CELLS``, from a subprocess started at
    once; the port's side runs while it lowers and compiles."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT,
         str(tmp_path_factory.mktemp("dryrun_ref")), json.dumps(CELLS)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    box = {}

    def get():
        if "out" not in box:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines() if ln.startswith("REF ")]
            box["out"] = json.loads(line[-1][4:])
        return box["out"]

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.mark.parametrize("cell", CELLS, ids=["__".join(c) for c in CELLS])
def test_run_cell_matches_reference(reference, cell):
    rec = D.run_cell(*cell, save=False)
    ref = reference()["__".join(cell)]
    assert rec["status"] == ref["status"]
    if ref["status"] == "skipped":
        return
    assert rec["devices"] == ref["devices"]
    assert rec["param_counts"] == ref["param_counts"]
    for k in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert rec["memory"][k] == ref["memory"][k], k
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["cost_analysis"]["bytes_accessed"] is None
    assert rec["cost_analysis"]["transcendentals"] is None
    assert rec["fits"] == (rec["memory"]["argument_bytes"]
                           + rec["memory"]["temp_bytes"] <= D.H100_80GB_BYTES)


# train_4k pod cells whose state the sharded step keeps sharded: (arch,
# policy) -> the bound on temp_bytes in GiB (gathering the state whole,
# the port's step took 487.85 and 58.01 GiB under dp_fsdp; under
# baseline, with the products whole, Qwen3 took 200.13 and InternLM2
# 121.18; split over model 32.82 and 13.19; RecurrentGemma-2B with its
# RG-LRU blocks whole 79.78, split 40.43; with the heads and the
# vocabulary whole where 16 does not divide them, MiniCPM-2B 163.84 and
# Mamba-2 71.79, in padded tiles 21.11 and 12.07; Llama-4 Maverick with
# its MoE's dense fallback, each layer's 128 experts gathered whole, 87.71
# (over the card), on the expert-parallel path 44.54)
SHARDED_TRAIN = {("qwen3_moe_30b_a3b", "dp_fsdp", "pod"): 24.0,
                 ("qwen1_5_4b", "dp_fsdp", "pod"): 15.0,
                 ("qwen3_moe_30b_a3b", "baseline", "pod"): 36.0,
                 ("internlm2_1_8b", "baseline", "pod"): 15.0,
                 ("recurrentgemma_2b", "baseline", "pod"): 45.0,
                 ("minicpm_2b", "baseline", "pod"): 23.5,
                 ("mamba2_780m", "baseline", "pod"): 13.5,
                 ("llama4_maverick_400b_a17b", "baseline", "pod"): 46.0,
                 # dp_fsdp's multipod cells, each rank of a model group on
                 # its padded tile of 8 rows: 26.19, 13.94, 13.59, 11.23
                 # and 54.38, each its pod cell's (every rank on all 8
                 # before the batch split over model: 189.71, 101.37,
                 # 100.64, 82.45 and 136.55)
                 ("recurrentgemma_2b", "dp_fsdp", "multipod"): 29.0,
                 ("qwen1_5_4b", "dp_fsdp", "multipod"): 15.5,
                 ("qwen3_moe_30b_a3b", "dp_fsdp", "multipod"): 15.0,
                 ("minicpm_2b", "dp_fsdp", "multipod"): 12.5,
                 ("llama4_maverick_400b_a17b", "dp_fsdp", "multipod"): 60.0}


@pytest.mark.parametrize("arch,policy,mesh", list(SHARDED_TRAIN),
                         ids=["-".join(c if c[2] != "pod" else c[:2])
                              for c in SHARDED_TRAIN])
def test_sharded_train_cell_fits(arch, policy, mesh):
    """One rank's ``train_4k`` step holds its share of the state and one
    layer's weights gathered at a time (under ``dp_fsdp`` its 1/256 on
    the pod; under ``baseline`` its ``model`` group splits attention's
    heads, the MLPs, the RG-LRU's channels and the vocabulary, so that
    its f32 logits are over 1/16 of the vocabulary), and its rows: on the
    multipod under ``dp_fsdp``, 8 rows a (pod, data) shard, which
    ``model``'s 16 ranks do not divide, each rank runs its padded tile of
    them (1 row on the widest, as on the pod; before, all 8 on every
    rank of the group): its temp bytes stay under the bound and the cell
    fits one card."""
    rec = D.run_cell(arch, "train_4k", mesh, policy, save=False)
    temp = rec["memory"]["temp_bytes"] / 2**30
    assert temp < SHARDED_TRAIN[(arch, policy, mesh)], temp
    assert rec["fits"]


# prefill_32k and decode_32k cells that did not fit one card while the
# serving programs gathered every weight and the decode cache whole
# (baseline; that program's temp GiB in the comments):
# (arch, shape, mesh) -> the bound on temp_bytes in GiB now that they keep
# the weights sharded, split the products over model (the RG-LRU's and
# the SSD's too: with those whole RecurrentGemma-2B's prefill took 29.76
# and Mamba-2's 33.05) and decode's cache over cache_seq
SHARDED_SERVE = {("qwen1_5_4b", "decode_32k", "pod"): 2.0,          # 107.36
                 ("qwen1_5_4b", "prefill_32k", "pod"): 32.0,        # 96.85
                 ("qwen3_moe_30b_a3b", "prefill_32k", "pod"): 13.0,  # 107.88
                 ("qwen3_moe_30b_a3b", "prefill_32k", "multipod"): 7.0,  # 82.96
                 ("qwen3_moe_30b_a3b", "decode_32k", "pod"): 2.0,    # 80.88
                 ("minicpm_2b", "decode_32k", "pod"): 2.5,           # 95.08
                 ("minicpm_2b", "prefill_32k", "pod"): 52.0,         # 81.95
                 ("musicgen_large", "decode_32k", "pod"): 1.0,       # 100.52
                 ("phi3_vision_4_2b", "decode_32k", "pod"): 1.0,     # 103.12
                 ("recurrentgemma_2b", "prefill_32k", "pod"): 20.0,  # 88.68
                 ("mamba2_780m", "prefill_32k", "pod"): 20.0,
                 # Llama-4 Maverick's MoE on the expert-parallel path (8
                 # of 128 experts a layer a rank): 8.13 and 1.93 (its
                 # dense fallback, every expert gathered: 39.77 and 30.06)
                 ("llama4_maverick_400b_a17b", "prefill_32k", "pod"): 9.0,
                 ("llama4_maverick_400b_a17b", "decode_32k", "pod"): 2.5,
                 # under dp_fsdp, 2 rows a (data) shard over model's 16:
                 # each rank runs its padded tile of them and relays each
                 # layer's cache to its block: 35.39 (every rank on both
                 # rows before the batch split over model: 83.98)
                 ("recurrentgemma_2b", "prefill_32k", "pod", "dp_fsdp"):
                     39.0}


@pytest.mark.parametrize("cell", list(SHARDED_SERVE),
                         ids=["__".join(c) for c in SHARDED_SERVE])
def test_sharded_serving_cell_fits(cell):
    """One rank's serving program holds its shards of the weights and one
    layer's gathered at a time, its ``model`` group splitting the
    products and the head where ``model`` divides them, and a decode its
    block of the cache's slots; under ``dp_fsdp`` a prefill runs the
    rank's padded tile of the rows where ``model`` does not divide them:
    its temp bytes stay under the bound and the cell fits one card."""
    rec = D.run_cell(*cell[:3], *cell[3:], save=False)
    temp = rec["memory"]["temp_bytes"] / 2**30
    assert temp < SHARDED_SERVE[cell], temp
    assert rec["fits"]


def test_run_cell_writes_its_record(tmp_path):
    rec = D.run_cell("smollm_360m", "decode_32k", "multipod", tag="t",
                     out_dir=tmp_path)
    assert json.loads((tmp_path / f"{rec['cell']}.json").read_text()) == rec
    assert rec["cell"] == "smollm_360m__decode_32k__multipod__t"
    assert rec["devices"] == 512


# ------------------------------------------- the estimate on real tensors

TINY = {"tiny_train": ShapeSpec("tiny_train", "train", 64, 8),
        "tiny_prefill": ShapeSpec("tiny_prefill", "prefill", 64, 8),
        "tiny_decode": ShapeSpec("tiny_decode", "decode", 64, 8),
        # 6 rows: 3 a data shard, which the mesh's model pair does not
        # divide (dp_fsdp's ranks run tiles of 2 and 1 rows)
        "tiny_train6": ShapeSpec("tiny_train6", "train", 64, 6),
        "tiny_prefill6": ShapeSpec("tiny_prefill6", "prefill", 64, 6)}
MESH = AbstractMesh((2, 2), ("data", "model"))
# the reduced configs' overrides: MiniCPM-2B at 3 heads and 511 words,
# which the mesh's model pair tiles padded (2 + 1 heads, 256 + 255 words)
TINY_OVER = {"minicpm_2b": {"num_heads": 3, "num_kv_heads": 3,
                            "vocab_size": 511}}


@pytest.fixture
def tiny(monkeypatch):
    """Reduced configs (with ``TINY_OVER``) and the ``TINY`` shapes in
    ``repro_torch.configs``."""
    full = PC.get_config
    monkeypatch.setattr(PC, "get_config", lambda arch: reduced(
        full(arch)).with_(**TINY_OVER.get(arch, {})))
    for name, sp in TINY.items():
        monkeypatch.setitem(PC.SHAPES, name, sp)


def _measure(arch, shape, device, policy="baseline"):
    # each run starts with no RoPE table cached (``_rope_freqs_on`` keeps
    # one a device): a table an earlier test left on the CPU would keep
    # its bytes out of the CPU run but not out of the meta run
    PL._rope_freqs_on.cache_clear()
    ctx, low = D.build_lowerable(arch, shape, MESH, policy)
    if device == "meta":
        args, gather = D.meta_args(low), D.meta_gather
    else:
        args = D.seeded_args(low, 3, device)
        gather = D.seeded_gather(3, device, low.cfg.vocab_size)
    outs, arg_bytes, peak, flops = D.run_program(low, ctx, list(args), gather,
                                                 device)
    return low, outs, (arg_bytes, peak, flops)


ESTIMATE_CELLS = [
    ("smollm_360m", "tiny_train"), ("smollm_360m", "tiny_prefill"),
    ("smollm_360m", "tiny_decode"), ("mamba2_780m", "tiny_prefill"),
    ("mamba2_780m", "tiny_decode"), ("qwen3_moe_30b_a3b", "tiny_train"),
    ("recurrentgemma_2b", "tiny_prefill"), ("phi3_vision_4_2b", "tiny_train"),
    ("smollm_360m", "tiny_train", "dp_fsdp"),
    ("qwen3_moe_30b_a3b", "tiny_train", "dp_fsdp"),
    ("recurrentgemma_2b", "tiny_train"), ("internlm2_1_8b", "tiny_train"),
    ("qwen3_moe_30b_a3b", "tiny_prefill"), ("qwen3_moe_30b_a3b", "tiny_decode"),
    ("recurrentgemma_2b", "tiny_decode"), ("minicpm_2b", "tiny_decode"),
    ("smollm_360m", "tiny_decode", "dp_fsdp"), ("mamba2_780m", "tiny_train"),
    ("minicpm_2b", "tiny_train"), ("minicpm_2b", "tiny_prefill"),
    ("smollm_360m", "tiny_train6", "dp_fsdp"),
    ("qwen3_moe_30b_a3b", "tiny_train6", "dp_fsdp"),
    ("recurrentgemma_2b", "tiny_train6", "dp_fsdp"),
    ("recurrentgemma_2b", "tiny_prefill6", "dp_fsdp"),
    ("mamba2_780m", "tiny_prefill6", "dp_fsdp"),
    ("smollm_360m", "tiny_prefill", "dp_fsdp"),
    ("llama4_maverick_400b_a17b", "tiny_train"),
    ("llama4_maverick_400b_a17b", "tiny_prefill"),
    ("llama4_maverick_400b_a17b", "tiny_decode")]


@pytest.mark.parametrize("cell", ESTIMATE_CELLS,
                         ids=["-".join(c) for c in ESTIMATE_CELLS])
def test_meta_estimate_equals_a_cpu_run(tiny, cell):
    """The train cells run the sharded step (each layer's weights
    gathered where used, the gradients reduced to the blocks) under
    ``baseline`` and ``dp_fsdp``, the latter splitting the batch over
    every axis and the weights by ``embed`` alone (on 6 rows, 3 a data
    shard, which ``model`` does not divide, the rank runs its padded tile
    of them, 2 rows, and a prefill gathers its logits' and its cache's
    rows back over the group, the cache then cut to the rank's block of
    the slots: coordinate 0's, the widest; on 8 rows ``model`` divides
    the batch and a prefill gathers the cache's rows alone); under
    ``baseline`` the
    products split over ``model`` (tensor parallelism: the gathers that
    keep ``model`` return rank 0's block), RecurrentGemma's RG-LRU
    blocks and Mamba-2's SSD mixers split beside the split MLPs and local
    attention (their gathers over the group repeat the rank's block),
    InternLM2's KV heads split with its q heads.  The serving cells run
    ``train/serve.py``'s steps on the rank's shards: a prefill cuts each
    layer's cache to the rank's block of the slots (Qwen3's from KV heads
    cut under tensor parallelism) and of the RG-LRU's channels and the
    SSD's heads, decode takes the cache's blocks and runs attention
    sequence-parallel (RecurrentGemma's local ring of 8, ``dp_fsdp``'s
    products whole) and the RG-LRU and SSD on their blocks, the SSD's
    conv window gathered whole but its rows and cut back.  MiniCPM's 3
    heads and 511 words run in padded tiles in each mode (the rank's 2
    heads and 256 words, cut from the leaves gathered whole; a serving
    cell's logits gathered whole over the group, as its output leaf
    holds them).  The MoEs (Qwen3, Llama-4 with its shared expert) take
    their expert-parallel paths, each rank's experts gathered keeping
    ``model`` and its ``all_to_all`` a fresh buffer of the bins."""
    arch, shape, policy = (*cell, "baseline")[:3]
    low, _, on_meta = _measure(arch, shape, "meta", policy)
    low_c, outs, on_cpu = _measure(arch, shape, "cpu", policy)
    assert on_meta == on_cpu
    assert on_meta[1] > on_meta[0] > 0
    # the outputs are the rank's blocks of the output leaves
    def check(leaf, t):
        if isinstance(t, torch.Tensor) and t.dim():
            assert tuple(t.shape) == leaf.shard_shape, leaf.name
            if t.is_floating_point():
                assert bool(torch.isfinite(t).all()), leaf.name

    for tree, leaves in zip(outs, low_c.outs):
        D._map(check, leaves, tree)


EP_CELLS = [(arch, shape, policy)
            for arch in ("qwen3_moe_30b_a3b", "llama4_maverick_400b_a17b")
            for shape in ("tiny_train", "tiny_prefill", "tiny_decode")
            for policy in ("baseline", "dp_fsdp")]


@pytest.mark.parametrize("cell", EP_CELLS,
                         ids=["-".join(c) for c in EP_CELLS])
def test_estimate_cells_run_the_moe_expert_parallel(tiny, monkeypatch, cell):
    """A MoE cell's program on the ``AbstractMesh`` runs the
    expert-parallel paths as a process group would (``a2a`` in train and
    prefill, ``psum`` in baseline's decode, whose rank has fewer tokens
    than ``model`` has ranks): every expert product is over the rank's
    ``E/ep`` experts, the exchanges go through ``DryOps.all_to_all`` and
    the dense fallback never runs."""
    from repro_torch.models import moe as M

    arch, shape, policy = cell
    products, exchanges = [], []
    real_ffn, real_a2a = M._expert_ffn, D.DryOps.all_to_all

    def expert_ffn(recv, wg, wu, wd):
        products.append(wg.shape[0])
        return real_ffn(recv, wg, wu, wd)

    def all_to_all(self, x, axis):
        exchanges.append(axis)
        return real_a2a(self, x, axis)

    def dense(*a, **k):
        raise AssertionError("the dense fallback ran")

    monkeypatch.setattr(M, "_expert_ffn", expert_ffn)
    monkeypatch.setattr(M, "_moe_dense_fallback", dense)
    monkeypatch.setattr(D.DryOps, "all_to_all", all_to_all)
    low, _, _ = _measure(arch, shape, "meta", policy)
    ep = MESH.shape["model"]
    assert products and set(products) == {low.cfg.num_experts // ep}
    psum = shape == "tiny_decode" and policy == "baseline"
    assert set(exchanges) == (set() if psum else {"model"})


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen3_moe_30b_a3b"])
def test_seeded_train_cell_cross_entropy(tiny, arch):
    """A seeded ``dp_fsdp`` train cell's cross-entropy (the rank's metric,
    its share of the global batch's mean under collectives that move
    nothing: its own mean, as ``chip_smoke.py``'s phase 27 (b) reads it)
    is ``random_head_ce`` within that phase's margin, and the loss is it
    plus the router's aux term and the z-loss."""
    _check_cross_entropy(arch, "dp_fsdp")


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen3_moe_30b_a3b"])
def test_seeded_row_split_train_cell_cross_entropy(tiny, arch):
    """:func:`test_seeded_train_cell_cross_entropy` where the batch splits
    over ``model`` in padded tiles (``dp_fsdp`` on 6 rows: the rank runs 2
    of its shard's 3): the rank's cross-entropy over its tile still reads
    ``random_head_ce``."""
    _check_cross_entropy(arch, "dp_fsdp", "tiny_train6")


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen3_moe_30b_a3b",
                                  "minicpm_2b"])
def test_seeded_tp_train_cell_cross_entropy(tiny, arch):
    """:func:`test_seeded_train_cell_cross_entropy` under ``baseline``:
    the (2, 2) mesh's ``model`` splits the head's vocabulary in two and
    the dry run's sums over the group move nothing, so the rank's
    cross-entropy is over its 256 logits, ln(256) + sigma^2 D / 2 (the
    head tied for SmolLM and MiniCPM, ``lm_head`` for Qwen3; MiniCPM's
    511 words in padded tiles of 256 and 255, rank 0's the first)."""
    _check_cross_entropy(arch, "baseline")


def _check_cross_entropy(arch, policy, shape="tiny_train"):
    import chip_smoke

    low, outs, _ = _measure(arch, shape, "cpu", policy)
    mets = {k: float(v) for k, v in outs[1].items()
            if k in ("loss", "ce", "aux")}
    V = low.cfg.vocab_size
    words = -(-V // MESH.shape["model"]) if policy == "baseline" else V
    want = chip_smoke.random_head_ce(low.cfg, words)
    assert abs(mets["ce"] - want) <= chip_smoke.DRYRUN_CE_MARGIN, (mets, want)
    z = mets["loss"] - mets["ce"] - low.cfg.router_aux_weight * mets["aux"]
    assert 0 < z < 1e-4 * (want + 1) ** 2, (mets, z)
    assert (mets["aux"] > 0) == bool(low.cfg.num_experts)


def test_train_cells_flash_shapes_are_held_by_phases_10_and_14():
    """Phase 27 (b)'s train cells give flash one rank's rows of 4,096
    tokens a microbatch: under ``dp_fsdp`` one row of Qwen3-30B-A3B's 32
    heads and of Qwen1.5-4B's 20 at head_dim 128, and the whole
    vocabulary; under ``baseline`` 16 rows of the rank's tile of the
    heads and its tile of the vocabulary (tensor parallelism over 16
    ranks, padded where 16 does not divide them: rank 0's, the widest):
    Qwen3's 2 heads, InternLM2-1.8B's 1, RecurrentGemma-2B's 1 of 10 at
    head_dim 256 with its window, MiniCPM-2B's 3 of 36 and 7,673 of its
    122,753 words; and RecurrentGemma-2B's ``dp_fsdp`` multipod rank, 1
    of its shard's 8 rows (the batch over ``model`` in padded tiles, the
    port's ``row_group``) and all 10 heads; Llama-4 Maverick's
    ``baseline`` rank, 16 rows x 3 of its 40 heads and 12,628 of its
    202,048 words.  All are among phase 10's forward shapes and phase
    14's backward shapes, where the kernels are held to their plain
    versions."""
    import chip_smoke

    got = chip_smoke.dryrun_train_flash_shapes()
    assert got == [(32, 4096, 128, 0), (20, 4096, 128, 0),
                   (32, 4096, 128, 0), (16, 4096, 128, 0),
                   (16, 4096, 256, 2048), (48, 4096, 64, 0),
                   (10, 4096, 256, 2048), (48, 4096, 128, 0)]
    assert [chip_smoke.dryrun_train_split(arch, policy, mesh_kind=mk)[2:]
            for arch, policy, mk in chip_smoke.DRYRUN_TRAIN] == [
        (1, 32, 151936), (1, 20, 151936), (16, 2, 9496), (16, 1, 5784),
        (16, 1, 16000), (16, 3, 7673), (1, 10, 256000), (16, 3, 12628)]
    for shape in got:
        assert shape in chip_smoke.train_flash_shapes()
        assert shape in chip_smoke.bwd_shapes()


SPLIT_CELLS = [(arch, shape, policy, policy == "baseline")
               for arch in ("recurrentgemma_2b", "mamba2_780m")
               for shape in ("tiny_train", "tiny_prefill", "tiny_decode")
               for policy in ("baseline", "dp_fsdp")]


@pytest.mark.parametrize("cell", SPLIT_CELLS,
                         ids=["-".join(c[:3]) for c in SPLIT_CELLS])
def test_estimate_cells_run_the_recurrent_blocks_split(tiny, monkeypatch,
                                                        cell):
    """The estimate cells that hold the RG-LRU and the SSD meta against
    CPU run every such block split over ``model`` under ``baseline`` (the
    group ``transformer._gather_block`` hands ``block_fwd``: the rank's
    block of the channels or heads) and whole under ``dp_fsdp``, in each
    mode, decode's split caches included."""
    from repro_torch.models import transformer as T

    arch, shape, policy, split = cell
    seen = []
    real = T.block_fwd

    def block_fwd(kind, cfg, p, x, **kw):
        if kind in ("rglru", "ssd"):
            tp = kw.get("tp")
            seen.append(None if tp is None else tp.size)
        return real(kind, cfg, p, x, **kw)

    monkeypatch.setattr(T, "block_fwd", block_fwd)
    _measure(arch, shape, "meta", policy)
    assert seen and set(seen) == ({MESH.shape["model"]} if split else {None})


def test_prefill_ssd_shape_is_held_by_phase_27():
    """Mamba-2's ``prefill_32k`` pod cell gives ``ssd_scan`` one rank's 2
    rows times its 3 of the 48 heads (``model`` splits ``d_inner`` and the
    heads over 16 ranks), 128 chunks of 256, B and C one group a row:
    phase 27 (b) holds that shape, beside one whole row of 48 heads,
    against the plain version.  The decode cells split RecurrentGemma-2B's
    RG-LRU channels and Mamba-2's SSD heads; ``dp_fsdp`` splits
    neither."""
    import chip_smoke

    assert chip_smoke.dryrun_prefill_ssd_shape() == (6, 128, 256, 64, 128, 2)
    assert chip_smoke.DRYRUN_SSD_SHAPES == ((48, 128, 256, 64, 128, 1),
                                            (6, 128, 256, 64, 128, 2))
    assert chip_smoke.recurrent_split("mamba2_780m", "ssdk",
                                      "prefill_32k") == {"ssd": (3, 48)}
    assert chip_smoke.recurrent_split("recurrentgemma_2b", "baseline",
                                      "decode_32k") == {"rglru": (160, 2560)}
    assert chip_smoke.recurrent_split("mamba2_780m", "dp_fsdp",
                                      "train_4k") == {"ssd": (48, 48)}
    # under dp_fsdp the pod prefill's 2 rows a data shard split over
    # model: the rank runs 1 row of all 48 heads, the first held shape
    rows = chip_smoke.dryrun_train_split("mamba2_780m", "dp_fsdp+ssdk",
                                         "prefill_32k")[2]
    assert (rows * 48, 128, 256, 64, 128, rows) == \
        chip_smoke.DRYRUN_SSD_SHAPES[0]
    assert {"recurrentgemma_2b", "mamba2_780m"} <= set(
        chip_smoke.DRYRUN_DECODE)


def test_prefill_cells_flash_shapes_are_held_by_phase_10():
    """Phase 27 (b)'s ``prefill_32k`` pod cells give flash one rank's 2
    rows of 32,768 positions times its tile of the q heads over
    ``model``'s 16 ranks: InternLM2-1.8B 1 of 16, Qwen3-30B-A3B,
    MusicGen-large and Phi-3-Vision 2 of 32, and in padded tiles
    SmolLM-360M 1 of 15, RecurrentGemma-2B 1 of 10 with its window,
    Qwen1.5-4B 2 of 20, MiniCPM-2B 3 of 36 and Llama-4 Maverick 3 of 40
    (its MoE on the expert-parallel path); RecurrentGemma-2B's
    ``dp_fsdp`` cell (``DRYRUN_PREFILL``) 1 of its shard's 2 rows (the
    batch over ``model`` in padded tiles) and all 10 heads.  Phase 10
    holds every one, with the plain version a batch-head at a time, which
    equals one call."""
    import chip_smoke

    got = chip_smoke.dryrun_prefill_flash_shapes()
    assert got == ((2, 32768, 64, 0), (2, 32768, 256, 2048),
                   (4, 32768, 128, 0), (2, 32768, 128, 0),
                   (6, 32768, 64, 0), (4, 32768, 64, 0), (4, 32768, 96, 0),
                   (6, 32768, 128, 0), (10, 32768, 256, 2048))
    assert chip_smoke.DRYRUN_PREFILL == (
        ("recurrentgemma_2b", "dp_fsdp+flash", "pod"),)
    assert len(chip_smoke.DRYRUN_MUST_RUN) == 10
    assert "llama4_maverick_400b_a17b" in chip_smoke.DRYRUN_MUST_RUN
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(5, 32, 64, generator=g) for _ in range(3))
    whole = FA.flash_fwd_plain(q, k, v, scale=0.125, window=8)
    rows = chip_smoke.flash_fwd_plain_rows(torch, q, k, v, 0.125, 8,
                                           max_elems=2 * 32 * 32)
    for a, b in zip(rows, whole):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_donated_arguments_are_freed(tiny):
    """The train state is donated: the sharded step empties its dicts as
    it gathers them.  The prefill weights are not: they stay."""
    ctx, low = D.build_lowerable("smollm_360m", "tiny_train", MESH)
    args = list(D.meta_args(low))
    state = args[0]
    D.run_program(low, ctx, args, D.meta_gather, "meta")
    assert state == {} and args == []
    ctx, low = D.build_lowerable("smollm_360m", "tiny_prefill", MESH)
    args = list(D.meta_args(low))
    params = args[0]
    D.run_program(low, ctx, args, D.meta_gather, "meta")
    assert params and all(t.device.type == "meta" for t in params.values())


def test_flop_count_is_the_hand_count(tiny):
    """A reduced SmolLM's prefill (naive attention over whole q chunks,
    gated MLP, tied head), one rank's 4 sequences of 64 on the (2, 2)
    mesh: every product counted by hand.  Its ``model`` pair splits the
    heads, KV heads, hidden units and vocabulary in two (tensor
    parallelism) and the cache's slots (``cache_seq``), whose K and V of
    both KV heads the rank projects over its 32 positions."""
    low, _, (_, _, flops) = _measure("smollm_360m", "tiny_prefill", "meta")
    cfg = low.cfg
    b, S, D_, V = 4, 64, cfg.d_model, cfg.vocab_size
    H, Kv, hd, F = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    tp = MESH.shape["model"]
    assert cfg.mlp_gated and cfg.attn_impl == "naive"
    layer = (2 * b * S * D_ * H // tp * hd            # q
             + 2 * 2 * b * S * D_ * Kv // tp * hd     # k, v
             + 2 * b * S * H // tp * hd * D_          # o
             + 2 * 2 * b * H // tp * S * S * hd       # scores, P V
             + 3 * 2 * b * S * D_ * F // tp           # gate, up, down
             + 2 * 2 * b * S // tp * D_ * Kv * hd)    # the cache's k, v
    assert flops == cfg.num_layers * layer + 2 * b * S * D_ * V // tp


def test_kernel_meta_launches():
    """On meta tensors the kernels' entry points allocate what their CUDA
    launches do, count their operations, launch nothing and count no
    launch; a CPU operand never reaches a meta launch."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import meta

    n = (FA.flash_fwd.launches, FA.flash_bwd_dq.launches,
         FA.flash_bwd_dkv.launches, SS.ssd_scan.launches)
    q = torch.empty(6, 512, 96, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        o = FA.flash_attention(q, q, q, 0.1, 256, 256, 256)
        fwd = fc.get_total_flops()
        o.backward(torch.empty_like(o))
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert q.grad.shape == q.shape and q.grad.device.type == "meta"
    f, dq, dkv = FA.flash_flops(6, 512, 96, 256)
    assert fwd == f and fc.get_total_flops() == f + dq + dkv
    x = torch.empty(96, 4, 256, 64, device="meta")
    la = torch.empty(96, 4, 256, device="meta")
    bm = torch.empty(2, 4, 256, 128, device="meta")
    with FlopCounterMode(display=False) as fc:
        y = SS.ssd_scan(x, la, bm, bm)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert fc.get_total_flops() == SS.ssd_flops(96, 2, 4, 256, 64, 128)
    assert (FA.flash_fwd.launches, FA.flash_bwd_dq.launches,
            FA.flash_bwd_dkv.launches, SS.ssd_scan.launches) == n
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_fwd(*(torch.empty(2, 64, 80, device="meta",
                                   dtype=torch.bfloat16),) * 3, scale=1.0)
    with pytest.raises(ValueError, match="meta tensors only"):
        meta.launch("flash_fwd", (torch.empty(1),), 1)


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen3_moe_30b_a3b",
                                  "recurrentgemma_2b", "mamba2_780m",
                                  "phi3_vision_4_2b"])
def test_an_empty_tile_of_rows_launches_no_kernel(monkeypatch, arch):
    """A rank whose tile of the batch's rows is empty (the batch over
    ``model`` in padded tiles) runs every block kind at ``[0, S, D]``: on
    meta tensors with the kernels selected (flash, and ``ssd_scan`` in
    the prefill) a train step's forward and backward and a prefill
    launch none, where one row launches them; on the CPU the loss and
    every gradient are finite (the loss 0), the logits and cache have no
    row."""
    from repro_torch.kernels import meta
    from repro_torch.models import transformer as T
    from repro_torch.train import step as ST
    from repro_torch.train.optim import OptConfig

    launched = []
    real = meta.launch
    monkeypatch.setattr(meta, "launch", lambda k, ops, fl: (
        launched.append(k), real(k, ops, fl)))
    # head_dim 64: the flash kernels' smallest
    cfg = reduced(PC.get_config(arch)).with_(dtype="float32",
                                             param_dtype="float32",
                                             head_dim=64)
    S = 16

    def batch(rows, device):
        L = S + cfg.ext_embed_len
        b = {"tokens": torch.zeros(rows, S, dtype=torch.long, device=device),
             "labels": torch.zeros(rows, L, dtype=torch.long, device=device)}
        if cfg.ext_embed_len:
            b["ext_embed"] = torch.zeros(rows, cfg.ext_embed_len,
                                         cfg.d_model, device=device)
        return b

    def run(rows, device):
        kcfg = cfg.with_(attn_impl="flash")
        params = ({k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                   for k, v in T.param_shapes(cfg).items()}
                  if device == "meta" else
                  T.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
        step = ST.make_train_step(kcfg, OptConfig())
        loss, _, grads = step.grads(params, batch(rows, device))
        inputs = {k: v for k, v in batch(rows, device).items()
                  if k != "labels"}
        with torch.inference_mode():
            logits, cache, _ = T.forward(params, inputs,
                                         kcfg.with_(ssd_impl="kernel"),
                                         mode="prefill")
        return loss, grads, logits, cache

    run(1, "meta")
    assert launched
    launched.clear()
    run(0, "meta")
    assert not launched
    loss, grads, logits, cache = run(0, "cpu")
    assert float(loss) == 0.0
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert logits.shape[0] == 0
    assert all(v.shape[1] == 0 for k, v in cache.items()
               if k.startswith("s") and not k.endswith("slot_pos"))
