"""The dry run's policy tokens and the configs' input specs, the port's
against the reference's: the six cases of ``tests/test_policies.py`` on
``repro_torch.launch.dryrun``; ``apply_policy`` and ``opt_for`` equal to
the reference's for every token on every (arch, shape); ``input_specs``
and ``batch_axes`` equal for all 40 (arch, shape) pairs.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when it is
imported; the fixture imports it and puts ``os.environ`` back (jax is
already initialised with one device by ``tests/conftest.py``).
"""

import dataclasses
import os

import pytest

from repro import configs as RC
from repro_torch import configs as PC
from repro_torch.launch.dryrun import apply_policy, opt_for

TOKENS = ("baseline", "", "fused", "flash", "ssdk", "msp", "resident",
          "dp_all", "serve_tp", "cache_heads", "dp_fsdp", "attn_dp", "dots",
          "noremat", "mb2", "mb4", "qc512", "statebf16")
COMBOS = ("flash+attn_dp+mb2", "flash+statebf16", "resident+msp+dots",
          "dp_fsdp+noremat+mb4", "serve_tp+cache_heads")


@pytest.fixture(scope="module")
def ref_dryrun():
    before = dict(os.environ)
    try:
        from repro.launch import dryrun
    finally:
        os.environ.clear()
        os.environ.update(before)
    return dryrun


# ---------------------------------------------- tests/test_policies.py's six


def test_tokens_compose():
    cfg0 = PC.get_config("qwen3_moe_30b_a3b")
    cfg, rules, mb = apply_policy(cfg0, "train_4k", "flash+attn_dp+mb2")
    assert cfg.attn_impl == "fused"            # the reference's stand-in
    assert rules.get("heads") == ()            # attention DP
    assert "model" in rules.get("batch")
    assert mb == 2


def test_resident_sets_expert_rules():
    cfg0 = PC.get_config("llama4_maverick_400b_a17b")
    cfg, rules, _ = apply_policy(cfg0, "train_4k", "resident")
    assert cfg.moe_expert_resident
    assert rules.get("expert_ffn") == ("data",)


def test_long_decode_unshards_batch():
    cfg0 = PC.get_config("mamba2_780m")
    _, rules, _ = apply_policy(cfg0, "long_500k", "baseline")
    assert rules.get("batch") == ()
    assert rules.get("cache_batch") == ()


def test_unknown_token_raises():
    cfg0 = PC.get_config("smollm_360m")
    with pytest.raises(KeyError):
        apply_policy(cfg0, "train_4k", "flash+bogus")


def test_opt_for_statebf16_and_wsd():
    assert opt_for("minicpm_2b").schedule == "wsd"
    assert opt_for("llama4_maverick_400b_a17b").state_dtype == "bfloat16"
    assert opt_for("smollm_360m", "flash+statebf16").state_dtype == "bfloat16"


def test_kernel_byte_models_beat_xla_floor():
    from repro_torch.kernels.flash_attn import flash_hbm_bytes
    from repro_torch.kernels.ssd_scan import ssd_hbm_bytes

    # one f32 materialization of the scores is already worse than the kernel
    assert flash_hbm_bytes(1, 15, 4096, 64, train=False) < 15 * 4096 * 4096 * 4
    # SSD kernel traffic is linear in S (vs quadratic-in-Q chunk tensors)
    b1 = ssd_hbm_bytes(1, 48, 4096, 64, 128, train=True)
    b2 = ssd_hbm_bytes(1, 48, 8192, 64, 128, train=True)
    assert 1.8 < b2 / b1 < 2.2


# ------------------------------------------------- against the reference


def _fields(dc) -> dict:
    return {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)}


@pytest.mark.parametrize("arch", PC.ARCH_IDS)
def test_apply_policy_and_opt_for_match_reference(ref_dryrun, arch):
    for shape in PC.SHAPES:
        for policy in TOKENS + COMBOS:
            c_p, r_p, mb_p = apply_policy(PC.get_config(arch), shape, policy)
            c_r, r_r, mb_r = ref_dryrun.apply_policy(RC.get_config(arch),
                                                     shape, policy)
            assert _fields(c_p) == _fields(c_r), (shape, policy)
            assert r_p.rules == r_r.rules, (shape, policy)
            assert mb_p == mb_r, (shape, policy)
        for bad in ("bogus", "flash+bogus"):
            with pytest.raises(KeyError):
                apply_policy(PC.get_config(arch), "train_4k", bad)
            with pytest.raises(KeyError):
                ref_dryrun.apply_policy(RC.get_config(arch), "train_4k", bad)
    for policy in TOKENS + COMBOS:
        assert _fields(opt_for(arch, policy)) == \
            _fields(ref_dryrun.opt_for(arch, policy)), policy


@pytest.mark.parametrize("arch", PC.ARCH_IDS)
def test_input_specs_and_batch_axes_match_reference(arch):
    c_p, c_r = PC.get_config(arch), RC.get_config(arch)
    for shape in PC.SHAPES:
        sp, sr = PC.input_specs(c_p, shape), RC.input_specs(c_r, shape)
        assert list(sp) == list(sr), shape
        for k in sr:
            assert tuple(sp[k].shape) == tuple(sr[k].shape), (shape, k)
            assert str(sp[k].dtype).removeprefix("torch.") == \
                str(sr[k].dtype), (shape, k)
        assert PC.batch_axes(c_p, shape) == RC.batch_axes(c_r, shape), shape
