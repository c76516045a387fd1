"""The port's model stack on the CPU — configs, layers, the SSD mixer, the
decoder stack, the serving steps and the continuous batcher — held against
the JAX package on the same inputs.

Inputs come from numpy with fixed seeds; parameters are the reference's
own ``init_params(cfg, PRNGKey(0))``, carried across with
``params_from_numpy`` (the two frameworks' generators give different
numbers).  Configs are the reduced ones of ``tests/test_models.py`` in
f32.  The port runs at ``device="cpu"``, where every kernel wrapper takes
its plain version; the Pallas kernels of the reference run in interpret
mode.  ``tests/test_torch_cuda.py`` holds the CUDA kernels against their
plain versions on a card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.kernels import ref as REF
from repro.kernels.flash_attn import _flash_fwd as ref_flash_fwd
from repro.kernels.ssd_scan import ssd_scan as ref_ssd_scan
from repro.models import layers as RL
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro.serving.batcher import ContinuousBatcher as RefBatcher
from repro.serving.batcher import Request as RefRequest
from repro.train import serve as RSRV
from repro_torch import configs as PC
from repro_torch.convert import (cache_from_numpy, cache_to_numpy,
                                 params_from_numpy, tensor_from_numpy)
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attn import (check_kernel_operands,
                                            flash_attention, flash_fwd,
                                            flash_fwd_plain)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models import layers as PL
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT
from repro_torch.serving import ContinuousBatcher, Request
from repro_torch.train import serve as PSRV
from test_models import reduced

F32 = dict(dtype="float32", param_dtype="float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _cfgs(arch, **kw):
    """The reduced config of ``arch`` in f32, as the reference's and the
    port's ModelConfig."""
    ref = reduced(RC.get_config(arch)).with_(**F32, **kw)
    fields = {f.name: getattr(ref, f.name)
              for f in dataclasses.fields(ref)}
    return ref, PC.get_config(arch).with_(**fields)


def _params(cfg_r, cfg_p, seed=0):
    pr = RT.init_params(cfg_r, jax.random.PRNGKey(seed))
    return pr, params_from_numpy(cfg_p, {k: np.asarray(v) for k, v in
                                         pr.items()}, "cpu")


# --------------------------------------------------------------- kernels


@pytest.mark.parametrize("shape", [(2, 256, 64, 0, 128, 128),
                                   (1, 512, 128, 256, 256, 128),
                                   (2, 256, 64, 64, 128, 64),
                                   (1, 200, 64, 0, 200, 200)])
def test_flash_fwd_plain_vs_reference_interpret(shape):
    """flash_fwd_plain == repro.kernels.flash_attn._flash_fwd (interpret
    mode), O and LSE, within the reference test's 3e-5."""
    BH, S, hd, window, bq, bk = shape
    rng = np.random.default_rng(S + window)
    q, k, v = (rng.standard_normal((BH, S, hd)).astype(np.float32)
               for _ in range(3))
    scale = 1.0 / np.sqrt(hd)
    o_r, lse_r = ref_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               scale=scale, window=window, bq=bq, bk=bk,
                               interpret=True)
    o_p, lse_p = flash_fwd_plain(_t(q), _t(k), _t(v), scale=scale,
                                 window=window)
    _close(o_p, o_r, 3e-5, "O")
    _close(lse_p, lse_r, 3e-5, "LSE")
    # the wrapper on CPU tensors is the plain version
    o_w, lse_w = flash_fwd(_t(q), _t(k), _t(v), scale=scale, window=window)
    assert torch.equal(o_w, o_p) and torch.equal(lse_w, lse_p)
    assert torch.equal(flash_attention(_t(q), _t(k), _t(v), scale, window,
                                       bq, bk), o_p)


def test_flash_plain_keeps_bf16_and_computes_in_f32():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, 64))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    o, lse = flash_fwd_plain(q, k, v, scale=0.125, window=16)
    o32, lse32 = flash_fwd_plain(q.float(), k.float(), v.float(), scale=0.125,
                                 window=16)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(o, o32.bfloat16()) and torch.equal(lse, lse32)


def test_flash_refusals():
    x = torch.zeros(2, 200, 64)
    with pytest.raises(ValueError, match="multiple of the block sizes"):
        flash_attention(x, x, x, 0.125, 0, 128, 128)
    with pytest.raises(ValueError, match="shapes differ"):
        flash_fwd(x, x, torch.zeros(2, 200, 32), scale=1.0)
    with pytest.raises(TypeError, match="types differ"):
        flash_fwd(x, x, x.double(), scale=1.0)
    with pytest.raises(ValueError, match=r"\[BH, S, hd\]"):
        flash_fwd(x[0], x[0], x[0], scale=1.0)


@pytest.mark.parametrize("hd", [16, 32, 96, 256])
def test_flash_kernel_refuses_other_head_dims_before_launch(hd):
    """The CUDA route's operand check, run before any launch: a head_dim
    outside {64, 128} raises ValueError naming it."""
    x = torch.zeros(2, 64, hd)
    with pytest.raises(ValueError, match=f"not {hd}"):
        check_kernel_operands(x, x, x)


def test_flash_kernel_operand_check_takes_64_128_f32_bf16():
    for hd in (64, 128):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.zeros(1, 8, hd, dtype=dt)
            check_kernel_operands(x, x, x)
    x = torch.zeros(1, 8, 64, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        check_kernel_operands(x, x, x)


@pytest.mark.parametrize("shape", [(1, 2, 128, 64, 64), (2, 4, 128, 64, 128),
                                   (3, 1, 256, 32, 128), (2, 3, 200, 64, 128)])
def test_ssd_scan_plain_vs_reference(shape):
    """ssd_scan_plain == repro.kernels.ssd_scan.ssd_scan (interpret mode)
    and repro.kernels.ref.ssd_scan_ref, within the reference's 3e-4."""
    BH, nc, Q, hd, ds = shape
    rng = np.random.default_rng(Q + ds)
    x = rng.standard_normal((BH, nc, Q, hd)).astype(np.float32)
    la = (-np.abs(rng.standard_normal((BH, nc, Q))) * 0.2).astype(np.float32)
    Bm = (rng.standard_normal((BH, nc, Q, ds)) * 0.2).astype(np.float32)
    Cm = (rng.standard_normal((BH, nc, Q, ds)) * 0.2).astype(np.float32)
    y = ssd_scan_plain(_t(x), _t(la), _t(Bm), _t(Cm))
    y_k = ref_ssd_scan(jnp.asarray(x), jnp.asarray(la), jnp.asarray(Bm),
                       jnp.asarray(Cm), interpret=True)
    _close(y, y_k, 3e-4, "vs the reference kernel in interpret mode")
    _close(y, REF.ssd_scan_ref(x, la, Bm, Cm), 3e-4, "vs ssd_scan_ref")
    assert torch.equal(ssd_scan(_t(x), _t(la), _t(Bm), _t(Cm)), y)
    assert torch.equal(ops.ssd_scan_op(x, la, Bm, Cm, device="cpu"), y)


def test_ssd_scan_refusals():
    x = torch.zeros(2, 1, 8, 4)
    with pytest.raises(ValueError, match="la must be"):
        ssd_scan(x, torch.zeros(2, 1, 9), torch.zeros(2, 1, 8, 4),
                 torch.zeros(2, 1, 8, 4))
    with pytest.raises(ValueError, match="Bm, Cm must be"):
        ssd_scan(x, torch.zeros(2, 1, 8), torch.zeros(2, 1, 8, 4),
                 torch.zeros(2, 1, 8, 5))
    with pytest.raises(ValueError, match="Bm, Cm must be"):  # groups differ
        ssd_scan(x, torch.zeros(2, 1, 8), torch.zeros(1, 1, 8, 4),
                 torch.zeros(2, 1, 8, 4))


# ---------------------------------------------------------------- layers


def test_rmsnorm_and_rope_vs_reference():
    """rmsnorm and apply_rope == repro.models.layers', within 1e-6."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    _close(PL.rmsnorm(_t(x), _t(scale), 1e-5),
           RL.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-5), 1e-6)
    for pos in (np.arange(12, dtype=np.int32)[None],
                rng.integers(0, 5000, (2, 12)).astype(np.int32)):
        _close(PL.apply_rope(_t(x), _t(pos), 1e4),
               RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), 1e-6,
               "apply_rope")
    np.testing.assert_array_equal(PL.rope_freqs(16, 5e5),
                                  RL.rope_freqs(16, 5e5))


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_vs_reference(gated):
    """mlp (SwiGLU, and the ungated tanh-gelu) == repro.models.layers.mlp,
    within 1e-6."""
    cfg_r, _ = _cfgs("smollm_360m", mlp_gated=gated)
    p = RL.init_from_specs(RL.mlp_specs(cfg_r), jax.random.PRNGKey(1),
                           jnp.float32)
    x = np.random.default_rng(6).standard_normal((2, 8, 64)).astype(np.float32)
    want = RL.mlp(p, jnp.asarray(x), cfg_r)
    got = PL.mlp({k: _t(np.asarray(v)) for k, v in p.items()}, _t(x), cfg_r)
    _close(got, want, 1e-6)


def _attn_params(cfg_r):
    p = RL.init_from_specs(RL.attn_specs(cfg_r), jax.random.PRNGKey(2),
                           jnp.float32)
    return p, {k: _t(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("impl", ["naive", "fused", "flash"])
def test_attention_seq_kv_vs_reference(impl, window):
    """attention_seq_kv == repro.models.layers.attention_seq_kv, output and
    the pre-repeat KV, GQA group 2, within 5e-5."""
    cfg_r, cfg_p = _cfgs("smollm_360m", attn_impl=impl)
    assert cfg_r.group_size == 2
    pr, pp = _attn_params(cfg_r)
    x = np.random.default_rng(7).standard_normal((2, 32, 64)).astype(np.float32)
    y_r, (k_r, v_r) = RL.attention_seq_kv(pr, jnp.asarray(x), cfg_r,
                                          window=window)
    y_p, (k_p, v_p) = PL.attention_seq_kv(pp, _t(x), cfg_p, window=window)
    _close(y_p, y_r, 5e-5, "out")
    _close(k_p, k_r, 5e-5, "k")
    _close(v_p, v_r, 5e-5, "v")


def test_attention_seq_chunking_and_softcap():
    """naive with four q chunks and a logit softcap == the reference; flash
    ignores the softcap, as the reference's flash branch does."""
    cfg_r, cfg_p = _cfgs("smollm_360m", q_chunk=8, attn_logit_softcap=5.0)
    pr, pp = _attn_params(cfg_r)
    x = np.random.default_rng(8).standard_normal((1, 32, 64)).astype(np.float32)
    _close(PL.attention_seq(pp, _t(x), cfg_p),
           RL.attention_seq(pr, jnp.asarray(x), cfg_r), 5e-5)
    fl_r = RL.attention_seq(pr, jnp.asarray(x), cfg_r.with_(attn_impl="flash"))
    fl_p = PL.attention_seq(pp, _t(x), cfg_p.with_(attn_impl="flash"))
    nocap = PL.attention_seq(pp, _t(x), cfg_p.with_(attn_logit_softcap=0.0))
    _close(fl_p, fl_r, 5e-5)
    _close(fl_p, nocap, 5e-5)
    with pytest.raises(ValueError, match="multiple of the q chunk"):
        PL.attention_seq(pp, _t(x[:, :30]), cfg_p)


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("per_slot", [False, True])
def test_attention_decode_vs_reference(per_slot, window):
    """attention_decode == repro.models.layers.attention_decode in both
    cache layouts (shared slot_pos with a scalar pos; per-slot with a [B]
    pos vector, rows at different positions, one past the ring's end),
    output and cache, within 5e-5."""
    cfg_r, cfg_p = _cfgs("smollm_360m")
    pr, pp = _attn_params(cfg_r)
    rng = np.random.default_rng(9 + per_slot)
    B, W = 3, 12
    kc = rng.standard_normal((B, W, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((B, W, 2, 16)).astype(np.float32)
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    if per_slot:
        pos = np.array([3, 11, 14], np.int32)
        sp = np.stack([np.where(np.arange(W) < p, np.arange(W), -1)
                       if p < W else (np.arange(W) + W * (np.arange(W) < p - W))
                       for p in pos]).astype(np.int32)
        pos_r = jnp.asarray(pos)
    else:
        pos = np.int32(7)
        sp = np.where(np.arange(W) < 7, np.arange(W), -1).astype(np.int32)
        pos_r = jnp.int32(7)
    cache = {"k": kc, "v": vc, "slot_pos": sp}
    y_r, c_r = RL.attention_decode(pr, jnp.asarray(x), cfg_r,
                                   {k: jnp.asarray(v) for k, v in cache.items()},
                                   pos_r, window=window)
    c_p = cache_from_numpy(cache, "cpu")
    y_p, c_p2 = PL.attention_decode(pp, _t(x), cfg_p, c_p,
                                    _t(pos) if per_slot else int(pos),
                                    window=window)
    assert c_p2 is c_p                     # updated in place
    _close(y_p, y_r, 5e-5, "out")
    for k in cache:
        _close(c_p[k], c_r[k], 5e-5, k)


def _ssd_params(cfg_r):
    p = RL.init_from_specs(RS.ssd_specs(cfg_r), jax.random.PRNGKey(3),
                           jnp.float32)
    # A_log, D_skip and dt_bias start as ones/zeros/normal by the rule;
    # spread them so the decays differ per head
    rng = np.random.default_rng(10)
    nh = cfg_r.ssm_heads
    p = dict(p, A_log=jnp.asarray(rng.uniform(-1, 1, nh).astype(np.float32)),
             D_skip=jnp.asarray(rng.standard_normal(nh).astype(np.float32)),
             dt_bias=jnp.asarray(rng.uniform(-2, 1, nh).astype(np.float32)))
    return p, {k: _t(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("want_cache", [False, True])
@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("S", [32, 5])
def test_ssd_seq_cached_vs_reference(impl, want_cache, S):
    """ssd_seq_cached == repro.models.ssm.ssd_seq_cached (both branches,
    with and without the cache; S = 32 in chunks of 8, and S = 5, one
    chunk shorter than the conv), within 2e-4."""
    cfg_r, cfg_p = _cfgs("mamba2_780m", ssd_impl=impl)
    pr, pp = _ssd_params(cfg_r)
    x = np.random.default_rng(11).standard_normal((2, S, 64)).astype(np.float32)
    y_r, c_r = RS.ssd_seq_cached(pr, jnp.asarray(x), cfg_r,
                                 want_cache=want_cache)
    y_p, c_p = PS.ssd_seq_cached(pp, _t(x), cfg_p, want_cache=want_cache)
    _close(y_p, y_r, 2e-4, "out")
    assert (c_p is None) == (c_r is None)
    if want_cache:
        assert set(c_p) == set(c_r)
        for k in c_r:
            _close(c_p[k], c_r[k], 2e-4, k)


def test_ssd_seq_rejects_a_ragged_chunk():
    _, cfg_p = _cfgs("mamba2_780m")
    _, pp = _ssd_params(_cfgs("mamba2_780m")[0])
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        PS.ssd_seq(pp, torch.zeros(1, 12, 64), cfg_p)


def test_ssd_decode_vs_reference():
    """ssd_decode == repro.models.ssm.ssd_decode over 3 steps, output and
    cache, within 2e-4."""
    cfg_r, cfg_p = _cfgs("mamba2_780m")
    pr, pp = _ssd_params(cfg_r)
    rng = np.random.default_rng(12)
    nh, hd, ds = cfg_r.ssm_heads, cfg_r.ssm_head_dim, cfg_r.ssm_state
    cache = {"state": (rng.standard_normal((2, nh, hd, ds)) * 0.1)
             .astype(np.float32),
             "conv": rng.standard_normal((2, 3, cfg_r.d_inner + 2 * ds))
             .astype(np.float32)}
    c_r = {k: jnp.asarray(v) for k, v in cache.items()}
    c_p = cache_from_numpy(cache, "cpu")
    for step in range(3):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        y_r, c_r = RS.ssd_decode(pr, jnp.asarray(x), cfg_r, c_r)
        y_p, c_p = PS.ssd_decode(pp, _t(x), cfg_p, c_p)
        _close(y_p, y_r, 2e-4, f"step {step}")
    for k in cache:
        _close(c_p[k], c_r[k], 2e-4, k)


# ----------------------------------------------------------------- stack

STACKS = [("smollm_360m", {"attn_impl": "naive"}),
          ("smollm_360m", {"attn_impl": "flash"}),
          ("mamba2_780m", {"ssd_impl": "xla"}),
          ("mamba2_780m", {"ssd_impl": "kernel"})]


@pytest.mark.parametrize("arch,kw", STACKS)
def test_forward_train_prefill_decode_vs_reference(arch, kw):
    """transformer.forward == repro.models.transformer.forward in train,
    prefill and decode modes: logits and every cache entry within 2e-4;
    decode runs 3 steps from a padded prefill cache (shared layout)."""
    cfg_r, cfg_p = _cfgs(arch, **kw)
    pr, pp = _params(cfg_r, cfg_p)
    toks = np.random.default_rng(13).integers(0, 512, (2, 19)).astype(np.int32)
    l_r, _, _ = RT.forward(pr, {"tokens": jnp.asarray(toks[:, :16])}, cfg_r)
    l_p, c_none, aux = PT.forward(pp, {"tokens": _t(toks[:, :16])}, cfg_p)
    _close(l_p, l_r, 2e-4, "train logits")
    assert c_none is None and l_p.dtype == torch.float32 and float(aux) == 0
    l_r, c_r, _ = RT.forward(pr, {"tokens": jnp.asarray(toks[:, :16])}, cfg_r,
                             mode="prefill")
    l_p, c_p, _ = PT.forward(pp, {"tokens": _t(toks[:, :16])}, cfg_p,
                             mode="prefill")
    _close(l_p, l_r, 2e-4, "prefill logits")
    assert set(c_p) == set(c_r)
    for k in c_r:
        _close(c_p[k], c_r[k], 2e-4, f"prefill cache {k}")
    c_r = RSRV.pad_cache_to(c_r, RT.cache_shapes(cfg_r, 2, 24))
    c_p = PSRV.pad_cache_to(c_p, PT.cache_shapes(cfg_p, 2, 24))
    for t in range(16, 19):
        l_r, c_r, _ = RT.forward(pr, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                 cfg_r, mode="decode", cache=c_r,
                                 pos=jnp.int32(t))
        l_p, c_p, _ = PT.forward(pp, {"tokens": _t(toks[:, t:t + 1])}, cfg_p,
                                 mode="decode", cache=c_p, pos=t)
        _close(l_p, l_r, 2e-4, f"decode logits at {t}")
    for k in c_r:
        _close(c_p[k], c_r[k], 2e-4, f"decode cache {k}")


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "qwen1_5_4b", "minicpm_2b",
                                  "musicgen_large", "phi3_vision_4_2b"])
def test_forward_other_dense_archs_vs_reference(arch):
    """The other attention-only architectures (GQA, QKV bias, tied
    embeddings, the ungated gelu MLP, external embeddings prepended) in
    train mode == the reference within 2e-4."""
    cfg_r, cfg_p = _cfgs(arch)
    pr, pp = _params(cfg_r, cfg_p)
    rng = np.random.default_rng(14)
    n_ext = cfg_r.ext_embed_len
    toks = rng.integers(0, 512, (2, 16 - n_ext)).astype(np.int32)
    inp = {"tokens": toks}
    if n_ext:
        inp["ext_embed"] = rng.standard_normal((2, n_ext, 64)).astype(np.float32)
    l_r, _, _ = RT.forward(pr, {k: jnp.asarray(v) for k, v in inp.items()},
                           cfg_r)
    l_p, _, _ = PT.forward(pp, {k: _t(v) for k, v in inp.items()}, cfg_p)
    assert l_p.shape == (2, 16, 512)
    _close(l_p, l_r, 2e-4)


def test_per_slot_decode_vs_reference():
    """Decode over a per-slot cache with a [B] position vector (rows at
    positions 0, 5 and 9) == the reference, 3 steps, within 2e-4."""
    cfg_r, cfg_p = _cfgs("smollm_360m")
    pr, pp = _params(cfg_r, cfg_p)
    rng = np.random.default_rng(15)
    c_r = RT.init_cache(cfg_r, 3, 16, per_slot=True)
    shapes = RT.cache_shapes(cfg_r, 3, 16, per_slot=True)
    c_np = {k: rng.standard_normal(s.shape).astype(np.float32)
            for k, s in shapes.items() if not k.endswith("slot_pos")}
    pos = np.array([0, 5, 9], np.int32)
    sp = np.stack([np.where(np.arange(16) < p, np.arange(16), -1)
                   for p in pos]).astype(np.int32)
    c_np["s0_slot_pos"] = np.broadcast_to(sp, shapes["s0_slot_pos"].shape).copy()
    c_r = {k: jnp.asarray(v) for k, v in c_np.items()}
    c_p = cache_from_numpy(c_np, "cpu")
    for step in range(3):
        t = rng.integers(0, 512, (3, 1)).astype(np.int32)
        l_r, c_r, _ = RT.forward(pr, {"tokens": jnp.asarray(t)}, cfg_r,
                                 mode="decode", cache=c_r,
                                 pos=jnp.asarray(pos + step))
        l_p, c_p, _ = PT.forward(pp, {"tokens": _t(t)}, cfg_p, mode="decode",
                                 cache=c_p, pos=_t(pos + step))
        _close(l_p, l_r, 2e-4, f"step {step}")
    for k in c_r:
        _close(c_p[k], c_r[k], 2e-4, k)


def test_cache_specs_and_init_cache_match_reference():
    for arch in ("smollm_360m", "mamba2_780m"):
        cfg_r, cfg_p = _cfgs(arch)
        for per_slot in (False, True):
            sr = RT.cache_shapes(cfg_r, 3, 20, per_slot=per_slot)
            sp = PT.cache_shapes(cfg_p, 3, 20, per_slot=per_slot)
            assert {k: tuple(v.shape) for k, v in sr.items()} == \
                {k: tuple(v.shape) for k, v in sp.items()}
            c_r = RT.init_cache(cfg_r, 3, 20, per_slot=per_slot)
            c_p = cache_to_numpy(PT.init_cache(cfg_p, 3, 20,
                                               per_slot=per_slot,
                                               device="cpu"))
            for k in c_r:
                np.testing.assert_array_equal(c_p[k], np.asarray(c_r[k]))
        assert PT.param_specs(cfg_p) == RT.param_specs(cfg_r)


def test_init_params_follows_the_reference_rule():
    cfg_r, cfg_p = _cfgs("mamba2_780m")
    g = torch.Generator().manual_seed(0)
    p = PT.init_params(cfg_p, g, device="cpu")
    r = RT.init_params(cfg_r, jax.random.PRNGKey(0))
    assert set(p) == set(r)
    for k in p:
        assert tuple(p[k].shape) == r[k].shape and p[k].dtype == torch.float32
        if k.endswith("_scale") or k.endswith("norm"):
            assert bool((p[k] == 1).all())
        elif k.endswith("_bias") or k.endswith("_b"):
            assert bool((p[k] == 0).all())
        else:   # the same spread: min(0.02, 1/sqrt(fan_in))
            assert 0.5 < float(p[k].std()) / float(np.asarray(r[k]).std()) < 2


def test_params_from_numpy_keeps_bf16_bits():
    cfg_r = reduced(RC.get_config("smollm_360m"))
    cfg_p = PC.get_config("smollm_360m").with_(
        **{f.name: getattr(cfg_r, f.name) for f in dataclasses.fields(cfg_r)})
    pr = {k: np.asarray(v) for k, v in
          RT.init_params(cfg_r, jax.random.PRNGKey(0)).items()}
    pp = params_from_numpy(cfg_p, pr, "cpu")
    for k, v in pr.items():
        assert pp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(pp[k].view(torch.int16).numpy(),
                                      v.view(np.int16))
    assert tensor_from_numpy(np.arange(3, dtype=np.int32), "cpu").dtype \
        == torch.int32
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy(cfg_p, {k: v for k, v in pr.items()
                                  if k != "final_scale"}, "cpu")


# ------------------------------------------------- serve steps, batcher


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("arch", ["smollm_360m", "mamba2_780m"])
def test_pad_cache_to_bit_equal_to_reference(arch, per_slot):
    cfg_r, cfg_p = _cfgs(arch)
    pr, _ = _params(cfg_r, cfg_p)
    toks = np.random.default_rng(16).integers(0, 512, (1, 8)).astype(np.int32)
    c_r, _ = RSRV.make_prefill_step(cfg_r)(pr, {"tokens": jnp.asarray(toks)})
    c_p = cache_from_numpy({k: np.asarray(v) for k, v in c_r.items()}, "cpu")
    want = RSRV.pad_cache_to(c_r, RT.cache_shapes(cfg_r, 1, 20,
                                                  per_slot=per_slot))
    got = cache_to_numpy(PSRV.pad_cache_to(
        c_p, PT.cache_shapes(cfg_p, 1, 20, per_slot=per_slot)))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def _serve(batcher_cls, request_cls, prefill, argmax, cfg, params, prompts,
           max_new, **kw):
    """Admit requests into free slots (prefill, greedy first token,
    install) and tick until all have finished, as the reference's
    ``Server`` does; returns each request's tokens."""
    b = batcher_cls(cfg, params, 2, 32, **kw)
    reqs = [request_cls(i, p, max_new) for i, p in enumerate(prompts)]
    waiting, done = list(reqs), []
    while len(done) < len(reqs):
        while waiting and b.free_slots():
            req = waiting.pop(0)
            cache1, last = prefill(params, {"tokens": req.prompt[None]})
            b.install(b.free_slots()[0], cache1, len(req.prompt),
                      argmax(last), req)
        _, fin = b.tick()
        done += fin
    return [r.out for r in reqs]


@pytest.mark.parametrize("arch,kw", STACKS)
def test_continuous_batcher_tokens_equal_reference(arch, kw):
    """Three requests (prompts of 8, 16 and 5 tokens, max_new 6) through 2
    slots, so the third is admitted mid-wave: the port's ContinuousBatcher
    gives the reference's token lists."""
    cfg_r, cfg_p = _cfgs(arch, **kw)
    pr, pp = _params(cfg_r, cfg_p)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (8, 16, 5)]
    want = _serve(RefBatcher, RefRequest, RSRV.jit_prefill_step(cfg_r),
                  lambda last: int(jnp.argmax(last[0, -1])), cfg_r, pr,
                  prompts, 6)
    got = _serve(ContinuousBatcher, Request, PSRV.jit_prefill_step(cfg_p),
                 lambda last: int(torch.argmax(last[0, -1])), cfg_p, pp,
                 prompts, 6, device="cpu")
    assert got == want
    assert all(len(o) == 6 for o in got)


def test_batcher_refusals_and_greedy_token():
    cfg_r, cfg_p = _cfgs("smollm_360m")
    _, pp = _params(cfg_r, cfg_p)
    b = ContinuousBatcher(cfg_p, pp, 2, 16, device="cpu")
    assert b.tick() == (0, [])
    cache1, last = PSRV.make_prefill_step(cfg_p)(
        pp, {"tokens": torch.arange(4)[None]})
    b.install(0, cache1, 4, 7, Request(0, np.arange(4), 3))
    with pytest.raises(ValueError, match="already active"):
        b.install(0, cache1, 4, 7, Request(1, np.arange(4), 3))
    with pytest.raises(ValueError, match="outside cache width"):
        b.install(1, cache1, 17, 7, Request(1, np.arange(4), 3))
    assert b.free_slots() == [1]
    tok = PSRV.greedy_token(last)
    assert tok.shape == (1, 1) and tok.dtype == torch.int32
    assert int(tok) == int(torch.argmax(last[0, -1]))


# ---------------------------------------------------------------- configs


def test_configs_match_reference():
    assert PC.ARCH_IDS == RC.ARCH_IDS and PC._ALIASES == RC._ALIASES
    assert {k: dataclasses.astuple(v) for k, v in PC.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in RC.SHAPES.items()}
    for arch in RC.ARCH_IDS:
        for name in (arch, arch.replace("_", "-")):
            c_p, c_r = PC.get_config(name), RC.get_config(name)
            assert dataclasses.asdict(c_p) == dataclasses.asdict(c_r)
            assert c_p.param_counts() == c_r.param_counts()
            for sh in PC.SHAPES:
                assert PC.applicable(c_p, sh)[0] == RC.applicable(c_r, sh)[0]
    with pytest.raises(KeyError, match="unknown arch"):
        PC.get_config("gpt-5")


def test_config_dtypes():
    cfg = PC.get_config("smollm_360m")
    assert cfg.act_dtype == cfg.w_dtype == torch.bfloat16
    assert cfg.with_(**F32).act_dtype == torch.float32
    with pytest.raises(ValueError, match="unknown dtype"):
        cfg.with_(dtype="int4").act_dtype


# --------------------------------------------------------------- refusals


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    cfg = reduced(PC.get_config("smollm_360m"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PT.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PT.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatcher(cfg, {}, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.ssd_scan_op(np.zeros((1, 1, 2, 2)), np.zeros((1, 1, 2)),
                        np.zeros((1, 1, 2, 2)), np.zeros((1, 1, 2, 2)))


@pytest.mark.parametrize("arch,kind", [("qwen3_moe_30b_a3b", "attn_moe"),
                                       ("llama4_maverick_400b_a17b", "attn_moe"),
                                       ("recurrentgemma_2b", "rglru")])
def test_moe_and_rglru_blocks_are_not_ported_yet(arch, kind):
    cfg = reduced(PC.get_config(arch))
    with pytest.raises(NotImplementedError, match=kind):
        PT.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        PT.block_fwd(kind, cfg, {}, torch.zeros(1, 4, 64), mode="train")


def test_unknown_impls_and_modes_raise():
    cfg_r, cfg_p = _cfgs("smollm_360m")
    _, pp = _params(cfg_r, cfg_p)
    toks = torch.zeros(1, 16, dtype=torch.long)
    with pytest.raises(ValueError, match="unknown attn_impl"):
        PT.forward(pp, {"tokens": toks}, cfg_p.with_(attn_impl="pallas"))
    with pytest.raises(ValueError, match="unknown mode"):
        PT.forward(pp, {"tokens": toks}, cfg_p, mode="sample")
    with pytest.raises(ValueError, match="needs a cache"):
        PT.forward(pp, {"tokens": toks[:, :1]}, cfg_p, mode="decode", pos=0)
