"""The port's MoE FFN and RG-LRU block on the CPU, and the whole model
stack over all ten architectures, held against the JAX package on the
same inputs.

Inputs come from numpy with fixed seeds; parameters are the reference's
own ``init_params`` (or ``init_from_specs`` for one block), carried across
with ``params_from_numpy`` / ``tensor_from_numpy``.  Configs are the
reduced ones of ``tests/test_models.py``, in f32 wherever two results
are compared, at the tolerance of ``tests/test_torch_models.py`` (2e-4);
MoE routing (expert ids, ranks, slots, drops) must match exactly.  The
reference's MoE at world size 1 is ``_moe_dense_fallback``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import rglru as RR
from repro.models import transformer as RT
from repro.train import optim as RO
from repro.train import serve as RSRV
from repro.train import step as RS
from repro_torch import configs as PC
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import moe as PM
from repro_torch.models import rglru as PR
from repro_torch.models import transformer as PT
from repro_torch.train import optim as PO
from repro_torch.train import serve as PSRV
from repro_torch.train import step as PS
from test_models import reduced

F32 = dict(dtype="float32", param_dtype="float32")
TOL = 2e-4
MOE_ARCHS = ["qwen3_moe_30b_a3b", "llama4_maverick_400b_a17b"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _cfgs(arch, **kw):
    ref = reduced(RC.get_config(arch)).with_(**F32, **kw)
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    return ref, PC.get_config(arch).with_(**fields)


def _block_params(specs, seed, perturb=()):
    """The reference's ``init_from_specs`` for one block, as numpy, with
    the named leaves replaced by seeded normals (zeros and ones would
    leave a gate untested); -> (reference dict, port dict)."""
    pr = {k: np.asarray(v) for k, v in RL.init_from_specs(
        specs, jax.random.PRNGKey(seed), jnp.float32).items()}
    rng = np.random.default_rng(seed)
    for k in perturb:
        pr[k] = rng.standard_normal(pr[k].shape).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in pr.items()},
            {k: tensor_from_numpy(v, "cpu") for k, v in pr.items()})


# ------------------------------------------------------------------ MoE


def test_capacity_is_the_references():
    _, cfg = _cfgs("qwen3_moe_30b_a3b")
    for t in (1, 2, 7, 32, 64, 1000):
        for cf in (0.5, 1.25, 4.0):
            c = cfg.with_(capacity_factor=cf)
            k, E = c.experts_per_token, c.num_experts
            assert PM.capacity(t, c) == max(4, int(-(-t * k * cf // E)))


@pytest.mark.parametrize("rows", ["uniform", "repeated"])
def test_router_breaks_ties_toward_the_lower_expert(rows):
    """Tied probabilities: ``jax.lax.top_k`` puts the lower expert id
    first, and so must the port.  One-hot tokens make each token's logits
    one row of the router, exactly, in both frameworks."""
    _, cfg = _cfgs("qwen3_moe_30b_a3b")
    E, D = cfg.num_experts, cfg.d_model
    if rows == "uniform":
        w = np.zeros((D, E), np.float32)
    else:
        vals = np.random.default_rng(5).standard_normal((D, 3)).astype(np.float32)
        w = vals[:, np.random.default_rng(6).integers(0, 3, E)]
    x = np.eye(D, dtype=np.float32)[:16]
    p_r, e_r, pr_r = RM._router(jnp.asarray(x), jnp.asarray(w), cfg)
    p_p, e_p, pr_p = PM._router(_t(x), _t(w), cfg)
    np.testing.assert_array_equal(e_p.numpy(), np.asarray(e_r))
    _close(p_p, p_r, 1e-6)
    _close(pr_p, pr_r, 1e-6)
    if rows == "uniform":
        assert (e_p.numpy() == np.arange(cfg.experts_per_token)).all()


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_vs_dense_fallback(arch, cf):
    """``moe_ffn`` == the reference's ``_moe_dense_fallback`` on 2 x 32
    tokens: expert ids, slots and the drop pattern exactly; capacity
    buffers, combine weights, y and the aux loss within 2e-4.  At cf 0.5
    (capacity 8 against 16 copies an expert on average) copies are
    dropped; at cf 4.0 (capacity 64) none is."""
    cfg_r, cfg_p = _cfgs(arch, capacity_factor=cf)
    p_r, p_p = _block_params(RM.moe_specs(cfg_r), 3)
    x = np.random.default_rng(7).standard_normal((2, 32, 64)).astype(np.float32)
    x_tok = x.reshape(-1, 64)
    top_p_r, top_e_r, probs_r = RM._router(jnp.asarray(x_tok), p_r["router"],
                                           cfg_r)
    top_p_p, top_e_p, probs_p = PM._router(_t(x_tok), p_p["router"], cfg_p)
    np.testing.assert_array_equal(top_e_p.numpy(), np.asarray(top_e_r))
    E, cap = cfg_p.num_experts, PM.capacity(64, cfg_p)
    buf_r, w_r, slot_r = RM._bin_tokens(jnp.asarray(x_tok), top_p_r, top_e_r,
                                        E, cap)
    buf_p, w_p, slot_p = PM._bin_tokens(_t(x_tok), top_p_p, top_e_p, E, cap)
    np.testing.assert_array_equal(slot_p.numpy(), np.asarray(slot_r))
    dropped = int((np.asarray(slot_r) == E * cap).sum())
    np.testing.assert_array_equal(_np(w_p) == 0, np.asarray(w_r) == 0)
    _close(w_p, w_r, 1e-6, "combine weights")
    _close(buf_p, buf_r, 1e-6, "capacity buffers")
    _close(PM._aux_loss(probs_p, top_e_p, cfg_p),
           RM._aux_loss(probs_r, top_e_r, cfg_r), 1e-6, "aux")
    y_r, aux_r = RM._moe_dense_fallback(p_r, jnp.asarray(x), cfg_r)
    y_p, aux_p = PM.moe_ffn(p_p, _t(x), cfg_p)
    _close(y_p, y_r, TOL, "y")
    _close(aux_p, aux_r, TOL, "aux")
    if cf == 0.5:
        assert dropped > 0 and dropped < 64 * cfg_p.experts_per_token
    if cf == 4.0:
        assert dropped == 0
    assert ("ws_gate" in p_p) == (arch == "llama4_maverick_400b_a17b")


def test_moe_ffn_gradients_skip_dropped_copies():
    """A dropped copy contributes nothing forward or backward: 64 equal
    tokens all routed to experts 0 and 1 (a tie broken toward 1), each
    expert holding capacity 20, so tokens 20-63 lose both copies: their y
    and their gradient are 0, the kept tokens' are not."""
    _, cfg = _cfgs("qwen3_moe_30b_a3b")
    _, p = _block_params(PM.moe_specs(cfg), 4)
    p["router"] = torch.zeros_like(p["router"])
    p["router"][0, 0] = 1.0
    x = torch.ones(1, 64, 64, requires_grad=True)
    y, _ = PM.moe_ffn(p, x, cfg)
    y.sum().backward()
    kept = PM.capacity(64, cfg)
    assert kept == 20
    assert bool((y[0, kept:] == 0).all()) and bool((y[0, :kept] != 0).all())
    g = x.grad[0].abs().sum(-1)
    assert bool((g[:kept] > 0).all()) and bool((g[kept:] == 0).all())


# --------------------------------------------------------------- RG-LRU


def _rglru_params(cfg_r, seed=8):
    return _block_params(RR.rglru_specs(cfg_r), seed,
                         perturb=("a_gate_b", "i_gate_b", "lam"))


@pytest.mark.parametrize("S", [1, 5, 33, 64])
def test_linear_scan_matches_a_loop(S):
    rng = np.random.default_rng(S)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, S, 7)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((2, S, 7)).astype(np.float32))
    h, want = torch.zeros(2, 7), []
    for t in range(S):
        h = a[:, t] * h + u[:, t]
        want.append(h)
    torch.testing.assert_close(PR.linear_scan(a, u), torch.stack(want, 1),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("want_cache", [False, True])
@pytest.mark.parametrize("S", [2, 16])
def test_rglru_seq_cached_vs_reference(S, want_cache):
    """Output, ``h`` and ``conv`` (zero-padded in front at S = 2) within
    2e-4 of the reference's associative scan."""
    cfg_r, cfg_p = _cfgs("recurrentgemma_2b")
    p_r, p_p = _rglru_params(cfg_r)
    x = np.random.default_rng(S).standard_normal((2, S, 64)).astype(np.float32)
    y_r, c_r = RR.rglru_seq_cached(p_r, jnp.asarray(x), cfg_r,
                                   want_cache=want_cache)
    y_p, c_p = PR.rglru_seq_cached(p_p, _t(x), cfg_p, want_cache=want_cache)
    _close(y_p, y_r, TOL, "out")
    if not want_cache:
        assert c_p is None and c_r is None
        return
    assert c_p["h"].dtype == torch.float32 and c_p["conv"].shape == (2, 3, 64)
    for k in ("h", "conv"):
        _close(c_p[k], c_r[k], TOL, k)
    if S == 2:
        assert bool((c_p["conv"][:, 0] == 0).all())


def test_rglru_decode_vs_reference():
    """Three decode steps from a random cache: outputs and the cache,
    which the port updates in place, within 2e-4."""
    cfg_r, cfg_p = _cfgs("recurrentgemma_2b")
    p_r, p_p = _rglru_params(cfg_r)
    rng = np.random.default_rng(9)
    cache = {"h": rng.standard_normal((2, 64)).astype(np.float32),
             "conv": rng.standard_normal((2, 3, 64)).astype(np.float32)}
    c_r = {k: jnp.asarray(v) for k, v in cache.items()}
    c_p = {k: _t(v) for k, v in cache.items()}
    h_before = c_p["h"]
    for step in range(3):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        y_r, c_r = RR.rglru_decode(p_r, jnp.asarray(x), cfg_r, c_r)
        y_p, c_p = PR.rglru_decode(p_p, _t(x), cfg_p, c_p)
        _close(y_p, y_r, TOL, f"step {step}")
    assert c_p["h"] is h_before
    for k in cache:
        _close(c_p[k], c_r[k], TOL, k)


def test_rglru_seq_then_decode_continues_the_sequence():
    """Prefill 9 positions, then decode 3 from its cache: the outputs of
    the 12-position sequence run whole."""
    _, cfg = _cfgs("recurrentgemma_2b")
    _, p = _rglru_params(_cfgs("recurrentgemma_2b")[0])
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 12, 64)).astype(np.float32))
    whole, _ = PR.rglru_seq_cached(p, x, cfg)
    y, cache = PR.rglru_seq_cached(p, x[:, :9], cfg, want_cache=True)
    outs = [y]
    for t in range(9, 12):
        y, cache = PR.rglru_decode(p, x[:, t:t + 1], cfg, cache)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), whole, rtol=1e-4,
                               atol=1e-5)


# ------------------------------------------------ whole stack, all archs


def _ref_params(cfg_r, cfg_p, seed):
    pr = RT.init_params(cfg_r, jax.random.PRNGKey(seed))
    return pr, params_from_numpy(cfg_p, {k: np.asarray(v) for k, v in
                                         pr.items()}, "cpu")


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_arch_smoke_forward_and_train(arch):
    """``tests/test_models.py::test_arch_smoke_forward_and_train`` on the
    port, in f32 with the reference's parameters: one train-mode forward
    (shape, finite, no cache) and one AdamW step through
    ``make_train_step``, whose loss, cross-entropy, aux loss and gradient
    norm are the reference's within 2e-4."""
    cfg_r, cfg_p = _cfgs(arch)
    pr, pp = _ref_params(cfg_r, cfg_p, 0)
    B, S = 2, 32
    rng = np.random.default_rng(11)
    n_ext = cfg_r.ext_embed_len
    batch = {"tokens": rng.integers(0, cfg_r.vocab_size, (B, S - n_ext))
             .astype(np.int32),
             "labels": rng.integers(0, cfg_r.vocab_size, (B, S))
             .astype(np.int32)}
    if n_ext:
        batch["ext_embed"] = rng.standard_normal(
            (B, n_ext, cfg_r.d_model)).astype(np.float32)
    inputs = {k: _t(v) for k, v in batch.items() if k != "labels"}
    logits, cache, aux = PT.forward(pp, inputs, cfg_p, mode="train")
    assert logits.shape == (B, S, cfg_p.vocab_size) and cache is None
    assert bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits"
    assert float(aux) > 0 if cfg_p.num_experts else float(aux) == 0

    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    step_r = RS.make_train_step(cfg_r, RO.OptConfig(**opt))
    step_p = PS.make_train_step(cfg_p, PO.OptConfig(**opt))
    st_r = {"params": pr, "opt": step_r.init_opt(pr),
            "step": jnp.zeros((), jnp.int32)}
    st_p = {"params": pp, "opt": step_p.init_opt(pp), "step": 0}
    _, m_r = jax.jit(step_r)(st_r, {k: jnp.asarray(v) for k, v in batch.items()})
    new, m_p = step_p(st_p, {k: _t(v) for k, v in batch.items()})
    assert m_p["step"] == int(m_r["step"]) == 1
    assert all(bool(torch.isfinite(v).all()) for v in new["params"].values())
    for k in ("loss", "ce", "aux", "grad_norm"):
        _close(m_p[k], m_r[k], TOL, k)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "qwen3_moe_30b_a3b",
                                  "mamba2_780m", "recurrentgemma_2b"])
def test_decode_matches_teacher_forcing(arch):
    """``tests/test_models.py::test_decode_matches_teacher_forcing`` on the
    port: 16 decode steps from an empty cache against the train-mode
    logits, within 0.05; each step's logits also within 2e-4 of the
    reference's decode (f32, the reference's parameters)."""
    cfg_r, cfg_p = _cfgs(arch)
    pr, pp = _ref_params(cfg_r, cfg_p, 1)
    B, S = 2, 16
    toks = np.random.default_rng(12).integers(
        0, cfg_r.vocab_size, (B, S)).astype(np.int32)
    logits, _, _ = PT.forward(pp, {"tokens": _t(toks)}, cfg_p, mode="train")
    c_p = PT.init_cache(cfg_p, B, 32, device="cpu")
    c_r = RT.init_cache(cfg_r, B, 32)
    dec = jax.jit(lambda p, t, pos, c: RT.forward(
        p, {"tokens": t}, cfg_r, mode="decode", cache=c, pos=pos))
    errs = []
    for t in range(S):
        lg, c_p, _ = PT.forward(pp, {"tokens": _t(toks[:, t:t + 1])}, cfg_p,
                                mode="decode", cache=c_p, pos=t)
        lr, c_r, _ = dec(pr, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t), c_r)
        _close(lg, lr, TOL, f"decode logits at {t}")
        errs.append(float((lg[:, 0] - logits[:, t]).abs().max()))
    assert max(errs) < 0.05, f"{arch}: decode diverges from train ({max(errs)})"


@pytest.mark.parametrize("prefill", [8, 12, 16])
def test_local_ring_after_a_prefill_past_the_window(prefill):
    """A prefill longer than ``attn_window`` keeps its last W positions in
    ring slots 0..W-1, while decode writes position p at slot p % W: the
    two agree only when the prefill length is a multiple of W (ROADMAP
    Queue 3, item 16).  Pinned: the port decodes as the reference does
    (within 2e-4) after 8, 12 and 16 tokens at window 8, and both follow
    the train logits after 8 and 16 but not after 12."""
    cfg_r, cfg_p = _cfgs("recurrentgemma_2b", q_chunk=4)
    pr, pp = _ref_params(cfg_r, cfg_p, 0)
    toks = np.random.default_rng(0).integers(0, 512, (1, 24)).astype(np.int32)
    train, _, _ = PT.forward(pp, {"tokens": _t(toks)}, cfg_p)
    _, c_r, _ = RT.forward(pr, {"tokens": jnp.asarray(toks[:, :prefill])},
                           cfg_r, mode="prefill")
    _, c_p, _ = PT.forward(pp, {"tokens": _t(toks[:, :prefill])}, cfg_p,
                           mode="prefill")
    c_r = RSRV.pad_cache_to(c_r, RT.cache_shapes(cfg_r, 1, 32))
    c_p = PSRV.pad_cache_to(c_p, PT.cache_shapes(cfg_p, 1, 32))
    dec = jax.jit(lambda p, t, pos, c: RT.forward(
        p, {"tokens": t}, cfg_r, mode="decode", cache=c, pos=pos))
    errs = []
    for t in range(prefill, 24):
        l_r, c_r, _ = dec(pr, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t), c_r)
        l_p, c_p, _ = PT.forward(pp, {"tokens": _t(toks[:, t:t + 1])}, cfg_p,
                                 mode="decode", cache=c_p, pos=t)
        _close(l_p, l_r, TOL, f"decode logits at {t}")
        errs.append(float((l_p[:, 0] - train[:, t]).abs().max()))
    if prefill % cfg_p.attn_window:
        assert max(errs) > 0.05
    else:
        assert max(errs) < 1e-4
