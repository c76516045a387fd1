"""The port's training path on the CPU — the loss, gradient accumulation,
the optimizers and schedules, the flash backward and its
``autograd.Function``, activation checkpointing, the ``ssd_scan`` refusal,
the data pipeline and the serving steps' inference mode — held against
the JAX package on the same inputs.

Inputs come from numpy with fixed seeds; parameters are the reference's
own ``init_params``, carried across with ``params_from_numpy``.  The port
runs at ``device="cpu"``, where every kernel wrapper takes its plain
version; the reference's Pallas kernels run in interpret mode.
``tests/test_torch_cuda.py`` holds the CUDA backward kernels against their
plain versions on a card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.data import pipeline as RD
from repro.kernels.flash_attn import _flash_bwd as ref_flash_bwd
from repro.kernels.flash_attn import _flash_fwd as ref_flash_fwd
from repro.kernels.flash_attn import flash_attention as ref_flash_attention
from repro.models import transformer as RT
from repro.models.config import ModelConfig as RModelConfig
from repro.train import optim as RO
from repro.train import step as RS
from repro_torch.convert import params_from_numpy
from repro_torch.data import pipeline as PD
from repro_torch.kernels.flash_attn import (flash_attention, flash_bwd,
                                            flash_bwd_dkv, flash_bwd_dq,
                                            flash_bwd_plain, flash_delta,
                                            flash_fwd)
from repro_torch.kernels.ssd_scan import SsdScanGradError, ssd_scan
from repro_torch.models import transformer as PT
from repro_torch.models.config import ModelConfig as PModelConfig
from repro_torch.models.config import torch_dtype
from repro_torch.serving import ContinuousBatcher, Request
from repro_torch.train import optim as PO
from repro_torch.train import serve as PSRV
from repro_torch.train import step as PS
from test_models import reduced

F32 = dict(dtype="float32", param_dtype="float32")
TINY_KW = dict(name="tiny", family="dense", num_layers=2, d_model=32,
               num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64,
               q_chunk=64, **F32)
TINY_R = RModelConfig(**TINY_KW)
TINY_P = PModelConfig(**TINY_KW)
# the shapes of tests/test_kernels.py's flash test: BH, S, hd, window, bq, bk
FLASH_SHAPES = [(2, 256, 64, 0, 128, 128), (1, 512, 128, 256, 256, 128),
                (2, 256, 64, 64, 128, 64)]
TOL = 2e-4          # the reference's gradient tolerance (tests/test_kernels.py)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _port_cfg(ref):
    return PModelConfig(**{f.name: getattr(ref, f.name)
                           for f in dataclasses.fields(ref)})


def _cfgs(arch, **kw):
    ref = reduced(RC.get_config(arch)).with_(**F32, **kw)
    return ref, _port_cfg(ref)


def _params(cfg_r, cfg_p, seed=0):
    pr = RT.init_params(cfg_r, jax.random.PRNGKey(seed))
    return pr, params_from_numpy(cfg_p, {k: np.asarray(v) for k, v in
                                         pr.items()}, "cpu")


def _batch(rng, B, S, vocab):
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _states(cfg_r, cfg_p, step_r, step_p, seed=0):
    pr, pp = _params(cfg_r, cfg_p, seed)
    st_r = {"params": pr, "opt": step_r.init_opt(pr),
            "step": jnp.zeros((), jnp.int32)}
    st_p = {"params": pp, "opt": step_p.init_opt(pp), "step": 0}
    return st_r, st_p


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: _t(v) for k, v in batch.items()}


# ------------------------------------------------------------ optimizers


def test_adamw_matches_numpy():
    cfg = PO.OptConfig(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                       grad_clip=0.0, schedule="constant", warmup_steps=1)
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    st = PO.adamw_init(p, cfg)
    newp, st2, _ = PO.adamw_update(p, g, st, cfg)
    m = 0.1 * np.array([0.1, 0.2, -0.3])
    v = 0.01 * np.array([0.1, 0.2, -0.3]) ** 2
    mhat, vhat = m / (1 - 0.9), v / (1 - 0.99)
    ref = np.array([1.0, -2.0, 3.0]) - 1e-2 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(newp["w"].numpy(), ref, rtol=1e-5)
    assert st2["count"] == 1
    assert torch.equal(p["w"], torch.tensor([1.0, -2.0, 3.0]))   # functional


@pytest.mark.parametrize("name,state_dtype", [("adamw", "float32"),
                                              ("adamw", "bfloat16"),
                                              ("adafactor", "float32")])
def test_optimizer_updates_vs_reference(name, state_dtype):
    """Three updates of leaves of rank 1, 2 and 3 with clipping and weight
    decay == the reference's: params within 2e-4, the state within 2e-4
    (f32) or a bf16 step (bf16 state)."""
    rng = np.random.default_rng(5)
    shapes = {"b": (7,), "w": (6, 5), "s": (3, 4, 5)}
    p_np = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(name=name, lr=1e-2, weight_decay=0.1, grad_clip=0.5,
              state_dtype=state_dtype, schedule="wsd", warmup_steps=2,
              total_steps=5, decay_frac=0.4)
    cr, cp = RO.OptConfig(**kw), PO.OptConfig(**kw)
    init_r, upd_r = ((RO.adamw_init, RO.adamw_update) if name == "adamw"
                     else (RO.adafactor_init, RO.adafactor_update))
    init_p, upd_p = ((PO.adamw_init, PO.adamw_update) if name == "adamw"
                     else (PO.adafactor_init, PO.adafactor_update))
    pr = {k: jnp.asarray(v) for k, v in p_np.items()}
    pp = {k: _t(v) for k, v in p_np.items()}
    sr, sp = init_r(pr, cr), init_p(pp, cp)
    for _ in range(3):
        g_np = {k: rng.standard_normal(s).astype(np.float32)
                for k, s in shapes.items()}
        pr, sr, mr = upd_r(pr, {k: jnp.asarray(v) for k, v in g_np.items()},
                           sr, cr)
        pp, sp, mp = upd_p(pp, {k: _t(v) for k, v in g_np.items()}, sp, cp)
        assert mp["lr"] == pytest.approx(float(mr["lr"]), rel=1e-6)
        if name == "adamw":
            _close(mp["grad_norm"], mr["grad_norm"], 1e-5, "grad_norm")
    for k in shapes:
        _close(pp[k], pr[k], TOL, f"param {k}")
    assert sp["count"] == int(sr["count"]) == 3
    st_tol = TOL if state_dtype == "float32" else 1e-2
    if name == "adamw":
        for part in ("m", "v"):
            for k in shapes:
                assert sp[part][k].dtype == torch_dtype(state_dtype)
                _close(sp[part][k], sr[part][k], st_tol, f"{part} {k}")
    else:
        for k in shapes:
            assert set(sp["f"][k]) == set(sr["f"][k])
            for part in sp["f"][k]:
                _close(sp["f"][k][part], sr["f"][k][part], st_tol,
                       f"{part} {k}")


def test_wsd_schedule_shape():
    cfg = PO.OptConfig(lr=1.0, schedule="wsd", warmup_steps=10,
                       total_steps=100, decay_frac=0.2)
    lrs = [PO.lr_at(cfg, s) for s in [0, 5, 10, 50, 79, 90, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[3] == pytest.approx(1.0)          # stable phase
    assert lrs[4] == pytest.approx(1.0, abs=0.06)
    assert 0.4 < lrs[5] < 0.7                    # decaying
    assert lrs[6] == pytest.approx(0.1, abs=0.02)


@pytest.mark.parametrize("schedule", ["constant", "wsd", "cosine"])
def test_lr_schedules_vs_reference(schedule):
    kw = dict(lr=3e-4, schedule=schedule, warmup_steps=10, total_steps=100,
              decay_frac=0.2)
    cr, cp = RO.OptConfig(**kw), PO.OptConfig(**kw)
    # the reference evaluates in f32, where 1 + cos(pi t) cancels near the
    # end of the cosine: an absolute f32 epsilon at the scale of lr
    for s in [0, 1, 5, 10, 11, 50, 79, 80, 90, 99, 100, 150]:
        assert PO.lr_at(cp, s) == pytest.approx(float(RO.lr_at(cr, s)),
                                                rel=1e-6,
                                                abs=2.0 ** -23 * cp.lr), s
    with pytest.raises(ValueError, match="unknown schedule"):
        PO.lr_at(PO.OptConfig(schedule="linear"), 1)


# ------------------------------------------------------------- the step


def test_cross_entropy_masking():
    logits = torch.zeros(1, 4, 8)
    labels = torch.tensor([[1, 2, PS.IGNORE, PS.IGNORE]])
    loss, ce = PS.cross_entropy(logits, labels, z_weight=0.0)
    assert float(ce) == pytest.approx(np.log(8), rel=1e-5)
    assert float(loss) == pytest.approx(np.log(8), rel=1e-5)


def test_cross_entropy_vs_reference():
    """Loss (with the default z-loss) and CE on random logits with masked
    labels == the reference's, and an all-masked batch gives 0."""
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((2, 5, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = RS.IGNORE
    lr_, cr_ = RS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    lp, cp = PS.cross_entropy(_t(logits), _t(labels))
    _close(lp, lr_, 1e-6, "loss")
    _close(cp, cr_, 1e-6, "ce")
    lp, cp = PS.cross_entropy(_t(logits), torch.full((2, 5), PS.IGNORE))
    assert float(lp) == 0.0 and float(cp) == 0.0


def test_grad_accumulation_equivalence():
    """One step over 4 sequences == two microbatches of 2, and both ==
    the reference's two-microbatch step."""
    rng = np.random.default_rng(0)
    batch = _batch(rng, 4, 16, 64)
    opt = dict(lr=1e-3, schedule="constant", warmup_steps=1, grad_clip=0.0)
    s1 = PS.make_train_step(TINY_P, PO.OptConfig(**opt), microbatches=1)
    s2 = PS.make_train_step(TINY_P, PO.OptConfig(**opt), microbatches=2)
    r2 = RS.make_train_step(TINY_R, RO.OptConfig(**opt), microbatches=2)
    st_r, st = _states(TINY_R, TINY_P, r2, s1)
    n1, m1 = s1(st, _tbatch(batch))
    n2, m2 = s2(st, _tbatch(batch))
    nr, mr = jax.jit(r2)(st_r, _jbatch(batch))
    for k in n1["params"]:
        np.testing.assert_allclose(_np(n1["params"][k]), _np(n2["params"][k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
        _close(n2["params"][k], nr["params"][k], TOL, k)
    _close(m2["loss"], mr["loss"], TOL, "loss")
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    assert m2["step"] == int(mr["step"]) == 1


def test_tiny_model_learns():
    """Memorize a fixed batch: loss must drop substantially."""
    rng = np.random.default_rng(3)
    batch = _tbatch(_batch(rng, 8, 16, 64))
    step = PS.make_train_step(TINY_P, PO.OptConfig(lr=3e-3, schedule="constant",
                                                   warmup_steps=5))
    params = PT.init_params(TINY_P, torch.Generator().manual_seed(3), "cpu")
    st = {"params": params, "opt": step.init_opt(params), "step": 0}
    first = None
    for _ in range(60):
        st, m = step(st, batch)
        if first is None:
            first = float(m["loss"])
    last = float(m["loss"])
    assert last < first * 0.6, f"no learning: {first} -> {last}"


def test_adafactor_runs_and_reduces_loss():
    rng = np.random.default_rng(4)
    batch = _tbatch(_batch(rng, 8, 16, 64))
    step = PS.make_train_step(TINY_P, PO.OptConfig(name="adafactor", lr=1e-2,
                                                   schedule="constant",
                                                   warmup_steps=5))
    params = PT.init_params(TINY_P, torch.Generator().manual_seed(4), "cpu")
    st = {"params": params, "opt": step.init_opt(params), "step": 0}
    losses = []
    for _ in range(40):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_steps_vs_reference(name):
    """Three train steps of the tiny model from the reference's params ==
    the reference's: params within 2e-4, each step's loss too."""
    rng = np.random.default_rng(7)
    kw = dict(name=name, lr=3e-3, schedule="constant", warmup_steps=2)
    step_r = RS.make_train_step(TINY_R, RO.OptConfig(**kw))
    step_p = PS.make_train_step(TINY_P, PO.OptConfig(**kw))
    st_r, st_p = _states(TINY_R, TINY_P, step_r, step_p, seed=7)
    jstep = jax.jit(step_r)
    for i in range(3):
        batch = _batch(rng, 4, 16, 64)
        st_r, mr = jstep(st_r, _jbatch(batch))
        st_p, mp = step_p(st_p, _tbatch(batch))
        _close(mp["loss"], mr["loss"], TOL, f"loss at step {i}")
    for k in st_r["params"]:
        _close(st_p["params"][k], st_r["params"][k], TOL, k)
    assert st_p["step"] == int(st_r["step"]) == 3


def test_train_step_refusals():
    with pytest.raises(ValueError, match="unknown optimizer"):
        PS.make_train_step(TINY_P, PO.OptConfig(name="sgd"))
    with pytest.raises(ValueError, match="microbatches"):
        PS.make_train_step(TINY_P, PO.OptConfig(), microbatches=0)
    step = PS.make_train_step(TINY_P, PO.OptConfig(), microbatches=3)
    params = PT.init_params(TINY_P, torch.Generator().manual_seed(0), "cpu")
    batch = _tbatch(_batch(np.random.default_rng(0), 4, 8, 64))
    with pytest.raises(ValueError, match="does not split into 3"):
        step({"params": params, "opt": step.init_opt(params), "step": 0},
             batch)
    bad = PS.make_train_step(TINY_P.with_(remat="all"), PO.OptConfig())
    with pytest.raises(ValueError, match="unknown remat"):
        bad.grads(params, batch)


@pytest.mark.parametrize("name,state_dtype", [("adamw", "float32"),
                                              ("adamw", "bfloat16"),
                                              ("adafactor", "float32")])
def test_train_state_specs_vs_reference(name, state_dtype):
    cfg_r, cfg_p = _cfgs("smollm_360m")
    kw = dict(name=name, state_dtype=state_dtype)
    shapes_r, axes_r = RS.train_state_specs(cfg_r, RO.OptConfig(**kw))
    shapes_p, axes_p = PS.train_state_specs(cfg_p, PO.OptConfig(**kw))
    flat_r = jax.tree_util.tree_flatten_with_path(shapes_r)[0]
    got = _flatten(shapes_p)
    assert len(got) == len(flat_r)
    for path, sd in flat_r:
        key = tuple(p.key for p in path)
        assert got[key].shape == tuple(sd.shape), key
        assert str(got[key].dtype).split(".")[-1] == str(sd.dtype), key
    assert axes_p == axes_r
    assert PS.metrics_axes() == RS.metrics_axes()
    params = PT.init_params(cfg_p, torch.Generator().manual_seed(0), "cpu")
    opt = PS.make_train_step(cfg_p, PO.OptConfig(**kw)).init_opt(params)
    for path, t in _flatten({"opt": opt}).items():
        if path[-1] != "count":
            assert tuple(t.shape) == got[path].shape, path
            assert t.dtype == got[path].dtype, path


def _flatten(tree, path=()):
    """{path: leaf} of a nest of dicts (TensorSpec and tensors are leaves)."""
    if not isinstance(tree, dict):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, path + (k,)))
    return out


# ------------------------------------------------------- flash backward


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_bwd_plain_vs_reference_interpret(shape):
    """flash_bwd_plain == repro.kernels.flash_attn._flash_bwd (interpret
    mode) on the reference forward's O and LSE, within 2e-4."""
    BH, S, hd, window, bq, bk = shape
    rng = np.random.default_rng(100 + S + window)
    q, k, v, do = (rng.standard_normal((BH, S, hd)).astype(np.float32)
                   for _ in range(4))
    scale = 1.0 / np.sqrt(hd)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = ref_flash_fwd(jq, jk, jv, scale=scale, window=window, bq=bq,
                           bk=bk, interpret=True)
    want = ref_flash_bwd(jq, jk, jv, o, lse, jdo, scale=scale, window=window,
                         bq=bq, bk=bk, interpret=True)
    got = flash_bwd_plain(_t(q), _t(k), _t(v), _t(o), _t(lse), _t(do),
                          scale=scale, window=window)
    for name, g, w in zip(("dQ", "dK", "dV"), got, want):
        assert g.dtype == torch.float32
        _close(g, w, TOL, name)


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_grads_vs_reference(shape):
    """The port's flash_attention, differentiated through its
    autograd.Function, == jax.grad of the reference's custom_vjp (interpret
    mode) on sum(O), within 2e-4; O within 3e-5."""
    BH, S, hd, window, bq, bk = shape
    rng = np.random.default_rng(200 + S + window)
    q, k, v = (rng.standard_normal((BH, S, hd)).astype(np.float32)
               for _ in range(3))
    scale = 1.0 / np.sqrt(hd)
    g_r = jax.grad(lambda *a: ref_flash_attention(*a, scale, window, bq, bk,
                                                  True).sum(),
                   argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = flash_attention(tq, tk, tv, scale, window, bq, bk)
    assert o.grad_fn is not None and "FlashAttention" in type(o.grad_fn).__name__
    o_r = ref_flash_attention(*map(jnp.asarray, (q, k, v)), scale, window,
                              bq, bk, True)
    _close(o, o_r, 3e-5, "O")
    o.sum().backward()
    for name, g, w in zip(("dQ", "dK", "dV"), (tq.grad, tk.grad, tv.grad), g_r):
        _close(g, w, TOL, name)


def test_flash_bwd_wrappers_on_cpu_take_the_plain_formulas():
    """On CPU tensors flash_bwd, flash_bwd_dq and flash_bwd_dkv compute the
    plain formulas (no kernel launch counted); bf16 in, bf16 out."""
    rng = np.random.default_rng(8)
    q, k, v, do = (_t(rng.standard_normal((2, 40, 64)).astype(np.float32))
                   for _ in range(4))
    o, lse = flash_fwd(q, k, v, scale=0.125, window=9)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    want = flash_bwd_plain(q, k, v, o, lse, do, scale=0.125, window=9)
    got = flash_bwd(q, k, v, o, lse, do, scale=0.125, window=9)
    delta = flash_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale=0.125, window=9)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale=0.125, window=9)
    for g, g2, w in zip(got, (dq, dk, dv), want):
        assert torch.equal(g, w) and torch.equal(g2, w)
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == before
    qb, kb, vb, ob, dob = (t.bfloat16() for t in (q, k, v, o, do))
    outs = flash_bwd(qb, kb, vb, ob, lse, dob, scale=0.125, window=9)
    outs32 = flash_bwd_plain(qb.float(), kb.float(), vb.float(), ob.float(),
                             lse, dob.float(), scale=0.125, window=9)
    for g, w in zip(outs, outs32):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w.bfloat16())


def test_flash_bwd_refusals():
    x = torch.zeros(2, 8, 64)
    lse = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="lse must be float32"):
        flash_bwd(x, x, x, x, torch.zeros(2, 9), x, scale=1.0)
    with pytest.raises(ValueError, match="lse must be float32"):
        flash_bwd(x, x, x, x, lse.double(), x, scale=1.0)
    with pytest.raises(ValueError, match="do must match q"):
        flash_bwd(x, x, x, x, lse, torch.zeros(2, 8, 32), scale=1.0)
    with pytest.raises(ValueError, match="o must match q"):
        flash_bwd(x, x, x, x.bfloat16(), lse, x, scale=1.0)
    with pytest.raises(ValueError, match="delta must be float32"):
        flash_bwd_dq(x, x, x, x, lse, torch.zeros(8), scale=1.0)
    with pytest.raises(TypeError, match="lse must be a tensor"):
        flash_bwd_dkv(x, x, x, x, None, lse, scale=1.0)


# ------------------------------------------------------------ ssd_scan


def test_ssd_scan_refuses_gradients():
    """ssd_scan has no VJP in the reference: an input that requires grad
    under grad mode raises, on the CPU path too, and a train step with
    ssd_impl='kernel' raises before any update; without grad it runs."""
    rng = np.random.default_rng(9)
    x = _t(rng.standard_normal((2, 2, 8, 4)).astype(np.float32))
    la = _t(-np.abs(rng.standard_normal((2, 2, 8))).astype(np.float32) * 0.2)
    Bm, Cm = (_t(rng.standard_normal((2, 2, 8, 4)).astype(np.float32))
              for _ in range(2))
    for i in range(4):
        args = [x, la, Bm, Cm]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(SsdScanGradError, match="ssd_impl='xla'"):
            ssd_scan(*args)
        with torch.no_grad():
            y = ssd_scan(*args)
        assert y.shape == x.shape
        with torch.inference_mode():
            assert torch.equal(ssd_scan(*args), y)
    cfg_r, cfg_p = _cfgs("mamba2_780m", ssd_impl="kernel")
    _, pp = _params(cfg_r, cfg_p)
    step = PS.make_train_step(cfg_p, PO.OptConfig())
    batch = _tbatch(_batch(rng, 2, 16, 512))
    with pytest.raises(SsdScanGradError):
        step({"params": pp, "opt": step.init_opt(pp), "step": 0}, batch)
    step = PS.make_train_step(cfg_p.with_(ssd_impl="xla"), PO.OptConfig())
    _, m = step({"params": pp, "opt": step.init_opt(pp), "step": 0}, batch)
    assert np.isfinite(float(m["loss"]))


# --------------------------------------------------------------- remat


@pytest.mark.parametrize("arch,kw", [("smollm_360m", {"attn_impl": "naive"}),
                                     ("smollm_360m", {"attn_impl": "flash"}),
                                     ("mamba2_780m", {"ssd_impl": "xla"})])
def test_remat_modes_give_equal_gradients(arch, kw):
    """remat none, block and dots: the same loss and gradients (the
    recompute repeats the same arithmetic), every leaf finite and nonzero."""
    _, cfg_p = _cfgs(arch, **kw)
    params = PT.init_params(cfg_p, torch.Generator().manual_seed(1), "cpu")
    batch = _tbatch(_batch(np.random.default_rng(10), 2, 32, 512))
    out = {}
    for remat in PT.REMAT_MODES:
        step = PS.make_train_step(cfg_p.with_(remat=remat), PO.OptConfig())
        out[remat] = step.grads(params, batch)
    loss0, _, g0 = out["none"]
    for k, g in g0.items():
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, k
    for remat in ("block", "dots"):
        loss, _, g = out[remat]
        assert float(loss) == pytest.approx(float(loss0), rel=1e-6)
        for k in g0:
            torch.testing.assert_close(g[k], g0[k], rtol=1e-5, atol=1e-6,
                                       msg=f"{remat} {k}")


def test_remat_checkpoints_only_with_grad_in_train_mode(monkeypatch):
    """block remat wraps every super-block in a checkpoint when a gradient
    is wanted, and in nothing else (no grad, prefill)."""
    _, cfg_p = _cfgs("smollm_360m")
    params = PT.init_params(cfg_p, torch.Generator().manual_seed(2), "cpu")
    toks = _t(np.random.default_rng(11).integers(0, 512, (2, 16)))
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(*a, **k):
        calls.append(k.get("use_reentrant"))
        return real(*a, **k)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    PT.forward(leaves, {"tokens": toks}, cfg_p)
    assert cfg_p.remat == "block" and calls == [False] * cfg_p.n_super
    calls.clear()
    with torch.no_grad():
        PT.forward(leaves, {"tokens": toks}, cfg_p)
    PT.forward(leaves, {"tokens": toks}, cfg_p, mode="prefill")
    PT.forward(leaves, {"tokens": toks}, cfg_p.with_(remat="none"))
    assert calls == []


# ------------------------------------------------------- the train path


TRAIN_ARCHS = [("smollm_360m", {"attn_impl": "naive"}),
               ("smollm_360m", {"attn_impl": "flash"}),
               ("mamba2_780m", {"ssd_impl": "xla"})]


@pytest.mark.parametrize("arch,kw", TRAIN_ARCHS)
def test_arch_train_step_vs_reference(arch, kw):
    """The train half of tests/test_models.py::test_arch_smoke_forward_and_train
    on the port (train-mode logits, no cache; one AdamW step that stays
    finite), and that step against the reference's: loss and every param
    within 2e-4 (the flash path through the kernels' plain versions here,
    the reference's Pallas kernels in interpret mode)."""
    cfg_r, cfg_p = _cfgs(arch, **kw)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    step_r = RS.make_train_step(cfg_r, RO.OptConfig(**opt))
    step_p = PS.make_train_step(cfg_p, PO.OptConfig(**opt))
    st_r, st_p = _states(cfg_r, cfg_p, step_r, step_p)
    rng = np.random.default_rng(12)
    B, S = 2, 32
    batch = _batch(rng, B, S, cfg_r.vocab_size)
    logits, cache, _ = PT.forward(st_p["params"], {"tokens": _t(batch["tokens"])},
                                  cfg_p, mode="train")
    assert logits.shape == (B, S, cfg_p.vocab_size) and cache is None
    assert bool(torch.isfinite(logits).all())
    st_r, mr = jax.jit(step_r)(st_r, _jbatch(batch))
    st_p, mp = step_p(st_p, _tbatch(batch))
    assert np.isfinite(float(mp["loss"])) and mp["step"] == 1
    _close(mp["loss"], mr["loss"], TOL, "loss")
    _close(mp["ce"], mr["ce"], TOL, "ce")
    _close(mp["grad_norm"], mr["grad_norm"], TOL, "grad_norm")
    for k in st_r["params"]:
        _close(st_p["params"][k], st_r["params"][k], TOL, k)
        assert not st_p["params"][k].requires_grad


# ------------------------------------------------------------- serving


def test_serve_steps_build_no_graph():
    """With parameters that require a gradient, the prefill and decode
    steps and the batcher's ticks return tensors with no grad_fn."""
    _, cfg_p = _cfgs("smollm_360m", attn_impl="flash")
    params = {k: v.requires_grad_(True) for k, v in PT.init_params(
        cfg_p, torch.Generator().manual_seed(4), "cpu").items()}
    toks = _t(np.random.default_rng(14).integers(0, 512, (2, 16)))
    cache, last = PSRV.make_prefill_step(cfg_p)(params, {"tokens": toks})
    assert last.grad_fn is None and not last.requires_grad
    assert all(c.grad_fn is None for c in cache.values())
    cache = PSRV.pad_cache_to(cache, PT.cache_shapes(cfg_p, 2, 24))
    cache, logits = PSRV.make_decode_step(cfg_p)(params, cache,
                                                 toks[:, -1:], 16)
    assert logits.grad_fn is None and not logits.requires_grad
    assert all(c.grad_fn is None for c in cache.values())
    b = ContinuousBatcher(cfg_p, params, 2, 32, device="cpu")
    c1, l1 = PSRV.jit_prefill_step(cfg_p)(params, {"tokens": toks[:1]})
    b.install(0, c1, 16, int(PSRV.greedy_token(l1)[0, 0]), Request(0, None, 3))
    n, _ = b.tick()
    assert n == 1 and all(c.grad_fn is None for c in b.cache.values())
    assert all(p.grad is None for p in params.values())


# ---------------------------------------------------------------- data


def test_data_pipeline_matches_reference():
    """TokenDataset batches (synthetic and over a token array), the
    synthetic_batch helper and the Loader's order == the reference's."""
    arr = np.arange(5000, dtype=np.int32) % 97
    for kw in ({}, {"tokens": arr}):
        dr, dp = RD.TokenDataset(97, seed=3, **kw), PD.TokenDataset(97, seed=3, **kw)
        assert len(dr) == len(dp)
        for step, shard in ((0, 0), (5, 1), (9, 3)):
            br, bp = dr.batch(step, shard, 4, 2, 16), dp.batch(step, shard, 4, 2, 16)
            for key in ("tokens", "labels"):
                np.testing.assert_array_equal(bp[key], br[key])
            np.testing.assert_array_equal(bp["tokens"][:, 1:],
                                          bp["labels"][:, :-1])
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(PD.synthetic_batch(50, 2, 8, 4)[key],
                                      RD.synthetic_batch(50, 2, 8, 4)[key])
    ds = PD.TokenDataset(97, seed=1)
    ld = PD.Loader(ds, shard_id=1, n_shards=2, batch_per_shard=2, seq_len=8,
                   start_step=4)
    try:
        for want in range(4, 8):
            step, b = next(ld)
            assert step == want
            np.testing.assert_array_equal(b["tokens"],
                                          ds.batch(want, 1, 2, 2, 8)["tokens"])
    finally:
        ld.close()
    assert not ld._t.is_alive()
