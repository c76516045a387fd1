"""The rounding of the bf16 flash kernels, emulated here on the CPU, against
the JAX reference's f32 math.

On the card, bf16 operands take the tensor-core kernels
(``flash_fwd_wgmma_kernel``, ``flash_bwd_dq_wgmma_kernel``,
``flash_bwd_dkv_wgmma_kernel``): every product sums in f32, but P and dS
enter the second product of each pair as bf16, and O, dQ, dK and dV are
written in bf16.  The emulation below repeats
those steps in the kernels' order (key tiles of 64, the online softmax on
the f32 scores, P rounded at the running max), in PyTorch on the CPU, and
is held against ``repro.kernels.flash_attn._flash_fwd`` / ``_flash_bwd``
(interpret mode) fed the same bf16 values, within the card tests' own
tolerances (``tests/test_torch_cuda.py``): O, dQ, dK and dV to 8e-3, LSE
to 1e-4.  A kernel that agrees with the emulation bit for bit cannot be
told from it by those tests; this file shows the rounding design itself
fits them at small versions of the card's shapes.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import _flash_bwd as ref_flash_bwd
from repro.kernels.flash_attn import _flash_fwd as ref_flash_fwd

BK = 64                                     # the forward kernel's key tile
TOL_BF16 = dict(rtol=8e-3, atol=8e-3)
TOL_LSE = dict(rtol=1e-4, atol=1e-4)

# BH, S, hd, window, and the reference's block size (S divides by it):
# ragged S against the kernels' tiles of 64 and 128, windows 17 and 256,
# head_dim 64 and 128
SHAPES = [(3, 200, 64, 0, 100), (2, 130, 64, 17, 65), (2, 257, 64, 0, 257),
          (2, 512, 128, 256, 256), (4, 512, 64, 0, 256)]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _allowed(S: int, window: int) -> torch.Tensor:
    pos = torch.arange(S)
    m = pos[:, None] >= pos[None, :]
    if window:
        m &= pos[:, None] - pos[None, :] < window
    return m


def emulate_fwd(q, k, v, scale, window):
    """The bf16 forward kernel's arithmetic: S = q k^T in f32, the online
    softmax over key tiles of 64 in base 2, P rounded to bf16 before P v,
    O rounded to bf16.  -> (O as f32 of its bf16 values, LSE f32)."""
    BH, S, hd = q.shape
    mask = _allowed(S, window)
    scale_log2 = scale * math.log2(math.e)
    m = torch.full((BH, S), -1e30)
    l = torch.zeros(BH, S)
    acc = torch.zeros(BH, S, hd)
    for k0 in range(0, S, BK):
        kt = slice(k0, min(k0 + BK, S))
        x = torch.einsum("bqd,bkd->bqk", q, k[:, kt]) * scale_log2
        x = torch.where(mask[None, :, kt], x, -math.inf)
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqk,bkd->bqd", _bf16(p),
                                                   v[:, kt])
        m = m_new
    lc = torch.clamp(l, min=1e-30)
    return _bf16(acc / lc[..., None]), m * math.log(2) + torch.log(lc)


def _dp_and_ds(q, k, v, do, lse, delta, scale, window):
    """(P, dS) in f32: P recomputed from LSE, dP = dO v^T, dS = P (dP -
    delta) scale, as both backward kernels compute them."""
    S = q.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    p = torch.where(_allowed(S, window)[None], torch.exp(s - lse[..., None]),
                    0.0)
    dp = torch.einsum("bqd,bkd->bqk", do, v)
    return p, p * (dp - delta[..., None]) * scale


def emulate_dq(q, k, v, do, lse, delta, scale, window):
    """The bf16 dQ kernel's arithmetic: P and dP in f32, dS in f32, dS
    rounded to bf16 before the product with k, dQ rounded to bf16."""
    _, ds = _dp_and_ds(q, k, v, do, lse, delta, scale, window)
    return _bf16(torch.einsum("bqk,bkd->bqd", _bf16(ds), k))


def emulate_dkv(q, k, v, do, lse, delta, scale, window):
    """The bf16 dK/dV kernel's arithmetic: P recomputed from LSE and dP in
    f32, dS = P (dP - delta) scale in f32, P and dS rounded to bf16 before
    the products with dO and q, dK and dV rounded to bf16."""
    p, ds = _dp_and_ds(q, k, v, do, lse, delta, scale, window)
    return (_bf16(torch.einsum("bqk,bqd->bkd", _bf16(ds), q)),
            _bf16(torch.einsum("bqk,bqd->bkd", _bf16(p), do)))


@functools.lru_cache(maxsize=None)
def _case(shape):
    """bf16-valued operands (as f32), the reference's forward and backward
    on them in f32, and the emulated forward."""
    BH, S, hd, window, blk = shape
    rng = np.random.default_rng(S + hd + window)
    q, k, v, do = (_bf16(torch.from_numpy(
        rng.standard_normal((BH, S, hd)).astype(np.float32)))
        for _ in range(4))
    scale = 1.0 / math.sqrt(hd)
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
    o_r, lse_r = ref_flash_fwd(jq, jk, jv, scale=scale, window=window,
                               bq=blk, bk=blk, interpret=True)
    dq_r, dk_r, dv_r = ref_flash_bwd(jq, jk, jv, o_r, lse_r, jdo, scale=scale,
                                  window=window, bq=blk, bk=blk,
                                  interpret=True)
    ref = {n: torch.from_numpy(np.array(a, np.float32)) for n, a in
           (("o", o_r), ("lse", lse_r), ("dq", dq_r), ("dk", dk_r),
            ("dv", dv_r))}
    o, lse = emulate_fwd(q, k, v, scale, window)
    return (q, k, v, do), scale, window, ref, (o, lse)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_forward_rounding_fits_the_reference(shape):
    """O with P as a bf16 operand and a bf16 output, against the
    reference's f32 O within 8e-3; LSE (f32 throughout) within 1e-4."""
    _, _, _, ref, (o, lse) = _case(shape)
    assert bool(torch.isfinite(o).all())
    torch.testing.assert_close(o, ref["o"], **TOL_BF16)
    torch.testing.assert_close(lse, ref["lse"], **TOL_LSE)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_dkv_rounding_fits_the_reference(shape):
    """dK and dV of the path as the card runs it in bf16 (the emulated
    forward's bf16 O and LSE, delta = rowsum(dO O), P and dS as bf16
    operands, bf16 outputs) against the reference's f32 backward within
    8e-3."""
    (q, k, v, do), scale, window, ref, (o, lse) = _case(shape)
    delta = torch.sum(do * o, dim=-1)
    dk, dv = emulate_dkv(q, k, v, do, lse, delta, scale, window)
    for name, got in (("dk", dk), ("dv", dv)):
        assert bool(torch.isfinite(got).all()), name
        torch.testing.assert_close(got, ref[name], **TOL_BF16, msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_dq_rounding_fits_the_reference(shape):
    """dQ of the path as the card runs it in bf16 (the emulated forward's
    bf16 O and LSE, delta = rowsum(dO O), dS as a bf16 operand, a bf16
    output) against the reference's f32 dQ within 8e-3."""
    (q, k, v, do), scale, window, ref, (o, lse) = _case(shape)
    delta = torch.sum(do * o, dim=-1)
    dq = emulate_dq(q, k, v, do, lse, delta, scale, window)
    assert bool(torch.isfinite(dq).all())
    torch.testing.assert_close(dq, ref["dq"], **TOL_BF16)


def test_emulation_rounds_where_the_kernels_do():
    """The emulation is not the f32 math under another name: rounding P
    and dS moves dK and dV off the f32 result, by less than the
    tolerance."""
    (q, k, v, do), scale, window, ref, (o, lse) = _case(SHAPES[0])
    delta = torch.sum(do * o, dim=-1)
    dk, dv = emulate_dkv(q, k, v, do, lse, delta, scale, window)
    for name, got in (("dk", dk), ("dv", dv)):
        err = float((got - ref[name]).abs().max())
        assert 1e-4 < err < TOL_BF16["atol"] + TOL_BF16["rtol"] * float(
            ref[name].abs().max()), (name, err)
