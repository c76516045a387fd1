"""``ssd_scan`` with B and C per group of heads, on the CPU.

Bm and Cm of shape [G, nc, Q, ds], G dividing BH, stand for the same
tensors broadcast to [BH, nc, Q, ds] (row bh reads group bh // (BH // G)),
as the reference's ``ssd_seq_cached`` broadcasts them before its kernel.
The plain version expands the groups itself, so the two agree bit for bit;
the reference's Pallas kernel runs in interpret mode on the broadcast
inputs.  ``tests/test_torch_cuda.py`` holds the CUDA kernels to the same
on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as ref_ssd_scan
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models import ssm as PS
from test_torch_models import _cfgs, _ssd_params


def _inputs(BH, G, nc, Q, hd, ds, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, nc, Q, hd)).astype(np.float32)
    la = (-np.abs(rng.standard_normal((BH, nc, Q))) * 0.2).astype(np.float32)
    Bg = (rng.standard_normal((G, nc, Q, ds)) * 0.2).astype(np.float32)
    Cg = (rng.standard_normal((G, nc, Q, ds)) * 0.2).astype(np.float32)
    return x, la, Bg, Cg


def _broadcast(a, BH):
    return np.ascontiguousarray(np.repeat(a, BH // a.shape[0], axis=0))


@pytest.mark.parametrize("Q", [8, 37, 256])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_plain_groups_equal_broadcast(G, Q):
    """G in {1, 2, BH}: the grouped call equals the call on the broadcast
    tensors bit for bit, through the plain version and the wrapper."""
    BH, nc, hd, ds = 4, 2, 16, 32
    x, la, Bg, Cg = (torch.from_numpy(a) for a in
                     _inputs(BH, G, nc, Q, hd, ds, seed=G * 100 + Q))
    Bb, Cb = (torch.from_numpy(_broadcast(a.numpy(), BH)) for a in (Bg, Cg))
    want = ssd_scan_plain(x, la, Bb, Cb)
    assert torch.equal(ssd_scan_plain(x, la, Bg, Cg), want)
    assert torch.equal(ssd_scan(x, la, Bg, Cg), want)
    assert torch.equal(ops.ssd_scan_op(x, la, Bg, Cg, device="cpu"), want)


@pytest.mark.parametrize("shape", [(4, 1, 2, 64, 32, 64), (6, 2, 1, 200, 64, 128),
                                   (3, 3, 3, 8, 16, 16)])
def test_grouped_port_vs_reference(shape):
    """The grouped port against the reference's kernel (interpret mode) on
    the broadcast inputs, within the reference's 3e-4."""
    BH, G, nc, Q, hd, ds = shape
    x, la, Bg, Cg = _inputs(BH, G, nc, Q, hd, ds, seed=sum(shape))
    y = ssd_scan(*(torch.from_numpy(a) for a in (x, la, Bg, Cg)))
    y_ref = ref_ssd_scan(jnp.asarray(x), jnp.asarray(la),
                         jnp.asarray(_broadcast(Bg, BH)),
                         jnp.asarray(_broadcast(Cg, BH)), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=3e-4,
                               atol=3e-4)


@pytest.mark.parametrize("G", [3, 5, 8])
def test_groups_that_do_not_divide_bh_are_refused(G):
    x, la, Bg, Cg = (torch.from_numpy(a) for a in
                     _inputs(4, G, 1, 8, 4, 4, seed=G))
    with pytest.raises(ValueError, match="do not divide BH = 4"):
        ssd_scan(x, la, Bg, Cg)
    with pytest.raises(ValueError, match="do not divide BH = 4"):
        ssd_scan_plain(x, la, Bg, Cg)


def test_model_passes_one_group_per_batch_row(monkeypatch):
    """``ssd_impl="kernel"`` hands ssd_scan B and C as [B, nc, Q, ds]
    (one group per batch row, shared by its heads), not broadcast."""
    _, cfg_p = _cfgs("mamba2_780m", ssd_impl="kernel")
    _, pp = _ssd_params(_cfgs("mamba2_780m")[0])
    seen = []

    def spy(x, la, Bm, Cm):
        seen.append((tuple(x.shape), tuple(Bm.shape), tuple(Cm.shape)))
        return ssd_scan(x, la, Bm, Cm)

    monkeypatch.setattr(PS, "ssd_scan", spy)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 16, 64)).astype(np.float32))
    PS.ssd_seq(pp, x, cfg_p)
    nh, Q = cfg_p.ssm_heads, min(cfg_p.ssm_chunk, 16)
    ds, hd = cfg_p.ssm_state, cfg_p.ssm_head_dim
    assert seen == [((3 * nh, 16 // Q, Q, hd), (3, 16 // Q, Q, ds),
                     (3, 16 // Q, Q, ds))]
