"""Causal flash attention: the forward (O and the row log-sum-exp) and the
backward (dQ; dK and dV), tied together by a ``torch.autograd.Function``.

q, k, v are ``[BH, S, hd]`` (grouped-query KV heads repeated to the full
head count by the caller); position i attends to positions j <= i, and
with ``window > 0`` only to i - j < window.  Scores are scaled by
``scale`` and masked with NEG = -1e30; O comes back in the input type,
LSE (``m + log l`` of the row's softmax) in f32.

:func:`flash_fwd` launches the CUDA kernel (``csrc/flash_attn.cu``) on
CUDA tensors and runs :func:`flash_fwd_plain` on CPU tensors;
:func:`flash_bwd` likewise launches the two backward kernels
(``csrc/flash_attn_bwd.cu``: :func:`flash_bwd_dq`, :func:`flash_bwd_dkv`)
or runs :func:`flash_bwd_plain`.  The operands' type picks the kernel:
bf16 runs all three kernels on the tensor cores (``wgmma``, P and dS
rounded to bf16 as product operands, sums in f32), f32 runs FP32 FMAs on
the CUDA cores (``wgmma`` would round f32 operands to TF32).
:func:`flash_attention` is the model's entry point
and keeps the reference's signature: ``bq`` and ``bk`` are the
reference's block sizes, and the sequence must divide by both, as there;
the kernels tile as they like.  Its gradient is the reference's
``custom_vjp``: the forward saves q, k, v, O and LSE, the backward
recomputes the probabilities from LSE.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DEFAULT_BQ = 256
DEFAULT_BK = 256
NEG = -1e30
KERNEL_HEAD_DIMS = (64, 128)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be [BH, S, hd], got {tuple(t.shape)}")
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v types differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")


def check_kernel_operands(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> None:
    """What the CUDA kernels take, checked before any launch: f32 or bf16
    operands with a head_dim of 64 or 128.  bf16 runs the tensor-core
    kernels (``flash_fwd_wgmma_kernel``, ``flash_bwd_dq_wgmma_kernel``,
    ``flash_bwd_dkv_wgmma_kernel``), f32 the FP32-FMA ones."""
    _check(q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the flash kernel takes float32 or bfloat16, got {q.dtype}")
    hd = q.shape[-1]
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head_dim 64 or 128, not {hd}")


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, window: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the whole ``[BH, S, S]`` f32 score tensor,
    masked with NEG, softmax by its row max.  -> (O in q's type, LSE f32)."""
    _check(q, k, v)
    S = q.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    pos = torch.arange(S, device=q.device)
    m = pos[:, None] >= pos[None, :]
    if window:
        m &= pos[:, None] - pos[None, :] < window
    s = torch.where(m[None], s, NEG)
    mx = torch.amax(s, dim=-1)
    p = torch.exp(s - mx[..., None])
    l = torch.clamp(torch.sum(p, dim=-1), min=1e-30)
    o = torch.einsum("bqk,bkd->bqd", p, v.float()) / l[..., None]
    return o.to(q.dtype), mx + torch.log(l)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, window: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (O [BH,S,hd] in q's type, LSE [BH,S] f32).  Launches the CUDA
    kernel for CUDA tensors (``flash_fwd_wgmma_kernel`` for bf16,
    ``flash_fwd_kernel`` for f32); CPU tensors take the plain version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale=scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, not {q.device}")
    check_kernel_operands(q, k, v)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    BH, S, hd = q.shape
    if BH > 65535:
        raise ValueError(f"the flash kernel takes at most 65535 batch-heads "
                         f"(its grid's y), got {BH}")
    o = torch.empty_like(q)
    lse = torch.empty(BH, S, dtype=torch.float32, device=q.device)
    fn = _build.load("flash_attn").flash_fwd_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), BH, S, hd, float(scale), int(window),
             int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0     # kernel launches since the count was last reset


def _check_bwd(q, k, v, do, o=None, **rows) -> None:
    """q, k, v as :func:`_check`; ``do`` (and ``o``, where given) alike
    them; each of ``rows`` (lse, delta) f32 ``[BH, S]`` on their device."""
    _check(q, k, v)
    for name, t in (("do", do), ("o", o)):
        if t is None and name == "o":
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q ({tuple(q.shape)}, "
                             f"{q.dtype}, {q.device}); got {tuple(t.shape)}, "
                             f"{t.dtype}, {t.device}")
    for name, t in rows.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if tuple(t.shape) != tuple(q.shape[:2]) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{name} must be float32 {list(q.shape[:2])} on "
                             f"{q.device}; got {t.dtype} {list(t.shape)} on "
                             f"{t.device}")


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO · O)`` in f32, ``[BH, S]``: the backward's correction
    term, a plain torch op as in the reference (outside any kernel)."""
    return torch.sum(do.float() * o.float(), dim=-1)


def _bwd_plain(q, k, v, do, lse, delta, scale, window):
    """(p, ds) in f32, ``[BH, S, S]``: the probabilities recomputed from
    LSE under the mask, and ``p · (dP - delta) · scale``."""
    S = q.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    pos = torch.arange(S, device=q.device)
    m = pos[:, None] >= pos[None, :]
    if window:
        m &= pos[:, None] - pos[None, :] < window
    p = torch.where(m[None], torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                    scale: float, window: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, the reference kernels'
    formulas on whole ``[BH, S, S]`` f32 tensors: ``p = exp(s - lse)``
    masked, ``delta = rowsum(dO·O)``, ``ds = p·(dP - delta)·scale``;
    -> (dQ, dK, dV) in the inputs' type."""
    _check_bwd(q, k, v, do, o, lse=lse)
    delta = flash_delta(o, do)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, scale=scale,
                            window=window)
    return (dq, *flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale=scale,
                                     window=window))


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, scale: float,
                      window: int = 0) -> torch.Tensor:
    """Plain version of :func:`flash_bwd_dq`: ``ds · k`` in f32."""
    _check_bwd(q, k, v, do, lse=lse, delta=delta)
    _, ds = _bwd_plain(q, k, v, do, lse, delta, scale, window)
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, scale: float,
                        window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_bwd_dkv`: ``dsᵀ · q`` and ``pᵀ · dO``
    in f32."""
    _check_bwd(q, k, v, do, lse=lse, delta=delta)
    p, ds = _bwd_plain(q, k, v, do, lse, delta, scale, window)
    return (torch.einsum("bqk,bqd->bkd", ds, q.float()).to(k.dtype),
            torch.einsum("bqk,bqd->bkd", p, do.float()).to(v.dtype))


def _launch_bwd(symbol, n_out, q, k, v, do, lse, delta, scale, window):
    """Launches ``<symbol>_launch`` of ``csrc/flash_attn_bwd.cu`` on CUDA
    operands; -> its ``n_out`` outputs, each shaped and typed as q."""
    check_kernel_operands(q, k, v)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.shape[0] > 65535:
        raise ValueError(f"the flash kernels take at most 65535 batch-heads "
                         f"(their grid's y), got {q.shape[0]}")
    ins = [t.contiguous() for t in (q, k, v, do, lse, delta)]
    outs = [torch.empty_like(ins[0]) for _ in range(n_out)]
    BH, S, hd = ins[0].shape
    fn = getattr(_build.load("flash_attn_bwd"), f"{symbol}_launch")
    fn.argtypes = [ctypes.c_void_p] * (6 + n_out) + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*(t.data_ptr() for t in ins + outs), BH, S, hd, float(scale),
             int(window), int(q.dtype == torch.bfloat16),
             _build.stream_ptr(q.device))
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {err}")
    return outs


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                 scale: float, window: int = 0) -> torch.Tensor:
    """dQ [BH,S,hd] in q's type from q, k, v, dO and the f32 LSE and delta
    rows.  Launches ``flash_bwd_dq_wgmma_kernel`` (bf16) or
    ``flash_bwd_dq_kernel`` (f32) for CUDA tensors; CPU tensors take
    :func:`flash_bwd_dq_plain`."""
    _check_bwd(q, k, v, do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, scale=scale,
                                  window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq runs on cuda or cpu, not {q.device}")
    (dq,) = _launch_bwd("flash_bwd_dq", 1, q, k, v, do, lse, delta, scale,
                        window)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0  # kernel launches since the count was last reset


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                  scale: float, window: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [BH,S,hd] in the inputs' type, from the operands of
    :func:`flash_bwd_dq`.  Launches ``flash_bwd_dkv_wgmma_kernel`` (bf16)
    or ``flash_bwd_dkv_kernel`` (f32) for CUDA tensors; CPU tensors take
    :func:`flash_bwd_dkv_plain`."""
    _check_bwd(q, k, v, do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale=scale,
                                   window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv runs on cuda or cpu, not {q.device}")
    dk, dv = _launch_bwd("flash_bwd_dkv", 2, q, k, v, do, lse, delta, scale,
                         window)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0  # kernel launches since the count was last reset


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
              scale: float, window: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (dQ, dK, dV) in the inputs' type.  On CUDA tensors: delta, then
    the two backward kernels; CPU tensors take :func:`flash_bwd_plain`."""
    _check_bwd(q, k, v, do, o, lse=lse)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, scale=scale, window=window)
    delta = flash_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale=scale, window=window)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale=scale, window=window)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: :func:`flash_fwd` forward, saving q,
    k, v, O and LSE; :func:`flash_bwd` backward on ``dO.contiguous()``."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, window: int):
        o, lse = flash_fwd(q, k, v, scale=scale, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.window = scale, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(),
                               scale=ctx.scale, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, window: int = 0, bq: int = DEFAULT_BQ,
                    bk: int = DEFAULT_BK) -> torch.Tensor:
    """q, k, v: [BH, S, hd] (KV pre-repeated to full heads), causal; -> O,
    differentiable through :class:`FlashAttention` on either device.  S
    must divide by ``bq`` and ``bk``, the reference's block sizes."""
    _check(q, k, v)
    S = q.shape[1]
    if bq <= 0 or bk <= 0 or S % bq or S % bk:
        raise ValueError(f"flash_attention: sequence length {S} must be a "
                         f"multiple of the block sizes bq={bq} and bk={bk}")
    return FlashAttention.apply(q, k, v, float(scale), int(window))


def flash_hbm_bytes(B, H, S, hd, dtype_bytes=2, *, train: bool,
                    bq: int = 1024, bk: int = 512) -> float:
    """The reference's analytic per-call HBM traffic of its TPU kernel
    (K/V re-read once per q-block), kept for comparison: Q + KV·nq + O +
    LSE forward, plus the backward's streams when ``train``.  The least
    traffic any kernel needs (each operand read once, each output written
    once) is ``4·B·H·S·hd·dtype_bytes + 4·B·H·S`` forward."""
    nq = max(S // min(bq, S), 1)
    nk = max(S // min(bk, S), 1)
    t = B * H * S * hd * dtype_bytes
    row = B * H * S * 4
    fwd = t + 2 * nq * t + t + row                    # Q + KV*nq + O + lse
    if not train:
        return fwd
    bwd_dq = t + 2 * nq * t + 2 * t + 2 * row + t
    bwd_dkv = 2 * t + (2 * t) * nk + 2 * row + 2 * t
    delta = 2 * t + row                               # rowsum(do*o)
    return fwd + bwd_dq + bwd_dkv + delta
