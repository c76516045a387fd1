"""Chunked Mamba-2 SSD scan: per (batch*head) row, an ``[hd, ds]`` f32
state carried from chunk to chunk.

Inputs (per bh row, chunked):
    x   [BH, nc, Q, hd]   inputs pre-multiplied by Δt
    la  [BH, nc, Q]       log-decay Δt·A (negative)
    Bm  [G, nc, Q, ds]    G divides BH: row bh reads group bh // (BH // G)
    Cm  [G, nc, Q, ds]
Output:
    y   [BH, nc, Q, hd]

G = BH is the reference's contract; G = B (the heads of a batch row share
B and C, Mamba-2's n_groups = 1) is what the reference computes after its
``broadcast_to``, without the copy.

Per chunk, with ``cum = cumsum(la)`` and ``L = tril(exp(cum_i - cum_j))``:
``y = (C Bᵀ ∘ L) x + exp(cum) ∘ (C stateᵀ)``, then
``state = state·exp(cum[-1]) + (exp(cum[-1] - cum) ∘ x)ᵀ B``.

:func:`ssd_scan` launches the CUDA kernels (``csrc/ssd_scan.cu``: each
chunk's own state, the state recurrence, C Bᵀ once per group, then y;
four launches a call) on CUDA tensors and runs :func:`ssd_scan_plain` on
CPU tensors.  It has no
gradient, as the reference's Pallas kernel has no VJP: called where
autograd would record it, it raises :class:`SsdScanGradError` on either
device.  SSD training takes ``ssd_impl="xla"``.  On ``meta`` tensors
(``launch/dryrun.py``'s dry run) it checks and allocates as on CUDA
tensors (y and the scratch) and calls :func:`kernels.meta.launch` in
place of the launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, meta

KERNEL_MAX_HD, KERNEL_MAX_DS = 64, 128
KERNEL_MAX_Q = 16384          # cum of one chunk in shared memory


class SsdScanGradError(RuntimeError):
    """``ssd_scan`` was asked for a gradient, which it does not have."""


def _check(x, la, Bm, Cm) -> None:
    for name, t in (("x", x), ("la", la), ("Bm", Bm), ("Cm", Cm)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if x.dim() != 4:
        raise ValueError(f"x must be [BH, nc, Q, hd], got {tuple(x.shape)}")
    BH, nc, Q, _ = x.shape
    if tuple(la.shape) != (BH, nc, Q):
        raise ValueError(f"la must be [{BH}, {nc}, {Q}], got {tuple(la.shape)}")
    if Bm.dim() != 4 or tuple(Bm.shape[1:3]) != (nc, Q) \
            or Bm.shape != Cm.shape or Bm.shape[0] < min(BH, 1):
        raise ValueError(f"Bm, Cm must be [G, {nc}, {Q}, ds], got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if Bm.shape[0] and BH % Bm.shape[0]:
        raise ValueError(f"Bm, Cm hold {Bm.shape[0]} groups, which do not "
                         f"divide BH = {BH}")
    if len({t.device for t in (x, la, Bm, Cm)}) != 1:
        raise ValueError("x, la, Bm, Cm on different devices")


def ssd_scan_plain(x: torch.Tensor, la: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, in f32: the chunk's whole ``[Q, Q]`` decay
    and score matrices, the chunk-final states and their recurrence."""
    _check(x, la, Bm, Cm)
    x, la, Bm, Cm = x.float(), la.float(), Bm.float(), Cm.float()
    BH, nc, Q, hd = x.shape
    G, ds = Bm.shape[0], Bm.shape[-1]
    if G != BH:                                # each group to its rows
        Bm, Cm = (t[:, None].expand(G, BH // G, nc, Q, ds)
                  .reshape(BH, nc, Q, ds) for t in (Bm, Cm))
    cum = torch.cumsum(la, dim=2)
    seg = cum[..., :, None] - cum[..., None, :]
    tril = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    L = torch.where(tril, torch.exp(seg), 0.0)
    scores = torch.einsum("bcqn,bckn->bcqk", Cm, Bm) * L
    y_intra = torch.einsum("bcqk,bckh->bcqh", scores, x)

    tail = torch.exp(cum[..., -1:] - cum)
    states = torch.einsum("bckh,bck,bckn->bchn", x, tail, Bm)
    decay = torch.exp(cum[..., -1])
    h = torch.zeros(BH, hd, ds, dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):                        # state BEFORE each chunk
        h_prev.append(h)
        h = h * decay[:, c, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)
    y_inter = torch.einsum("bcqn,bchn->bcqh", Cm, h_prev) \
        * torch.exp(cum)[..., None]
    return y_intra + y_inter


def ssd_scan(x: torch.Tensor, la: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor) -> torch.Tensor:
    """x [BH,nc,Q,hd], la [BH,nc,Q], Bm/Cm [G,nc,Q,ds] (G divides BH) ->
    y [BH,nc,Q,hd].  Launches the CUDA kernels for CUDA tensors (f32,
    hd <= 64, ds <= 128), a scratch of cum, states and C Bᵀ per group;
    CPU tensors take the plain version, meta tensors the launch's shapes;
    BH 0 (and G 0) launches nothing.  Refuses, on every device, inputs
    that require a gradient while grad mode is on."""
    _check(x, la, Bm, Cm)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, la, Bm, Cm)):
        raise SsdScanGradError(
            "ssd_scan has no gradient (the reference's SSD kernel has no "
            "VJP): train SSD blocks with ssd_impl='xla', or call ssd_scan "
            "under torch.no_grad() / torch.inference_mode()")
    if not x.shape[0]:
        return torch.empty_like(x)  # no row (a rank's empty tile): no launch
    if x.device.type == "cpu":
        return ssd_scan_plain(x, la, Bm, Cm)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    for name, t in (("x", x), ("la", la), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype != torch.float32:
            raise TypeError(f"the ssd_scan kernel takes float32; {name} is "
                            f"{t.dtype}")
    BH, nc, Q, hd = x.shape
    G, ds = Bm.shape[0], Bm.shape[-1]
    if not (0 < hd <= KERNEL_MAX_HD and 0 < ds <= KERNEL_MAX_DS
            and Q <= KERNEL_MAX_Q):
        raise ValueError(f"the ssd_scan kernel takes hd <= {KERNEL_MAX_HD}, "
                         f"ds <= {KERNEL_MAX_DS} and Q <= {KERNEL_MAX_Q}; got "
                         f"hd {hd}, ds {ds}, Q {Q}")
    x, la, Bm, Cm = (t.contiguous() for t in (x, la, Bm, Cm))
    y = torch.empty_like(x)
    cum = torch.empty_like(la)
    states = x.new_empty(BH, nc, ds, hd)       # each chunk's, then h_prev
    cb = x.new_empty(G, nc, Q, Q)              # C Bᵀ, lower tiles written
    if x.device.type == "meta":
        meta.launch("ssd_scan", (x, la, Bm, Cm, y, cum, states, cb),
                    ssd_flops(BH, G, nc, Q, hd, ds))
        return y
    fn = _build.load("ssd_scan").ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), la.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             y.data_ptr(), cum.data_ptr(), states.data_ptr(), cb.data_ptr(),
             BH, G, nc, Q, hd, ds, _build.stream_ptr(x.device))
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    ssd_scan.launches += 1
    ssd_scan.shapes.add((BH, nc, Q, hd, ds, G))
    return y


ssd_scan.launches = 0      # calls that launched the kernels, since reset
ssd_scan.shapes = set()    # their [BH, nc, Q, hd, ds, G], since reset


def ssd_flops(BH: int, G: int, nc: int, Q: int, hd: int, ds: int) -> int:
    """Operations of one call: C Bᵀ's lower triangle once per group, the
    score-x product's lower triangle and the two state products per row."""
    P = Q * (Q + 1) // 2                       # lower-triangle pairs
    return nc * G * 2 * P * ds + BH * nc * (2 * P * hd + 4 * Q * hd * ds)


def ssd_hbm_bytes(B, nh, S, hd, ds, *, train: bool, dtype_bytes=2) -> float:
    """The reference's analytic per-layer HBM traffic of its TPU SSD
    kernel: the chunked inputs (x, la, B, C), output y and the
    inter-chunk state stream, once forward (about 3x for train)."""
    x_b = B * nh * S * hd * dtype_bytes
    bc_b = 2 * B * S * ds * dtype_bytes
    la_b = B * nh * S * 4
    nc = max(S // 256, 1)
    state_b = B * nc * nh * hd * ds * 4
    fwd = 2 * x_b + bc_b + la_b + state_b
    return fwd * (3.0 if train else 1.0)
