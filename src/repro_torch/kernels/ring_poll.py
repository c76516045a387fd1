"""Mailbox ring poll: device-side frame validation.

The device mailbox (``core/device_mailbox.py``) stores word-oriented frames
in each ring slot:

    w0 magic        0x1F5C0DE5
    w1 frame_words  total payload words (<= slot_words - HDR - 1)
    w2 code_kind
    w3 name_hash
    w4 hdr_check    = magic ^ frame_words ^ code_kind ^ name_hash
    w5..            body (payload words)
    w[5+frame_words] trailer 0xD0E1F2A3

For every slot the poll emits a status: 0=EMPTY, 1=READY, 2=INFLIGHT
(header ok, trailer missing), 3=BAD (corrupt header / bounds).

Words are uint32 on the wire and int32 in PyTorch (its uint32 support on
CUDA is thin); both versions here compare them as unsigned bit patterns.
:func:`ring_poll` launches the CUDA kernel (``csrc/ring_poll.cu``) on a CUDA
tensor and runs :func:`ring_poll_plain` on a CPU tensor.  The singleton
lane does not call it: its sweep polls inside one fused launch
(``kernels/ifunc_vm.py`` :func:`ifunc_vm_sweep`) with the same logic.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAGIC = 0x1F5C0DE5
TRAILER = 0xD0E1F2A3
HDR_WORDS = 5

EMPTY, READY, INFLIGHT, BAD = 0, 1, 2, 3

_U32 = 0xFFFFFFFF


def _check(slots: torch.Tensor) -> None:
    if not isinstance(slots, torch.Tensor):
        raise TypeError(f"slots must be a tensor, got {type(slots).__name__}")
    if slots.dtype != torch.int32:
        raise TypeError(f"slots must be int32 words, got {slots.dtype}")
    if slots.dim() != 2 or slots.shape[1] < HDR_WORDS + 1:
        raise ValueError(f"slots must be [n_slots, slot_words >= "
                         f"{HDR_WORDS + 1}], got {tuple(slots.shape)}")


def ring_poll_plain(slots: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: int32 [n_slots, slot_words] -> int32 status."""
    _check(slots)
    W = slots.shape[1]
    hdr = slots[:, :HDR_WORDS].to(torch.int64) & _U32    # unsigned words
    magic, fw, kind, nh, chk = hdr.unbind(1)
    hdr_ok = (magic == MAGIC) & (chk == (magic ^ fw ^ kind ^ nh))
    bounds_ok = fw <= W - HDR_WORDS - 1
    idx = torch.clamp(HDR_WORDS + fw, max=W - 1)
    trailer = slots.gather(1, idx[:, None])[:, 0].to(torch.int64) & _U32
    st = torch.where(trailer == TRAILER, READY, INFLIGHT)
    st = torch.where(hdr_ok & bounds_ok, st, BAD)
    st = torch.where(magic == 0, EMPTY, st)
    return st.to(torch.int32)


def ring_poll(slots: torch.Tensor) -> torch.Tensor:
    """int32 [n_slots, slot_words] -> int32 [n_slots] status.  Launches the
    CUDA kernel for a CUDA tensor; a CPU tensor takes the plain version."""
    _check(slots)
    if slots.device.type == "cpu":
        return ring_poll_plain(slots)
    if slots.device.type != "cuda":
        raise ValueError(f"ring_poll runs on cuda or cpu, not {slots.device}")
    if not slots.is_contiguous():
        raise ValueError("ring_poll needs a contiguous slot array")
    n, W = slots.shape
    status = torch.empty(n, dtype=torch.int32, device=slots.device)
    fn = _build.load("ring_poll").ring_poll_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(slots.data_ptr(), n, W, status.data_ptr(),
             _build.stream_ptr(slots.device))
    if err:
        raise RuntimeError(f"ring_poll kernel launch failed: cudaError {err}")
    ring_poll.launches += 1
    return status


ring_poll.launches = 0     # kernel launches since the count was last reset
