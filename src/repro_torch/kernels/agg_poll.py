"""Aggregate-container ring poll: device-side validation of K-sub-record
word-frame batches in one pass.

A device aggregate container packs K sub-record bodies behind one
container header (the word-frame mirror of the byte layout in
``core/frame.py``):

    w0 magic        0x1F5C0DE6  (container magic, distinct from singleton)
    w1 n_subs       occupied sub-records (<= agg_k)
    w2 code_kind
    w3 reserved     0
    w4 hdr_check    = magic ^ n_subs ^ code_kind ^ reserved
    w5..5+2K-1      K descriptor pairs [name_hash_i, sub_check_i]
                    with sub_check_i = name_hash_i ^ SUB_SALT
    then K x body_words sub bodies (f32 tiles bit-cast), unoccupied zero
    w[slot_words-1] trailer 0xD0E1F2A3 (fixed tail position: the layout is
                    static per agg_k, unlike the singleton frame)

One *container* status per slot (EMPTY / READY / INFLIGHT / BAD, the
lattice of ``ring_poll``) plus K per-sub statuses:

    SUB_EMPTY  0   i >= n_subs, or the container is not READY
    SUB_READY  1   descriptor self-consistent and name_hash matches the
                   mailbox-bound program hash (bound 0 = any hash)
    SUB_BAD    3   descriptor check mismatch: a poisoned sub-record, its
                   siblings unharmed
    SUB_NACK   4   descriptor consistent but the hash is not the bound
                   program's: the source rebuilds this record alone

A corrupt container header (or a missing trailer) rejects the whole
container: its per-sub fields cannot be trusted.

Words are uint32 on the wire and int32 in PyTorch; both versions compare
them as unsigned bit patterns, so ``n_subs = 0xFFFFFFFF`` is out of
bounds and a hash with the high bit set matches its bound.
:func:`agg_ring_poll` launches the CUDA kernel (``csrc/agg_poll.cu``) on
CUDA tensors and runs :func:`agg_ring_poll_plain` on CPU tensors.  The
aggregate lane does not call it: its sweep polls inside one fused launch
(``kernels/ifunc_vm.py`` :func:`ifunc_vm_agg_sweep`) with the same logic.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ring_poll import (BAD, EMPTY, HDR_WORDS, INFLIGHT,
                                           READY, TRAILER)

AGG_MAGIC = 0x1F5C0DE6
SUB_SALT = 0x5A17A9E5

SUB_EMPTY, SUB_READY, SUB_BAD, SUB_NACK = 0, 1, 3, 4

_U32 = 0xFFFFFFFF


def _check(hdr_tbl: torch.Tensor, trailers: torch.Tensor) -> int:
    """Validate the operands; return K."""
    for name, t in (("hdr_tbl", hdr_tbl), ("trailers", trailers)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got "
                            f"{type(t).__name__}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 words, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
    n, hw = hdr_tbl.shape
    if hw < HDR_WORDS or (hw - HDR_WORDS) % 2:
        raise ValueError(f"hdr_tbl must be [n_slots, {HDR_WORDS} + 2K], got "
                         f"{tuple(hdr_tbl.shape)}")
    if tuple(trailers.shape) != (n, 1):
        raise ValueError(f"trailers must be [{n}, 1], got "
                         f"{tuple(trailers.shape)}")
    if trailers.device != hdr_tbl.device:
        raise ValueError(f"trailers on {trailers.device}, hdr_tbl on "
                         f"{hdr_tbl.device}")
    return (hw - HDR_WORDS) // 2


def agg_ring_poll_plain(hdr_tbl: torch.Tensor, trailers: torch.Tensor,
                        bound: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (int32 [n], int32 [n, K])."""
    k = _check(hdr_tbl, trailers)
    hdr = hdr_tbl.to(torch.int64) & _U32                 # unsigned words
    magic, n_subs, kind, rsvd, chk = hdr[:, :HDR_WORDS].unbind(1)
    hdr_ok = (magic == AGG_MAGIC) & (chk == (magic ^ n_subs ^ kind ^ rsvd))
    bounds_ok = n_subs <= k
    trailer_ok = (trailers[:, 0].to(torch.int64) & _U32) == TRAILER
    st = torch.where(trailer_ok, READY, INFLIGHT)
    st = torch.where(hdr_ok & bounds_ok, st, BAD)
    st = torch.where(magic == 0, EMPTY, st)

    desc = hdr[:, HDR_WORDS:].reshape(hdr.shape[0], k, 2)
    hashes, checks = desc[..., 0], desc[..., 1]
    b = int(bound) & _U32
    ok = checks == (hashes ^ SUB_SALT)
    match = (hashes == b) | (b == 0)
    sub = torch.where(ok & match, SUB_READY,
                      torch.where(ok, SUB_NACK, SUB_BAD))
    occupied = torch.arange(k, device=hdr.device)[None] < n_subs[:, None]
    sub = torch.where(occupied & (st == READY)[:, None], sub, SUB_EMPTY)
    return st.to(torch.int32), sub.to(torch.int32)


def agg_ring_poll(hdr_tbl: torch.Tensor, trailers: torch.Tensor,
                  bound: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Validate every aggregate slot's header block in one pass.

    hdr_tbl:  int32 [n_slots, HDR_WORDS + 2K] (container header and
              descriptors; rows may be strided, words contiguous)
    trailers: int32 [n_slots, 1] (the fixed tail word of each slot)
    bound:    the mailbox-bound program hash, uint32 (0 = any hash)
    -> (status int32 [n_slots], sub_status int32 [n_slots, K])

    Launches the CUDA kernel for CUDA tensors; CPU tensors take the plain
    version.  Strided views of the mailbox (``mb[:, :5 + 2K]``,
    ``mb[:, -1:]``) go to the kernel as they are, with their row
    strides."""
    k = _check(hdr_tbl, trailers)
    if hdr_tbl.device.type == "cpu":
        return agg_ring_poll_plain(hdr_tbl, trailers, bound)
    if hdr_tbl.device.type != "cuda":
        raise ValueError(f"agg_ring_poll runs on cuda or cpu, not "
                         f"{hdr_tbl.device}")
    if hdr_tbl.stride(1) != 1 and hdr_tbl.shape[1] > 1:
        raise ValueError("agg_ring_poll needs each header row's words "
                         "contiguous")
    n = hdr_tbl.shape[0]
    status = torch.empty(n, dtype=torch.int32, device=hdr_tbl.device)
    sub = torch.empty(n, k, dtype=torch.int32, device=hdr_tbl.device)
    fn = _build.load("agg_poll").agg_poll_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(hdr_tbl.data_ptr(), hdr_tbl.stride(0), trailers.data_ptr(),
             trailers.stride(0), n, k, int(bound) & _U32, status.data_ptr(),
             sub.data_ptr(), _build.stream_ptr(hdr_tbl.device))
    if err:
        raise RuntimeError(f"agg_ring_poll kernel launch failed: "
                           f"cudaError {err}")
    agg_ring_poll.launches += 1
    return status, sub


agg_ring_poll.launches = 0  # kernel launches since the count was last reset
