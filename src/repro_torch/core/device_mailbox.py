"""On-device ifunc mailbox: ring buffers in device memory, deposited by a
one-sided put, then polled, executed and cleared by one sweep kernel a
ring visit — paper Fig. 2 inside one device program.

On one card the mesh's shard axis is the leading dimension of the mailbox
tensor, ``[n_shards, n_slots, slot_words]`` int32 (the words' uint32 bit
patterns).  Word-frame layout (matches ``kernels/ring_poll.py``):

    w0 magic | w1 frame_words | w2 code_kind | w3 name_hash | w4 hdr_check
    w5..5+frame_words-1 body (f32 payload bit-cast) | then trailer word

An aggregate slot (``make_agg_sweep``) holds K sub-record bodies behind
one container header instead; its layout is in ``kernels/agg_poll.py``.

The μVM program is bound when the sweep is built (the device-side link
cache): one sweep handles any number of arriving frames of that ifunc.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.codegen import UvmProgram
from repro_torch.device import resolve_device
from repro_torch.kernels.agg_poll import AGG_MAGIC, SUB_SALT
from repro_torch.kernels.ifunc_vm import (ifunc_vm_agg_sweep, ifunc_vm_sweep,
                                          ifunc_vm_sweep_plain)
from repro_torch.kernels.ring_poll import HDR_WORDS, MAGIC, TRAILER


def pack_word_frame(payload_f32: np.ndarray, slot_words: int, kind: int = 3,
                    name_hash: int = 0xABC, *, corrupt: bool = False,
                    no_trailer: bool = False) -> np.ndarray:
    """Host-side framing of one device frame into a slot's uint32 words."""
    body = np.asarray(payload_f32, np.float32).reshape(-1).view(np.uint32)
    fw = len(body)
    if fw > slot_words - HDR_WORDS - 1:
        raise ValueError(f"payload of {fw} words too long for a "
                         f"{slot_words}-word slot")
    s = np.zeros(slot_words, np.uint32)
    s[0], s[1], s[2], s[3] = MAGIC, fw, kind, name_hash
    s[4] = (int(s[0]) ^ int(s[1]) ^ int(s[2]) ^ int(s[3])) ^ (1 if corrupt else 0)
    s[HDR_WORDS:HDR_WORDS + fw] = body
    if not no_trailer:
        s[HDR_WORDS + fw] = TRAILER
    return s


def pack_agg_word_frame(payloads, hashes, agg_k: int, body_words: int,
                        slot_words: int, kind: int = 3, *,
                        corrupt: bool = False, corrupt_sub: int | None = None,
                        no_trailer: bool = False) -> np.ndarray:
    """Host-side framing of one aggregate container (a batch of up to K
    sub-records) into a slot's uint32 words.  ``corrupt`` poisons the
    container's check word (the whole container is rejected);
    ``corrupt_sub`` poisons one descriptor's check word (that sub-record
    alone reads SUB_BAD, its siblings unharmed)."""
    n = len(payloads)
    if n != len(hashes) or n > agg_k:
        raise ValueError(f"{n} payloads with {len(hashes)} hashes for a "
                         f"container of agg_k={agg_k}")
    if slot_words < HDR_WORDS + 2 * agg_k + agg_k * body_words + 1:
        raise ValueError(f"{slot_words}-word slot too small for agg_k="
                         f"{agg_k} bodies of {body_words} words")
    s = np.zeros(slot_words, np.uint32)
    s[0], s[1], s[2], s[3] = AGG_MAGIC, n, kind, 0
    s[4] = (int(s[0]) ^ int(s[1]) ^ int(s[2]) ^ int(s[3])) ^ (1 if corrupt else 0)
    for i, (p, h) in enumerate(zip(payloads, hashes)):
        body = np.asarray(p, np.float32).reshape(-1).view(np.uint32)
        if len(body) != body_words:
            raise ValueError(f"sub body of {len(body)} words != bound "
                             f"{body_words}")
        d = HDR_WORDS + 2 * i
        s[d] = h & 0xFFFFFFFF
        s[d + 1] = (int(s[d]) ^ SUB_SALT) & 0xFFFFFFFF
        if corrupt_sub == i:
            s[d + 1] ^= 1
        off = HDR_WORDS + 2 * agg_k + i * body_words
        s[off:off + body_words] = body
    if not no_trailer:
        s[slot_words - 1] = TRAILER
    return s


def empty_mailbox(n_shards: int, n_slots: int, slot_words: int, *,
                  device="cuda") -> torch.Tensor:
    return torch.zeros(n_shards, n_slots, slot_words, dtype=torch.int32,
                       device=resolve_device(device))


def make_deposit(n_shards: int):
    """Build ``deposit(mailbox, outgoing, shift)``: every shard one-sided
    'puts' its outgoing slot frames into the ring of the shard ``shift``
    along (the reference's ``ppermute`` over the mesh axis, here a roll of
    the leading dimension).

    The deposit is slot-masked like a real one-sided put: only slots the
    sender wrote (magic word != 0) land; everything else in the target ring
    — including frames from an earlier deposit not swept yet — is left as
    it was."""

    def deposit(mailbox: torch.Tensor, outgoing: torch.Tensor,
                shift: int) -> torch.Tensor:
        if mailbox.shape != outgoing.shape or mailbox.shape[0] != n_shards:
            raise ValueError(f"deposit of {tuple(outgoing.shape)} into "
                             f"{tuple(mailbox.shape)} ({n_shards} shards)")
        arrived = torch.roll(outgoing, shifts=shift, dims=0)
        return torch.where(arrived[..., :1] != 0, arrived, mailbox)

    return deposit


def sweep_plain(prog: UvmProgram, mailbox: torch.Tensor, ext: torch.Tensor,
                n_tiles: int, tile: int = 128):
    """The plain version of a singleton sweep (what ``make_sweep`` runs on a
    CPU mailbox): ``ring_poll_plain``, ``ifunc_vm_plain`` over every slot's
    body tiles copied out, outputs of slots that are not READY set to
    +0.0, READY and BAD slots cleared in place.  Returns (status, results,
    cleared) with ``cleared`` the ``mailbox`` passed in."""
    S, N, W = mailbox.shape
    status, out = ifunc_vm_sweep_plain(prog, mailbox.view(S * N, W),
                                       HDR_WORDS, n_tiles, ext)
    return (status.view(S, N), out.view(S, N, n_tiles, tile, tile), mailbox)


def agg_sweep_plain(prog: UvmProgram, mailbox: torch.Tensor,
                    ext: torch.Tensor, agg_k: int, n_tiles: int,
                    tile: int = 128, *, bound_hash: int = 0):
    """The plain version of an aggregate sweep (what ``make_agg_sweep``
    runs on a CPU mailbox): ``agg_ring_poll_plain``, ``ifunc_vm_plain``
    over every sub-record's body tiles copied out, outputs of sub-records
    that are not SUB_READY set to +0.0, READY and BAD containers cleared
    in place.  Returns (status, sub_status, results, cleared) with
    ``cleared`` the ``mailbox`` passed in."""
    S, N, W = mailbox.shape
    status, sub, out = ifunc_vm_sweep_plain(
        prog, mailbox.view(S * N, W), HDR_WORDS + 2 * agg_k, agg_k * n_tiles,
        ext, agg_k=agg_k, bound_hash=bound_hash)
    return (status.view(S, N), sub.view(S, N, agg_k),
            out.view(S, N, agg_k, n_tiles, tile, tile), mailbox)


def make_sweep(prog: UvmProgram, n_tiles: int, tile: int = 128):
    """Build ``sweep(mailbox, externals)`` -> (status, results, cleared_mb).

    On a CUDA mailbox one launch of ``ring_sweep_smem_kernel`` (or
    ``ring_sweep_global_kernel`` for a program whose plan needs more than
    three tiles) does the whole sweep: it polls every slot as ``ring_poll``
    does, runs the bound μVM program over the frame bodies of READY slots
    where they lie in the mailbox (tile ``t`` of shard ``s`` reading
    ``externals[s]``), writes +0.0 over the outputs of every other slot,
    and clears consumed slots: READY ones, and BAD ones so a corrupt
    frame is reported once.  The clear is **in place**: ``cleared_mb`` is
    the ``mailbox`` passed in, with INFLIGHT and EMPTY slots untouched.  A
    CPU mailbox takes :func:`sweep_plain`, with the same contract.
    ``externals`` is ``[n_shards, n_ext, T, T]``; results are
    ``[n_shards, n_slots, n_tiles, T, T]``."""

    def sweep(mailbox: torch.Tensor, ext: torch.Tensor):
        if mailbox.device.type == "cpu":
            return sweep_plain(prog, mailbox, ext, n_tiles, tile)
        S, N, W = mailbox.shape
        status, out = ifunc_vm_sweep(prog, mailbox.view(S * N, W), HDR_WORDS,
                                     n_tiles, ext)
        return (status.view(S, N), out.view(S, N, n_tiles, tile, tile),
                mailbox)

    return sweep


def make_agg_sweep(prog: UvmProgram, agg_k: int, n_tiles: int,
                   tile: int = 128, *, bound_hash: int = 0):
    """Build ``sweep(mailbox, externals)`` for aggregate-container slots
    -> (status, sub_status, results, cleared_mb).

    On a CUDA mailbox one launch of ``agg_sweep_smem_kernel`` (or
    ``agg_sweep_global_kernel``) does the whole sweep over every
    sub-record of every slot (``n_shards * n_slots * K * n_tiles`` tiles,
    tile ``t`` of shard ``s`` reading ``externals[s]``): it polls each
    container header and each sub-record's descriptor as
    ``agg_ring_poll`` does, runs the program over SUB_READY bodies where
    they lie, writes +0.0 over every other output, and clears READY and
    BAD containers **in place**: ``cleared_mb`` is the ``mailbox`` passed
    in, with INFLIGHT and EMPTY slots untouched.  The fixed cost of a
    sweep is one launch a ring visit, whatever K.  A CPU mailbox takes
    :func:`agg_sweep_plain`.  ``results`` is ``[n_shards, n_slots, K,
    n_tiles, T, T]``."""

    def sweep(mailbox: torch.Tensor, ext: torch.Tensor):
        if mailbox.device.type == "cpu":
            return agg_sweep_plain(prog, mailbox, ext, agg_k, n_tiles, tile,
                                   bound_hash=bound_hash)
        S, N, W = mailbox.shape
        status, sub, out = ifunc_vm_agg_sweep(
            prog, mailbox.view(S * N, W), agg_k, HDR_WORDS + 2 * agg_k,
            agg_k * n_tiles, ext, bound_hash)
        return (status.view(S, N), sub.view(S, N, agg_k),
                out.view(S, N, agg_k, n_tiles, tile, tile), mailbox)

    return sweep
