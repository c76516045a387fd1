"""On-device ifunc mailbox: ring buffers in device memory, deposited by a
one-sided put and validated by the ``ring_poll`` kernel — paper Fig. 2
inside one device program.

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
from repro_torch.kernels.agg_poll import (AGG_MAGIC, SUB_READY, SUB_SALT,
                                          agg_ring_poll)
from repro_torch.kernels.ifunc_vm import ifunc_vm_slots
from repro_torch.kernels.ring_poll import (BAD, HDR_WORDS, MAGIC, READY,
                                           TRAILER, ring_poll)


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


def make_sweep(prog: UvmProgram, n_tiles: int, tile: int = 128):
    """Build ``sweep(mailbox, externals)`` -> (status, results, cleared_mb).

    Validates every slot with ``ring_poll``, runs the bound μVM program
    over every slot's frame body in one ``ifunc_vm`` launch that reads the
    f32 payload tiles where they lie in the mailbox (tile ``t`` of shard
    ``s`` reading ``externals[s]``), keeps the outputs of READY slots
    only, and clears consumed slots: READY ones, and BAD ones so a corrupt
    frame is reported once.  ``externals`` is ``[n_shards, n_ext, T, T]``."""

    def sweep(mailbox: torch.Tensor, ext: torch.Tensor):
        S, N, W = mailbox.shape
        flat = mailbox.reshape(S * N, W)
        status = ring_poll(flat).reshape(S, N)
        out = ifunc_vm_slots(prog, flat, HDR_WORDS, n_tiles, ext)
        out = out.reshape(S, N, n_tiles, tile, tile)
        ready = status == READY
        out = torch.where(ready[:, :, None, None, None], out, 0.0)
        done = ready | (status == BAD)
        cleared = torch.where(done[:, :, None], 0, mailbox)
        return status, out, cleared

    return sweep


def make_agg_sweep(prog: UvmProgram, agg_k: int, n_tiles: int,
                   tile: int = 128, *, bound_hash: int = 0):
    """Build ``sweep(mailbox, externals)`` for aggregate-container slots
    -> (status, sub_status, results, cleared_mb).

    One ``agg_ring_poll`` validates every container header and all K
    descriptors per slot, reading the mailbox in place through strided
    views; ONE ``ifunc_vm`` launch runs every sub-record body of every
    slot where it lies in the mailbox (``n_shards * n_slots * K *
    n_tiles`` tiles, tile ``t`` of shard ``s`` reading ``externals[s]``),
    so the fixed cost of a sweep is paid once per ring visit, not once
    per sub-record.  Outputs of sub-records that are not SUB_READY are
    zeroed; READY and BAD containers are cleared.  ``results`` is
    ``[n_shards, n_slots, K, n_tiles, T, T]``."""
    hdr_words = HDR_WORDS + 2 * agg_k

    def sweep(mailbox: torch.Tensor, ext: torch.Tensor):
        S, N, W = mailbox.shape
        flat = mailbox.reshape(S * N, W)
        status, sub = agg_ring_poll(flat[:, :hdr_words], flat[:, -1:],
                                    bound_hash)
        status, sub = status.reshape(S, N), sub.reshape(S, N, agg_k)
        out = ifunc_vm_slots(prog, flat, hdr_words, agg_k * n_tiles, ext)
        out = out.reshape(S, N, agg_k, n_tiles, tile, tile)
        out = torch.where((sub == SUB_READY)[..., None, None, None], out, 0.0)
        done = (status == READY) | (status == BAD)
        cleared = torch.where(done[:, :, None], 0, mailbox)
        return status, sub, out, cleared

    return sweep
