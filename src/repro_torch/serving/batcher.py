"""Continuous batching: a fixed-slot decode engine where every slot tracks
its own position — the reference's ``repro.serving.batcher``.

The cache uses the per-slot layout (``models.transformer.init_cache(...,
per_slot=True)``): ``attention_decode`` takes a ``[B]`` position vector,
each row writes its own ring slot and masks against its own validity row,
and sequences join and leave mid-wave — admission is a row write, never a
barrier.  Admission and ticks run under ``torch.inference_mode()``, so
parameters that require a gradient build no graph.  The reference's
``Obs`` counters and tracer come with the serving slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train import serve as SRV


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = field(default_factory=list)


def synth_slot_pos(pos0: int, width: int) -> np.ndarray:
    """Reconstruct a prefilled sequence's ring occupancy from its length:
    positions 0..pos0-1 occupy slots 0..pos0-1, the rest are empty (-1)."""
    row = np.full((width,), -1, np.int32)
    row[:pos0] = np.arange(pos0, dtype=np.int32)
    return row


class ContinuousBatcher:
    """B decode slots over one per-slot cache on ``device``; sequences
    admitted and retired independently per tick."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int,
                 cache_len: int, *, device="cuda", name: str = "decode"):
        self.cfg, self.params = cfg, params
        self.B, self.W = batch_slots, cache_len
        self.name = name
        self.device = resolve_device(device)
        self.cache = T.init_cache(cfg, batch_slots, cache_len, per_slot=True,
                                  device=self.device)
        self.pos = np.zeros(batch_slots, np.int32)      # per-slot next position
        self.tokens = np.zeros((batch_slots, 1), np.int32)
        self.active: dict[int, Request] = {}            # slot -> request
        self._decode = SRV.jit_decode_step(cfg, donate=True)
        self._one = T.cache_shapes(cfg, 1, cache_len, per_slot=True)
        self._full = T.cache_shapes(cfg, batch_slots, cache_len, per_slot=True)

    def free_slots(self) -> list[int]:
        return [s for s in range(self.B) if s not in self.active]

    @torch.inference_mode()
    def install(self, slot: int, cache1: dict, pos0: int, first_token: int,
                req: Request) -> None:
        """Splice one prefilled sequence (a single-sequence cache at seq
        width <= W, with or without ``slot_pos`` entries) into decode slot
        ``slot`` and activate it.  A row write: every other slot keeps
        decoding undisturbed."""
        if slot in self.active:
            raise ValueError(f"slot {slot} already active")
        if not (0 < pos0 <= self.W):
            raise ValueError(f"pos0 {pos0} outside cache width {self.W}")
        src = dict(cache1)
        for k, tgt in self._one.items():
            if k not in src and k.endswith("slot_pos"):
                base = synth_slot_pos(pos0, tgt.shape[-1])
                src[k] = torch.from_numpy(
                    np.ascontiguousarray(np.broadcast_to(base, tgt.shape))
                ).to(self.device)
        src = SRV.pad_cache_to(src, self._one)
        for k in self.cache:
            bdim = next((i for i, (a, b) in enumerate(
                zip(self._full[k].shape, self._one[k].shape)) if a != b), None)
            row = src[k].to(self.device, self.cache[k].dtype)
            if bdim is None:            # batch-free entry: shared write
                self.cache[k] = row
            else:
                idx = tuple([slice(None)] * bdim + [slice(slot, slot + 1)])
                self.cache[k][idx] = row
        self.tokens[slot, 0] = int(first_token)
        self.pos[slot] = pos0
        self.active[slot] = req
        req.out.append(int(first_token))

    @torch.inference_mode()
    def tick(self) -> tuple[int, list[Request]]:
        """One decode step for all active slots.  Returns (#tokens emitted,
        finished requests) — completion surfaces here, never at
        admission."""
        if not self.active:
            return 0, []
        self.cache, logits = self._decode(
            self.params, self.cache,
            torch.from_numpy(self.tokens).to(self.device),
            torch.from_numpy(self.pos).to(self.device))
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32).cpu().numpy()
        emitted, finished = 0, []
        for slot, req in list(self.active.items()):
            tok = int(nxt[slot])
            req.out.append(tok)
            self.tokens[slot, 0] = tok
            self.pos[slot] += 1
            emitted += 1
            if len(req.out) >= req.max_new:
                del self.active[slot]
                self.pos[slot] = 0
                self.tokens[slot, 0] = 0
                finished.append(req)
        return emitted, finished


__all__ = ["Request", "ContinuousBatcher", "synth_slot_pos"]
