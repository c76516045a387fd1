"""Continuous batching: a fixed-slot decode engine where every slot tracks
its own position — the reference's ``repro.serving.batcher``.

The cache uses the per-slot layout (``models.transformer.init_cache(...,
per_slot=True)``): ``attention_decode`` takes a ``[B]`` position vector,
each row writes its own ring slot and masks against its own validity row,
and sequences join and leave mid-wave — admission is a row write, never a
barrier.  Admission and ticks run under ``torch.inference_mode()``, so
parameters that require a gradient build no graph.  ``install`` takes
tensors (the host server's prefill) or numpy arrays (the f32 views of a
KV slab that landed on a decode peer) and moves each entry to the device
at prompt width before padding it to the cache width.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Obs
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
                 cache_len: int, *, obs: Obs | None = None,
                 name: str = "decode", device="cuda"):
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
        self.obs = obs if obs is not None else Obs(name)
        m = self.obs.metrics
        self._installed = m.counter(f"serve.{name}.installed")
        self._decoded = m.counter(f"serve.{name}.decoded")
        self._finished = m.counter(f"serve.{name}.finished")
        self.install_hist = m.histogram(f"serve.{name}.install_us")

    def free_slots(self) -> list[int]:
        return [s for s in range(self.B) if s not in self.active]

    @torch.inference_mode()
    def install(self, slot: int, cache1: dict, pos0: int, first_token: int,
                req: Request) -> None:
        """Splice one prefilled sequence (a single-sequence cache at seq
        width <= W, tensors or numpy arrays, with or without ``slot_pos``
        entries — a KV slab arrives without them) into decode slot
        ``slot`` and activate it.  A row write: every other slot keeps
        decoding undisturbed."""
        if slot in self.active:
            raise ValueError(f"slot {slot} already active")
        if not (0 < pos0 <= self.W):
            raise ValueError(f"pos0 {pos0} outside cache width {self.W}")
        t0 = time.perf_counter()
        # each entry crosses to the device at its prompt width; the padding
        # to the cache width happens there
        src = {k: torch.as_tensor(v, device=self.device)
               for k, v in cache1.items()}
        for k, tgt in self._one.items():
            if k not in src and k.endswith("slot_pos"):
                base = synth_slot_pos(pos0, tgt.shape[-1])
                src[k] = torch.from_numpy(
                    np.ascontiguousarray(np.broadcast_to(base, tgt.shape))
                ).to(self.device)
        src = SRV.pad_cache_to(src, self._one)
        tr = self.obs.tracer
        sp = tr.begin(f"kv_install:{self.name}", cat="serve",
                      actor=self.name, corr=req.rid) if tr.enabled else None
        for k in self.cache:
            bdim = next((i for i, (a, b) in enumerate(
                zip(self._full[k].shape, self._one[k].shape)) if a != b), None)
            row = src[k].to(self.cache[k].dtype)
            if bdim is None:            # batch-free entry: shared write
                self.cache[k].copy_(row)
            else:
                idx = tuple([slice(None)] * bdim + [slice(slot, slot + 1)])
                self.cache[k][idx] = row
        if sp is not None:
            tr.end(sp)
        self.tokens[slot, 0] = int(first_token)
        self.pos[slot] = pos0
        self.active[slot] = req
        req.out.append(int(first_token))
        self._installed.inc()
        self.install_hist.observe((time.perf_counter() - t0) * 1e6)

    @torch.inference_mode()
    def tick(self) -> tuple[int, list[Request]]:
        """One decode step for all active slots.  Returns (#tokens emitted,
        finished requests) — completion surfaces here, never at
        admission.  A ``decode_tick`` span covers it when tracing is on."""
        if not self.active:
            return 0, []
        tr = self.obs.tracer
        sp = tr.begin(f"decode_tick:{self.name}", cat="serve",
                      actor=self.name) if tr.enabled else None
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
        self._decoded.inc(emitted)
        self._finished.inc(len(finished))
        if sp is not None:
            tr.end(sp, tokens=emitted)
        return emitted, finished


__all__ = ["Request", "ContinuousBatcher", "synth_slot_pos"]
