"""Deterministic sharded token pipeline with background prefetch — the
reference's ``repro.data.pipeline``, copied (numpy and threads only).

* ``TokenDataset`` — a flat token stream: synthetic (seeded, reproducible)
  or file-backed (np.memmap over a raw uint16/uint32 token file).  Batches
  are pure functions of ``(step, shard_id, n_shards)`` — any worker can
  recompute any other worker's batch, which is what makes the elastic
  runtime's shard reassignment (runtime/elastic.py) correct: after a
  membership change, survivors re-derive the dead worker's stream with no
  data loss or duplication.
* ``Loader`` — a double-buffered background prefetcher.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class TokenDataset:
    def __init__(self, vocab_size: int, *, tokens: np.ndarray | None = None,
                 path: str | None = None, dtype=np.uint16, seed: int = 0):
        self.vocab_size = vocab_size
        self.seed = seed
        if path is not None:
            self.tokens = np.memmap(path, dtype=dtype, mode="r")
        else:
            self.tokens = tokens  # None -> fully synthetic

    def __len__(self) -> int:
        return len(self.tokens) if self.tokens is not None else 1 << 40

    def batch(self, step: int, shard_id: int, n_shards: int,
              batch_per_shard: int, seq_len: int) -> dict[str, np.ndarray]:
        """Next-token-prediction batch for one shard at one step."""
        need = batch_per_shard * (seq_len + 1)
        if self.tokens is None:
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 65_537 + shard_id)
            flat = rng.integers(0, self.vocab_size, size=need, dtype=np.int32)
        else:
            start = ((step * n_shards + shard_id) * need) % max(len(self.tokens) - need, 1)
            flat = np.asarray(self.tokens[start:start + need], dtype=np.int32)
        x = flat.reshape(batch_per_shard, seq_len + 1)
        return {"tokens": x[:, :-1].copy(), "labels": x[:, 1:].copy()}


def synthetic_batch(vocab: int, batch: int, seq: int, step: int = 0) -> dict:
    return TokenDataset(vocab).batch(step, 0, 1, batch, seq)


class Loader:
    """Background prefetcher: overlaps host batch assembly with device steps."""

    def __init__(self, ds: TokenDataset, *, shard_id: int, n_shards: int,
                 batch_per_shard: int, seq_len: int, start_step: int = 0,
                 prefetch: int = 2):
        self.ds, self.shard_id, self.n_shards = ds, shard_id, n_shards
        self.bps, self.seq = batch_per_shard, seq_len
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._fill, daemon=True)
        self._t.start()

    def _fill(self):
        s = self._step
        while not self._stop.is_set():
            b = self.ds.batch(s, self.shard_id, self.n_shards, self.bps, self.seq)
            while not self._stop.is_set():
                try:
                    self._q.put((s, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=2)
