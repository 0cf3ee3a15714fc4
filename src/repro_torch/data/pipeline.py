"""Deterministic synthetic LM data pipeline.

Production shape without production data: a seeded, host-sharded, prefetching
token pipeline.  Sequences are synthesised from a mixture of Zipf unigrams
and deterministic n-gram structure (so models can actually *learn* — the
quickstart example drives the loss down on it), packed to fixed length, and
served as {tokens, labels} with next-token labels.

Determinism contract: batch ``i`` of a given (seed, config) is identical
regardless of host count — each host slices its own rows of the global batch
— which is what makes checkpoint-restart and elastic rescaling exact.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 32_000
    seq_len: int = 512
    global_batch: int = 8
    seed: int = 0
    zipf_alpha: float = 1.1
    structure: int = 3        # n-gram order of the synthetic structure
    pad_frac: float = 0.0     # fraction of trailing pad (-1 labels)


class SyntheticLM:
    """Seeded synthetic token stream with learnable n-gram structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed random n-gram successor table: token t deterministically
        # prefers successor (a·t + b) mod v with some noise
        self._a = int(root.integers(3, 997)) | 1
        self._b = int(root.integers(1, v))
        ranks = np.arange(1, v + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_alpha)
        self._probs = w / w.sum()

    def batch(self, index: int) -> dict[str, np.ndarray]:
        """The ``index``-th global batch — pure function of (seed, index)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, index))
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = rng.choice(v, size=b, p=self._probs)
        noise = rng.random((b, s))
        fresh = rng.choice(v, size=(b, s), p=self._probs)
        for t in range(s):
            nxt = (self._a * toks[:, t] + self._b) % v
            toks[:, t + 1] = np.where(noise[:, t] < 0.75, nxt, fresh[:, t])
        tokens, labels = toks[:, :-1], toks[:, 1:].copy()
        if cfg.pad_frac > 0:
            n_pad = int(s * cfg.pad_frac)
            if n_pad:
                labels[:, -n_pad:] = -1
        return {"tokens": tokens, "labels": labels}

    def host_batch(self, index: int, host_id: int, n_hosts: int) -> dict:
        """This host's rows of global batch ``index``."""
        g = self.batch(index)
        rows = self.cfg.global_batch // n_hosts
        sl = slice(host_id * rows, (host_id + 1) * rows)
        return {k: val[sl] for k, val in g.items()}


class PrefetchingLoader:
    """Background-thread prefetch over :class:`SyntheticLM` batches."""

    def __init__(self, source: SyntheticLM, start: int = 0, depth: int = 2,
                 host_id: int = 0, n_hosts: int = 1):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._idx = start
        self._host = (host_id, n_hosts)

        def worker():
            i = start
            while not self._stop.is_set():
                if self._host[1] > 1:
                    item = source.host_batch(i, *self._host)
                else:
                    item = source.batch(i)
                try:
                    self._q.put((i, item), timeout=0.5)
                    i += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __next__(self):
        idx, item = self._q.get()
        return idx, item

    def close(self):
        self._stop.set()
