"""Deterministic synthetic token pipeline with sequence packing (the port's
copy of ``repro.data.pipeline``: pure numpy, so both frameworks draw
bit-identical batches from one seed).

Real enough to train against: documents with Zipf-distributed token ids and
lognormal lengths are packed into fixed-length rows (greedy bin fill with
separator tokens), and every (host_shard, step) batch is a pure function of
the seed — so restarts resume bit-identically mid-epoch (checkpoint stores
only ``step``), and each data-parallel host generates exactly its shard.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    doc_len_median: float = 350.0
    doc_len_sigma: float = 1.0
    bos: int = 1
    shards: int = 1                 # data-parallel host count
    shard_id: int = 0


class TokenPipeline:
    """Stateless batch source: ``batch(step)`` is deterministic."""

    def __init__(self, cfg: DataConfig) -> None:
        assert cfg.global_batch % cfg.shards == 0
        self.cfg = cfg
        self.per_shard = cfg.global_batch // cfg.shards

    def _rng(self, step: int, row: int) -> np.random.Generator:
        c = self.cfg
        return np.random.default_rng(
            (c.seed * 1_000_003 + step) * 65_537 + c.shard_id * 131 + row)

    def _pack_row(self, rng: np.random.Generator) -> np.ndarray:
        c = self.cfg
        row = np.empty(c.seq_len + 1, np.int32)
        fill = 0
        while fill < c.seq_len + 1:
            n = int(rng.lognormal(np.log(c.doc_len_median), c.doc_len_sigma))
            n = max(8, min(n, c.seq_len))
            doc = rng.zipf(c.zipf_a, size=n).astype(np.int64)
            doc = (doc % (c.vocab - 2)) + 2          # reserve 0=pad, 1=bos
            take = min(n + 1, c.seq_len + 1 - fill)
            row[fill] = c.bos
            row[fill + 1: fill + take] = doc[: take - 1]
            fill += take
        return row

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rows = np.stack([self._pack_row(self._rng(step, r))
                         for r in range(self.per_shard)])
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def synthetic_extras(family: str, batch: int, cfg,
                     rng: Optional[np.random.Generator] = None
                     ) -> Dict[str, np.ndarray]:
    """Stub-frontend inputs (vlm patches / audio frames) for smoke runs."""
    rng = rng or np.random.default_rng(0)
    if family == "vlm":
        v = cfg.vision
        return {"patches": rng.normal(
            0, 1, (batch, v.n_patches, v.patch_dim)).astype(np.float32)}
    if family == "audio":
        e = cfg.encdec
        return {"frames": rng.normal(
            0, 0.1, (batch, e.n_frames, cfg.d_model)).astype(np.float32)}
    return {}
