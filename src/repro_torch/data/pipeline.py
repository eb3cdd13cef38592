"""Deterministic, stateless synthetic data.  Counterpart of
``repro/data/pipeline.py`` (``_rng``, ``SyntheticSource``, ``batch_for``),
for token streams and fixed-size batches.

Every batch is a pure function of (seed, step, example index) through a
counter-based Philox generator in numpy, so a retried step sees the same
batch and both packages draw the same tokens for the same seed and step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig


def _rng(seed: int, step: int, stream: int) -> np.random.Generator:
    k0 = (seed * 0x9E3779B97F4A7C15 + step) & 0xFFFFFFFFFFFFFFFF
    # an explicit uint64 key: a Python list with k0 >= 2^63 would coerce to
    # float64 and collapse neighbouring steps onto one key
    key = np.array([k0, stream & 0xFFFFFFFFFFFFFFFF], dtype=np.uint64)
    return np.random.Generator(np.random.Philox(key=key))


@dataclasses.dataclass(frozen=True)
class SyntheticSource:
    """Deterministic synthetic token stream."""
    vocab: int
    seed: int = 0
    dataset_size: int = 1_000_000   # nominal N for the privacy accountant

    def batch(self, step: int, n: int, seq_len: int, shard: int = 0,
              n_shards: int = 1) -> Dict[str, np.ndarray]:
        """``{"tokens": (n // n_shards, seq_len + 1) int32}``: this shard's
        slice of the step's global batch, one Philox stream per example."""
        if n % n_shards:
            raise ValueError(f"batch {n} does not split into {n_shards} shards")
        per = n // n_shards
        lo = shard * per
        out = np.empty((per, seq_len + 1), np.int32)
        for i in range(per):
            gi = _rng(self.seed, step, lo + i + 1)
            out[i] = gi.integers(0, self.vocab, seq_len + 1, np.int64)
        return {"tokens": out}


def make_source(spec: str, vocab: int, seed: int = 0) -> SyntheticSource:
    if spec == "synthetic":
        return SyntheticSource(vocab=vocab, seed=seed)
    raise NotImplementedError(f"data source {spec!r} is not ported yet "
                              f"(the port reads synthetic data only)")


def batch_for(source: SyntheticSource, arch: ArchConfig, shape: ShapeConfig,
              step: int, shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
    """This shard's slice of the global batch for (arch, shape) at ``step``."""
    if arch.embed_stub:
        raise NotImplementedError(f"{arch.name}: embedding-input models are "
                                  f"not ported")
    return source.batch(step, shape.global_batch, shape.seq_len, shard, n_shards)
