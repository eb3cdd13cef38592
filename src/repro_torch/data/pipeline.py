"""Deterministic, stateless data.  Counterpart of ``repro/data/pipeline.py``
(``_rng``, ``SyntheticSource``, ``MemmapSource``, ``batch_for``,
``poisson_sample_indices``, ``poisson_capacity``, ``poisson_batch_for``,
``augment_expand``), for token streams and the image families' synthetic
images.

Every batch is a pure function of (seed, step, example index) through a
counter-based Philox generator in numpy, so a retried step sees the same
batch and both packages draw the same tokens for the same seed and step.

Two sampling modes, as in the JAX package: ``batch_for`` gives fixed-size
batches of per-step fresh examples; ``poisson_batch_for`` draws each of the
N dataset examples independently with probability q, keyed by (seed,
step), right-pads the draw to a fixed capacity and adds a ``(per,) bool``
``"mask"`` of the real rows.  Example content is keyed by dataset index,
so example i is the same tokens (or image and label) in every step that
samples it.

Augmentation multiplicity (``augment_expand``) expands a sampled batch to
K views of each example after sampling, so the example stays the privacy
unit: view 0 is the image itself, views k >= 1 a horizontal flip and a
pad-4 random crop drawn from their own (seed, step, row)-keyed streams.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import IMAGE_FAMILIES, ArchConfig, ShapeConfig

# stream tag for index-keyed (step-independent) example content
_EXAMPLE_STREAM_STEP = 0x0DA7A5E7
# stream of the Poisson draw
_POISSON_STREAM = 0xB0
# stream-space offset of the augmentation draws (augment_expand): disjoint
# from the per-example data streams and the Poisson draw
_AUG_STREAM_BASE = 0xA6000000


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

    def examples(self, indices: np.ndarray, seq_len: int) -> Dict[str, np.ndarray]:
        """``{"tokens": (len(indices), seq_len + 1) int32}`` by dataset
        index: example i is the same tokens whichever step samples it."""
        out = np.empty((len(indices), seq_len + 1), np.int32)
        for row, idx in enumerate(indices):
            gi = _rng(self.seed, _EXAMPLE_STREAM_STEP, int(idx) + 1)
            out[row] = gi.integers(0, self.vocab, seq_len + 1, np.int64)
        return {"tokens": out}

    # -- images (the image families), keyed as the tokens are --------------
    def _image_example(self, step: int, stream: int, size: int,
                       channels: int, n_classes: int):
        gi = _rng(self.seed, step, stream)
        label = np.int32(gi.integers(0, n_classes))
        img = gi.standard_normal((size, size, channels)).astype(np.float32)
        return img, label

    def image_batch(self, step: int, n: int, size: int, channels: int,
                    n_classes: int, shard: int = 0,
                    n_shards: int = 1) -> Dict[str, np.ndarray]:
        """``{"images": (per, size, size, channels) float32, "labels":
        (per,) int32}``: this shard's slice of the step's global batch."""
        if n % n_shards:
            raise ValueError(f"batch {n} does not split into {n_shards} shards")
        per = n // n_shards
        lo = shard * per
        imgs = np.empty((per, size, size, channels), np.float32)
        labels = np.empty((per,), np.int32)
        for i in range(per):
            imgs[i], labels[i] = self._image_example(step, lo + i + 1, size,
                                                     channels, n_classes)
        return {"images": imgs, "labels": labels}

    def image_examples(self, indices: np.ndarray, size: int, channels: int,
                       n_classes: int) -> Dict[str, np.ndarray]:
        """Images and labels by dataset index (Poisson sampling): example i
        is the same in every step that samples it."""
        imgs = np.empty((len(indices), size, size, channels), np.float32)
        labels = np.empty((len(indices),), np.int32)
        for row, idx in enumerate(indices):
            imgs[row], labels[row] = self._image_example(
                _EXAMPLE_STREAM_STEP, int(idx) + 1, size, channels, n_classes)
        return {"images": imgs, "labels": labels}


@dataclasses.dataclass(frozen=True)
class MemmapSource:
    """File-backed token corpus: a flat int32 memmap; each example is a
    window of it whose start is drawn from the same (seed, step, example)
    keyed streams as the synthetic tokens, so both packages read the same
    windows.  ``dataset_size`` is the token count, as in the JAX package,
    so the accountant prices the same q = B/N."""
    path: str
    vocab: int
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "_data",
                           np.memmap(self.path, dtype=np.int32, mode="r"))

    @property
    def dataset_size(self) -> int:
        return len(self._data)

    def _windows(self, step: int, streams, seq_len: int) -> Dict[str, np.ndarray]:
        hi_start = len(self._data) - (seq_len + 1)
        out = np.empty((len(streams), seq_len + 1), np.int32)
        for row, stream in enumerate(streams):
            s = int(_rng(self.seed, step, stream).integers(0, hi_start))
            out[row] = self._data[s:s + seq_len + 1]
        return {"tokens": np.clip(out, 0, self.vocab - 1)}

    def batch(self, step: int, n: int, seq_len: int, shard: int = 0,
              n_shards: int = 1) -> Dict[str, np.ndarray]:
        """This shard's slice of the step's windows, as ``SyntheticSource``."""
        if n % n_shards:
            raise ValueError(f"batch {n} does not split into {n_shards} shards")
        per = n // n_shards
        lo = shard * per
        return self._windows(step, range(lo + 1, lo + per + 1), seq_len)

    def examples(self, indices: np.ndarray, seq_len: int) -> Dict[str, np.ndarray]:
        """Windows by dataset index: index i is the same window whichever
        step samples it."""
        return self._windows(_EXAMPLE_STREAM_STEP,
                             [int(i) + 1 for i in indices], seq_len)


def make_source(spec: str, vocab: int, seed: int = 0):
    """``"synthetic"`` or ``"memmap:<path>"``."""
    if spec == "synthetic":
        return SyntheticSource(vocab=vocab, seed=seed)
    if spec.startswith("memmap:"):
        return MemmapSource(path=spec.split(":", 1)[1], vocab=vocab, seed=seed)
    raise ValueError(f"unknown data source {spec!r}")


def batch_for(source, arch: ArchConfig, shape: ShapeConfig,
              step: int, shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
    """This shard's slice of the global batch for (arch, shape) at ``step``."""
    if arch.family in IMAGE_FAMILIES:
        size, _, channels = arch.image_shape()
        return _image_source(source, arch).image_batch(
            step, shape.global_batch, size, channels, arch.n_classes, shard,
            n_shards)
    if arch.embed_stub:
        raise NotImplementedError(f"{arch.name}: embedding-input models are "
                                  f"not ported")
    return source.batch(step, shape.global_batch, shape.seq_len, shard, n_shards)


def _image_source(source, arch: ArchConfig):
    if not hasattr(source, "image_batch"):
        raise ValueError(
            f"data source {type(source).__name__} provides tokens only; "
            f"family={arch.family!r} needs an image-capable source "
            f"(data_source='synthetic')")
    return source


# ---------------------------------------------------------------------------
# Poisson subsampling (DPConfig.sampling = "poisson")
# ---------------------------------------------------------------------------

def poisson_sample_indices(seed: int, step: int, dataset_size: int,
                           sample_rate: float) -> np.ndarray:
    """The step's Poisson sample: sorted dataset indices, each of the N
    examples included independently with probability ``sample_rate``.
    Drawn as S ~ Binomial(N, q), then a uniform subset of size S: the same
    distribution as N Bernoulli(q) draws, in O(S)."""
    if not 0.0 <= sample_rate <= 1.0:
        raise ValueError(f"sample_rate {sample_rate} is not in [0, 1]")
    g = _rng(seed, step, _POISSON_STREAM)
    size = int(g.binomial(dataset_size, sample_rate))
    idx = g.choice(dataset_size, size=size, replace=False)
    return np.sort(idx.astype(np.int64))


def poisson_capacity(expected_batch: int, sample_rate: float,
                     multiple: int = 1, z: float = 6.0) -> int:
    """Physical rows of the padded batch: the expected size q·N plus ``z``
    binomial standard deviations (z = 6: overflow about once in 1e9
    steps), rounded up to ``multiple``.  The same for every step."""
    std = float(np.sqrt(expected_batch * max(1.0 - sample_rate, 0.0)))
    cap = int(np.ceil(expected_batch + z * std))
    multiple = max(1, multiple)
    return ((cap + multiple - 1) // multiple) * multiple


def poisson_batch_for(source, arch: ArchConfig,
                      shape: ShapeConfig, step: int,
                      capacity: Optional[int] = None,
                      sample_rate: Optional[float] = None,
                      shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
    """This shard's slice of the step's Poisson-sampled batch.

    The expected size is ``shape.global_batch`` (q = B/N unless
    ``sample_rate`` is given); the physical row count is ``capacity``,
    right-padded with all-zero rows.  Returns ``"tokens"`` and ``"mask"``,
    (per,) bool flags of the real rows.  A draw larger than the capacity
    (z = 6: astronomically rare) is cut to its lowest indices with a
    ``RuntimeWarning``: that step then deviates from the priced mechanism."""
    if arch.embed_stub:
        raise NotImplementedError(f"{arch.name}: embedding-input models are "
                                  f"not ported")
    N = source.dataset_size
    q = sample_rate if sample_rate is not None else shape.global_batch / N
    cap = capacity if capacity is not None else poisson_capacity(
        shape.global_batch, q, multiple=n_shards)
    if cap % n_shards:
        raise ValueError(f"capacity {cap} does not split into {n_shards} shards")
    per = cap // n_shards
    lo = shard * per
    idx = poisson_sample_indices(source.seed, step, N, q)
    if len(idx) > cap:
        warnings.warn(
            f"poisson draw of {len(idx)} examples exceeds capacity {cap} at "
            f"step {step}; truncating (the executed sample deviates from the "
            f"priced Poisson mechanism this step)", RuntimeWarning)
        idx = idx[:cap]
    mine = idx[lo:lo + per]                      # this shard's real rows
    if arch.family in IMAGE_FAMILIES:
        size, _, channels = arch.image_shape()
        ex = _image_source(source, arch).image_examples(mine, size, channels,
                                                        arch.n_classes)
    else:
        ex = source.examples(mine, shape.seq_len)
    out = {}
    for k, v in ex.items():
        padded = np.zeros((per,) + v.shape[1:], v.dtype)
        padded[:len(mine)] = v
        out[k] = padded
    mask = np.zeros((per,), np.bool_)
    mask[:len(mine)] = True
    out["mask"] = mask
    return out


# ---------------------------------------------------------------------------
# Augmentation multiplicity (DPConfig.augmult = K)
# ---------------------------------------------------------------------------

def augment_expand(batch: Dict[str, np.ndarray], k: int, seed: int,
                   step: int, pad: int = 4) -> Dict[str, np.ndarray]:
    """A (B, ...)-leaved batch as K views of each example, (B·K, ...)
    b-major / k-minor (view k of example b at row b·K + k), the layout the
    algorithms and site rules reduce over.  View 0 of an ``"images"`` leaf
    is the image; views k >= 1 a pad-``pad`` random crop and a random
    horizontal flip from the (seed, step, b·K + k)-keyed stream.  Every
    other leaf (labels, the Poisson ``"mask"``) is repeated over K.  An
    all-zero padded image stays all zero in every view.  ``k <= 1`` returns
    ``batch`` itself."""
    if k <= 1:
        return batch
    return {name: (_augment_images(v, k, seed, step, pad) if name == "images"
                   else np.repeat(v, k, axis=0))
            for name, v in batch.items()}


def _augment_images(imgs: np.ndarray, k: int, seed: int, step: int,
                    pad: int) -> np.ndarray:
    B, H, W, C = imgs.shape
    out = np.empty((B * k, H, W, C), imgs.dtype)
    padded = np.pad(imgs, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    for b in range(B):
        out[b * k] = imgs[b]                     # view 0: the image itself
        for kk in range(1, k):
            g = _rng(seed, step, _AUG_STREAM_BASE + b * k + kk)
            dy, dx = (int(x) for x in g.integers(0, 2 * pad + 1, 2))
            view = padded[b, dy:dy + H, dx:dx + W]
            if g.integers(0, 2):
                view = view[:, ::-1]
            out[b * k + kk] = view
    return out
