"""Roofline terms of a traced step.  Counterpart of ``repro/launch/roofline.py``.

Three terms a step, each the least time its resource allows:

    compute    = FLOPs / (devices x peak FLOP/s)
    memory     = bytes / (devices x HBM bytes/s)
    collective = wire bytes / (devices x link bytes/s)

The JAX package reads FLOPs and bytes from XLA's cost analysis and the
collectives from the optimized HLO, with a TPU's constants.  The port has
no HLO: its FLOPs and bytes come from ``launch/costs.py``'s fake-tensor
trace of the step, and its collectives from the records that
``dist/runtime.py``'s ``all_reduce_`` and ``all_gather`` append during a
trace, turned into wire bytes with the same ring factors (all-reduce
2(n-1)/n, gather and scatter (n-1)/n, permute 1).  The constants are the
H100's; the JAX package's own can be passed in by keyword.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

# NVIDIA H100 SXM data sheet (dense): bf16 tensor-core peak, float32 peak
# outside the tensor cores, HBM3 bandwidth, and NVLink 4 (900 GB/s a card
# in both directions together: 450 GB/s each way)
PEAK_FLOPS = 989e12           # bf16 FLOP/s per card
PEAK_FLOPS_F32 = 67e12        # float32 FLOP/s per card
HBM_BW = 3.35e12              # bytes/s per card
LINK_BW = 450e9               # bytes/s per card, each way

# the ring's wire bytes per byte of each collective kind's result
RING_FACTORS = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "all-gather": lambda n: (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}


def collective_bytes(records: Iterable[dict], n_devices: int) -> Dict[str, float]:
    """Per-device wire bytes by collective kind (one step) from a traced
    step's collective records (``{"kind", "bytes", "group"}``, ``bytes``
    the size of the collective's result on one device, ``group`` its group
    size, ``n_devices`` when a record has none)."""
    out: Dict[str, float] = {}
    for r in records:
        kind = r["kind"]
        n = max(int(r.get("group") or n_devices), 1)
        out[kind] = out.get(kind, 0.0) + r["bytes"] * RING_FACTORS[kind](n)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def roofline_terms(flops: Optional[float], bytes_accessed: Optional[float],
                   coll_bytes: float, n_devices: int, *,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> Dict[str, float]:
    """The three terms (seconds) and the largest one's name, with the H100's
    constants unless others are given."""
    terms = {}
    terms["compute_s"] = (flops or 0.0) / (n_devices * peak_flops)
    terms["memory_s"] = (bytes_accessed or 0.0) / (n_devices * hbm_bw)
    terms["collective_s"] = coll_bytes / (n_devices * link_bw)
    dom = max(terms, key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    return terms


def model_flops(arch, shape, active_params: int) -> float:
    """6·N·D for training (forward and backward); 2·N·D for inference
    passes.  CNNs (weight sharing: FLOPs are not params x positions) are
    summed over their conv sites instead: train = 3 x forward (forward,
    dgrad, wgrad)."""
    if arch.family == "cnn":
        per_ex = _cnn_fwd_flops_per_example(arch)
        mult = 3.0 if shape.kind == "train" else 1.0
        return mult * per_ex * shape.global_batch
    if arch.family == "vit":
        # dense 6·N·D over patch tokens; the patch embedding is dense per
        # patch (kernel = stride = patch), so its FLOPs are params x patches
        tokens = shape.global_batch * arch.vit.n_patches
        return 6.0 * active_params * tokens
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active_params * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active_params * tokens
    tokens = shape.global_batch          # one new token per example
    return 2.0 * active_params * tokens


def _cnn_fwd_flops_per_example(arch) -> float:
    """2·P·k²·cin·cout summed over every conv2d site, walked by the
    model's own ``iter_conv_sites``, plus the head."""
    from repro_torch.models.cnn import iter_conv_sites
    total = 0.0
    for _, op_shapes, gy_shape in iter_conv_sites(arch, batch=1):
        w = op_shapes[1]
        p = gy_shape[1] * gy_shape[2]
        total += 2.0 * p * w[0] * w[1] * w[2] * w[3]
    total += 2.0 * arch.cnn.stage_channels[-1] * arch.vocab      # head
    return total
