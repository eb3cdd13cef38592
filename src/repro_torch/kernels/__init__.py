"""Hand-written CUDA kernels of the port (``csrc/``), their wrappers and
their plain PyTorch versions (``ref.py``).  Nothing builds at import: a
kernel compiles at its first launch (``build.py``)."""


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel: (module, attribute),
    one added where the wrapper launches its kernel."""
    from repro_torch.kernels import (clip_reduce, flash_attn, fused_bwd,
                                     gram_norm, pegrad_norm)
    return {"flash_attn_fwd": (flash_attn, "LAUNCHES"),
            "flash_attn_bwd": (flash_attn, "BWD_LAUNCHES"),
            "dense_bwd_norm": (fused_bwd, "LAUNCHES"),
            "gram_norm": (gram_norm, "LAUNCHES"),
            "pegrad_norm": (pegrad_norm, "LAUNCHES"),
            "dense_dgrad": (fused_bwd, "DGRAD_LAUNCHES"),
            "clip_reduce": (clip_reduce, "LAUNCHES")}


def launch_counts() -> dict:
    """Every kernel wrapper's launches so far in this process, by kernel."""
    return {k: getattr(m, a) for k, (m, a) in launch_counters().items()}


def reset_launch_counts() -> None:
    """Every kernel wrapper's launch count set to 0."""
    for m, a in launch_counters().values():
        setattr(m, a, 0)
