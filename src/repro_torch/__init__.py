"""PyTorch/CUDA port of ``repro``'s serving path for NVIDIA Hopper.

The package mirrors the JAX package's module names and parameter layouts
(dense ``w`` is ``(d_in, d_out)``, scanned blocks carry a leading
``(reps, ...)`` axis, KV caches are ``{"prelude": [...], "blocks": ...}``)
so every ported module has one named counterpart under ``repro``.  It
imports neither ``jax`` nor anything of ``repro``: what it needs from there
it keeps as its own copy.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
on the CPU every kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for (explicitly
    or by default) and no CUDA device is present: the port never falls
    back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: no CUDA device available; pass "
                           "device='cpu' to run the plain PyTorch path")
    return dev
