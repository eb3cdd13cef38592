"""Clip-scale and batch reduce: the CUDA kernel ``csrc/clip_reduce.cu`` and
its wrapper.  Counterpart of ``repro/kernels/clip_reduce.py``
``clip_reduce`` (the Pallas TPU kernel): vanilla DP-SGD's clipped sum of
per-example gradients.

A CPU tensor takes the plain version (``ref.clip_reduce_ref``); a CUDA
tensor launches the kernel or raises.  ``LAUNCHES`` counts wrapper calls
that launched the kernel (and nothing else).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    fn = build.load("clip_reduce").repro_clip_reduce
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int                 # cudaError_t
    return fn


def _check(g, c):
    if g.dim() != 2 or c.dim() != 1 or c.shape[0] != g.shape[0] \
            or min(g.shape) < 1:
        raise ValueError(f"clip_reduce: want g (B,N), c (B,); got "
                         f"{tuple(g.shape)}, {tuple(c.shape)}")
    if not (g.is_floating_point() and c.is_floating_point()):
        raise TypeError(f"clip_reduce: floating inputs only, got {g.dtype}, "
                        f"{c.dtype}")
    if g.device != c.device:
        raise ValueError("clip_reduce: g, c on different devices")


def clip_reduce(g: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """g: (B, N) per-example gradients, c: (B,) clip factors -> (N,) float32
    ``Σ_b c_b·g_b``, summed over b in order; rows with ``c_b = 0`` add
    exactly nothing."""
    global LAUNCHES
    _check(g, c)
    if g.device.type == "cpu":
        return ref.clip_reduce_ref(g, c)
    if g.device.type != "cuda":
        raise ValueError(f"clip_reduce: unsupported device {g.device}")
    if g.dtype not in _DTYPES or c.dtype != torch.float32:
        raise TypeError(f"clip_reduce: kernel takes g float32 or bfloat16 and "
                        f"c float32, got {g.dtype}, {c.dtype}")
    if not (g.is_contiguous() and c.is_contiguous()):
        raise ValueError("clip_reduce: g, c must be contiguous")
    B, N = g.shape
    if B > 2 ** 31 - 1:
        raise ValueError(f"clip_reduce: {B} rows do not fit an int")
    kernel = _kernel()
    with torch.cuda.device(g.device):
        out = torch.empty((N,), dtype=torch.float32, device=g.device)
        err = kernel(g.data_ptr(), c.data_ptr(), out.data_ptr(), B, N,
                     _DTYPES[g.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"clip_reduce: CUDA launch failed with cudaError_t "
                           f"{err}")
    LAUNCHES += 1
    return out
