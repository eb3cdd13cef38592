"""Fused dense backward: the CUDA kernel ``csrc/dense_bwd_norm.cu`` and its
wrapper.  Counterpart of ``repro/kernels/fused_bwd.py`` ``dense_bwd_norm``
(the Pallas TPU kernel).

A CPU tensor takes the plain version (``ref.dense_bwd_norm_ref``); a CUDA
tensor launches the kernel or raises.  ``LAUNCHES`` counts wrapper calls that
launched the kernel (and nothing else).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0
TILE = 128            # the kernel's (i, j) tile of the per-example wgrad
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    fn = build.load("dense_bwd_norm").repro_dense_bwd_norm
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])       # x gy w gx part, ints, stream
    fn.restype = ctypes.c_int                 # cudaError_t
    return fn


def _check(x, gy, w):
    if x.dim() != 3 or gy.dim() != 3 or w.dim() != 3:
        raise ValueError(f"dense_bwd_norm: want x (BG,T,di), gy (BG,T,do), "
                         f"w (E,di,do); got {tuple(x.shape)}, {tuple(gy.shape)}, "
                         f"{tuple(w.shape)}")
    BG, T, di = x.shape
    if gy.shape[:2] != (BG, T) or w.shape[1:] != (di, gy.shape[2]) \
            or min(BG, T, di, gy.shape[2], w.shape[0]) < 1:
        raise ValueError(f"dense_bwd_norm: shapes x {tuple(x.shape)}, gy "
                         f"{tuple(gy.shape)}, w {tuple(w.shape)} do not fit")
    if not (x.dtype == gy.dtype == w.dtype):
        raise TypeError(f"dense_bwd_norm: mixed dtypes {x.dtype}, {gy.dtype}, "
                        f"{w.dtype}")
    if not (x.device == gy.device == w.device):
        raise ValueError("dense_bwd_norm: x, gy, w on different devices")


def dense_bwd_norm(x: torch.Tensor, gy: torch.Tensor, w: torch.Tensor):
    """x: (BG, T, di), gy: (BG, T, do), w: (E, di, do), row b using group
    ``b % E``.  Returns (gx (BG, T, di) in x's dtype, nsq (BG,) float32):
    ``gx_b = gy_b @ w[b % E]ᵀ`` and ``nsq_b = ‖x_bᵀ gy_b‖²_F``."""
    global LAUNCHES
    _check(x, gy, w)
    if x.device.type == "cpu":
        return ref.dense_bwd_norm_ref(x, gy, w)
    if x.device.type != "cuda":
        raise ValueError(f"dense_bwd_norm: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dense_bwd_norm: kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if not (x.is_contiguous() and gy.is_contiguous() and w.is_contiguous()):
        raise ValueError("dense_bwd_norm: x, gy, w must be contiguous")
    BG, T, di = x.shape
    do = gy.shape[2]
    if BG > 65535:
        raise ValueError(f"dense_bwd_norm: {BG} rows > 65535 (grid y)")
    kernel = _kernel()
    n_tiles = -(-di // TILE) * -(-do // TILE)
    with torch.cuda.device(x.device):
        gx = torch.empty_like(x)
        part = torch.empty((BG, n_tiles), dtype=torch.float32, device=x.device)
        err = kernel(x.data_ptr(), gy.data_ptr(), w.data_ptr(), gx.data_ptr(),
                     part.data_ptr(), BG, T, di, do, w.shape[0], _DTYPES[x.dtype],
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_bwd_norm: CUDA launch failed with "
                           f"cudaError_t {err}")
    LAUNCHES += 1
    # partials of a row summed in a fixed order (no atomics): deterministic
    return gx, part.sum(dim=1)
