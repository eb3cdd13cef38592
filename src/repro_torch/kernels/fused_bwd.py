"""Fused dense backward: the CUDA kernel ``csrc/dense_bwd_norm.cu`` and its
wrapper, and its dgrad half alone, ``csrc/dense_dgrad.cu``.  Counterparts
of ``repro/kernels/fused_bwd.py`` ``dense_bwd_norm`` and ``dense_dgrad``
(the Pallas TPU kernels).

A CPU tensor takes the plain version (``ref.dense_bwd_norm_ref``,
``ref.dense_dgrad_ref``); a CUDA tensor launches the kernel or raises; a
fake one (``launch/memory.py``'s trace) makes the launch's allocations and
launches nothing;
under a cost trace (``launch/costs.py``) a call records the work of its
plain version, whichever branch runs (``build.counted``).
``LAUNCHES`` and ``DGRAD_LAUNCHES`` count wrapper calls that launched
``dense_bwd_norm`` and ``dense_dgrad`` (and nothing else).  ``dgrad_path``
says which of the gx launch's paths a CUDA operand pair takes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0
DGRAD_LAUNCHES = 0
TILE = 128            # the kernel's (i, j) tile of the per-example wgrad
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    fn = build.load("dense_bwd_norm").repro_dense_bwd_norm
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])       # x gy w gx part, ints, stream
    fn.restype = ctypes.c_int                 # cudaError_t
    return fn


def _dgrad_kernel():
    fn = build.load("dense_dgrad").repro_dense_dgrad
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])       # gy w gx, ints, stream
    fn.restype = ctypes.c_int                 # cudaError_t
    return fn


def _dgrad_path_fn():
    fn = build.load("dense_dgrad").repro_dense_dgrad_path
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2   # gy w, do dtype
    fn.restype = ctypes.c_int                 # PATHS index, -1 unknown dtype
    return fn


# the gx launch's paths (csrc/dense_tiles.cuh): CUDA cores for float32;
# in bf16 the tensor cores, fed by TMA or, where do % 8 != 0 or a base is not
# 16-byte aligned, by element loads
PATHS = ("cuda-cores", "wgmma+tma", "wgmma+loads")


def dgrad_path(gy: torch.Tensor, w: torch.Tensor) -> str:
    """The path ``dense_dgrad`` and ``dense_bwd_norm``'s gx launch take for
    these CUDA operands (one of ``PATHS``).  Launches nothing."""
    if gy.device.type != "cuda" or gy.dtype not in _DTYPES:
        raise ValueError(f"dgrad_path: want a float32 or bf16 CUDA tensor, got "
                         f"{gy.dtype} on {gy.device}")
    return PATHS[_dgrad_path_fn()(gy.data_ptr(), w.data_ptr(), gy.shape[-1],
                                  _DTYPES[gy.dtype])]


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


@build.counted(ref.dense_bwd_norm_ref)
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
    n_tiles = -(-di // TILE) * -(-do // TILE)
    with build.on_device(x):
        gx = torch.empty_like(x)
        part = torch.empty((BG, n_tiles), dtype=torch.float32, device=x.device)
        if build.is_fake(x):        # a memory trace: the allocations only
            return gx, part.sum(dim=1)
        err = _kernel()(x.data_ptr(), gy.data_ptr(), w.data_ptr(), gx.data_ptr(),
                     part.data_ptr(), BG, T, di, do, w.shape[0], _DTYPES[x.dtype],
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_bwd_norm: CUDA launch failed with "
                           f"cudaError_t {err}")
    LAUNCHES += 1
    # partials of a row summed in a fixed order (no atomics): deterministic
    return gx, part.sum(dim=1)


@build.counted(ref.dense_dgrad_ref)
def dense_dgrad(gy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """gy: (BG, T, do), w: (E, di, do), row b using group ``b % E`` ->
    gx (BG, T, di) = ``gy_b @ w[b % E]ᵀ`` in gy's dtype: ``dense_bwd_norm``'s
    gx alone, bit for bit."""
    global DGRAD_LAUNCHES
    if gy.dim() != 3 or w.dim() != 3 or w.shape[2] != gy.shape[2] \
            or min(*gy.shape, *w.shape) < 1:
        raise ValueError(f"dense_dgrad: want gy (BG,T,do), w (E,di,do); got "
                         f"{tuple(gy.shape)}, {tuple(w.shape)}")
    if gy.dtype != w.dtype:
        raise TypeError(f"dense_dgrad: mixed dtypes {gy.dtype}, {w.dtype}")
    if gy.device != w.device:
        raise ValueError("dense_dgrad: gy, w on different devices")
    if gy.device.type == "cpu":
        return ref.dense_dgrad_ref(gy, w)
    if gy.device.type != "cuda":
        raise ValueError(f"dense_dgrad: unsupported device {gy.device}")
    if gy.dtype not in _DTYPES:
        raise TypeError(f"dense_dgrad: kernel takes float32 or bfloat16, got "
                        f"{gy.dtype}")
    if not (gy.is_contiguous() and w.is_contiguous()):
        raise ValueError("dense_dgrad: gy, w must be contiguous")
    BG, T, do = gy.shape
    E, di = w.shape[:2]
    if BG > 65535:
        raise ValueError(f"dense_dgrad: {BG} rows > 65535 (grid y)")
    with build.on_device(gy):
        gx = torch.empty((BG, T, di), dtype=gy.dtype, device=gy.device)
        if build.is_fake(gy):       # a memory trace: the allocation only
            return gx
        err = _dgrad_kernel()(gy.data_ptr(), w.data_ptr(), gx.data_ptr(), BG, T, di, do,
                     E, _DTYPES[gy.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_dgrad: CUDA launch failed with cudaError_t "
                           f"{err}")
    DGRAD_LAUNCHES += 1
    return gx
