"""Per-example weight-gradient norm: the CUDA kernel ``csrc/pegrad_norm.cu``
and its wrapper.  Counterpart of ``repro/kernels/pegrad_norm.py``
``pegrad_norm`` (the Pallas TPU kernel); the ``materialize`` norm rule of
the dense sites with ``use_kernels``.

A CPU tensor takes the plain version (``ref.pegrad_norm_ref``); a CUDA
tensor launches the kernel or raises (a fake one, ``launch/memory.py``'s
trace, makes the launch's allocations only); under a cost trace
(``launch/costs.py``) a call records the work of its plain version,
whichever branch runs (``build.counted``).  ``LAUNCHES`` counts wrapper calls
that launched the kernel (and nothing else).  ``norm_path`` says which of
the norm launch's paths a CUDA operand pair takes (``dense_bwd_norm``'s
norm launch is the same kernel and takes the same path).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fused_bwd import PATHS   # the same tc::Path enum

LAUNCHES = 0
TILE = 128            # the kernel's (i, j) tile of x_bᵀ gy_b
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    fn = build.load("pegrad_norm").repro_pegrad_norm
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])       # x gy part, ints, stream
    fn.restype = ctypes.c_int                 # cudaError_t
    return fn


def _path_fn():
    fn = build.load("pegrad_norm").repro_pegrad_norm_path
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3   # x gy, di do dtype
    fn.restype = ctypes.c_int                 # PATHS index, -1 unknown dtype
    return fn


def norm_path(x: torch.Tensor, gy: torch.Tensor) -> str:
    """The path ``pegrad_norm`` and ``dense_bwd_norm``'s norm launch take
    for these CUDA operands (one of ``PATHS``, the gx launch's: in bf16,
    element loads where di or do % 8 != 0 or a base is not 16-byte
    aligned).  Launches nothing."""
    if gy.device.type != "cuda" or gy.dtype not in _DTYPES:
        raise ValueError(f"norm_path: want a float32 or bf16 CUDA tensor, got "
                         f"{gy.dtype} on {gy.device}")
    return PATHS[_path_fn()(x.data_ptr(), gy.data_ptr(), x.shape[-1],
                            gy.shape[-1], _DTYPES[gy.dtype])]


def _check(x, gy):
    if x.dim() != 3 or gy.dim() != 3 or x.shape[:2] != gy.shape[:2] \
            or min(x.shape) < 1 or gy.shape[2] < 1:
        raise ValueError(f"pegrad_norm: want x (BG,T,di), gy (BG,T,do); got "
                         f"{tuple(x.shape)}, {tuple(gy.shape)}")
    if x.dtype != gy.dtype:
        raise TypeError(f"pegrad_norm: mixed dtypes {x.dtype}, {gy.dtype}")
    if x.device != gy.device:
        raise ValueError("pegrad_norm: x, gy on different devices")


@build.counted(ref.pegrad_norm_ref)
def pegrad_norm(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """x: (BG, T, di), gy: (BG, T, do) -> (BG,) float32
    ``‖x_bᵀ gy_b‖²_F``, without forming x_bᵀ gy_b in device memory."""
    global LAUNCHES
    _check(x, gy)
    if x.device.type == "cpu":
        return ref.pegrad_norm_ref(x, gy)
    if x.device.type != "cuda":
        raise ValueError(f"pegrad_norm: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"pegrad_norm: kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not (x.is_contiguous() and gy.is_contiguous()):
        raise ValueError("pegrad_norm: x, gy must be contiguous")
    BG, T, di = x.shape
    do = gy.shape[2]
    if BG > 65535:
        raise ValueError(f"pegrad_norm: {BG} rows > 65535 (grid y)")
    n_tiles = -(-di // TILE) * -(-do // TILE)
    with build.on_device(x):
        part = torch.empty((BG, n_tiles), dtype=torch.float32, device=x.device)
        if build.is_fake(x):        # a memory trace: the allocation only
            return part.sum(dim=1)
        err = _kernel()(x.data_ptr(), gy.data_ptr(), part.data_ptr(), BG, T, di,
                     do, _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pegrad_norm: CUDA launch failed with cudaError_t "
                           f"{err}")
    LAUNCHES += 1
    # partials of a row summed in a fixed order (no atomics): deterministic,
    # and the same sum as dense_bwd_norm's over the same partials
    return part.sum(dim=1)
