"""Ghost-norm (Gram) reduction: the CUDA kernel ``csrc/gram_norm.cu`` and its
wrapper.  Counterpart of ``repro/kernels/gram_norm.py`` ``gram_norm`` (the
Pallas TPU kernel).

A CPU tensor takes the plain version (``ref.gram_norm_ref``); a CUDA tensor
launches the kernel or raises (a fake one, ``launch/memory.py``'s trace,
makes the launch's allocations only); under a cost trace
(``launch/costs.py``) a call records the work of its plain version,
whichever branch runs (``build.counted``).  ``LAUNCHES`` counts wrapper calls that
launched the kernel (and nothing else); ``gram_path`` says which of the
kernel's paths CUDA operands take.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0
TILE = 64             # the kernel's (t, s) Gram tile
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    fn = build.load("gram_norm").repro_gram_norm
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])       # x gy ids part, ints, stream
    fn.restype = ctypes.c_int                 # cudaError_t
    return fn


def _path_fn():
    fn = build.load("gram_norm").repro_gram_norm_path
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4   # x gy, di do square dtype
    fn.restype = ctypes.c_int                 # PATHS index, -1 unknown dtype
    return fn


# the kernel's paths (csrc/gram_norm.cu): CUDA cores for float32; in bf16
# the tensor cores, fed by 16-byte cp.async or, where a row of gy (or of x,
# when square) is not a multiple of 8 elements or a base is not 16-byte
# aligned, by element loads
PATHS = ("cuda-cores", "mma+cp.async", "mma+loads")


def gram_path(x: torch.Tensor, gy: torch.Tensor, square: bool = True) -> str:
    """The path ``gram_norm`` takes for these CUDA operands (one of
    ``PATHS``).  Launches nothing."""
    if gy.device.type != "cuda" or gy.dtype not in _DTYPES:
        raise ValueError(f"gram_path: want a float32 or bf16 CUDA tensor, got "
                         f"{gy.dtype} on {gy.device}")
    return PATHS[_path_fn()(x.data_ptr(), gy.data_ptr(), x.shape[-1],
                            gy.shape[-1], int(square), _DTYPES[gy.dtype])]


def _check(x, gy, mask_ids):
    if x.dim() != 3 or gy.dim() != 3 or x.shape[:2] != gy.shape[:2] \
            or min(x.shape) < 1 or gy.shape[2] < 1:
        raise ValueError(f"gram_norm: want x (BG,T,di), gy (BG,T,do); got "
                         f"{tuple(x.shape)}, {tuple(gy.shape)}")
    if x.dtype != gy.dtype:
        raise TypeError(f"gram_norm: mixed dtypes {x.dtype}, {gy.dtype}")
    if x.device != gy.device:
        raise ValueError("gram_norm: x, gy on different devices")
    if mask_ids is not None:
        if mask_ids.shape != x.shape[:2]:
            raise ValueError(f"gram_norm: ids {tuple(mask_ids.shape)} do not "
                             f"match rows {tuple(x.shape[:2])}")
        if mask_ids.device != x.device or mask_ids.is_floating_point():
            raise ValueError("gram_norm: ids must be integers on x's device")


@build.counted(ref.gram_norm_ref)
def gram_norm(x: torch.Tensor, gy: torch.Tensor,
              mask_ids: torch.Tensor | None = None,
              square: bool = True) -> torch.Tensor:
    """x: (BG, T, di), gy: (BG, T, do) -> (BG,) float32
    ``Σ_{t,s} (x_t·x_s)(gy_t·gy_s)``; ``square=False`` drops the x Gram
    (``Σ gy_t·gy_s``, the embedding rule; x is then not read); with
    ``mask_ids`` (BG, T) only pairs with equal ids contribute."""
    global LAUNCHES
    _check(x, gy, mask_ids)
    if x.device.type == "cpu":
        return ref.gram_norm_ref(x, gy, mask_ids, square)
    if x.device.type != "cuda":
        raise ValueError(f"gram_norm: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"gram_norm: kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not (x.is_contiguous() and gy.is_contiguous()):
        raise ValueError("gram_norm: x, gy must be contiguous")
    BG, T, di = x.shape
    if BG > 65535:
        raise ValueError(f"gram_norm: {BG} rows > 65535 (grid y)")
    ids = None if mask_ids is None else mask_ids.to(torch.int32).contiguous()
    n_t = -(-T // TILE)
    with build.on_device(x):
        part = torch.empty((BG, n_t * (n_t + 1) // 2), dtype=torch.float32,
                           device=x.device)
        if build.is_fake(x):        # a memory trace: the allocation only
            return part.sum(dim=1)
        err = _kernel()(x.data_ptr(), gy.data_ptr(),
                     None if ids is None else ids.data_ptr(), part.data_ptr(),
                     BG, T, di, gy.shape[2], int(ids is not None), int(square),
                     _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gram_norm: CUDA launch failed with cudaError_t {err}")
    LAUNCHES += 1
    # partials of a row summed in a fixed order (no atomics): deterministic
    return part.sum(dim=1)
