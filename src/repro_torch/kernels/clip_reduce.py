"""Clip-scale and batch reduce: the CUDA kernel ``csrc/clip_reduce.cu`` and
its wrapper.  Counterpart of ``repro/kernels/clip_reduce.py``
``clip_reduce`` (the Pallas TPU kernel): vanilla DP-SGD's clipped sum of
per-example gradients.

A CPU tensor takes the plain version (``ref.clip_reduce_ref``); a CUDA
tensor launches the kernel or raises; a fake one (``launch/memory.py``'s
trace) makes the launch's allocations and launches nothing; under a cost
trace (``launch/costs.py``) a call records the work of its plain version,
whichever branch runs (``build.counted``).  ``LAUNCHES``
counts wrapper calls that launched the kernel (and nothing else).  ``out=`` adds the sum into a
running float32 sum in place (vanilla DP-SGD's microbatches add into one).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's paths (csrc/clip_reduce.cu ``Path``)
PATHS = ("cp.async", "loads")


def _kernel():
    fn = build.load("clip_reduce").repro_clip_reduce
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int                 # cudaError_t
    return fn


def _path_fn():
    fn = build.load("clip_reduce").repro_clip_reduce_path
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def _check(g, c, out=None):
    if g.dim() != 2 or c.dim() != 1 or c.shape[0] != g.shape[0] \
            or min(g.shape) < 1:
        raise ValueError(f"clip_reduce: want g (B,N), c (B,); got "
                         f"{tuple(g.shape)}, {tuple(c.shape)}")
    if not (g.is_floating_point() and c.is_floating_point()):
        raise TypeError(f"clip_reduce: floating inputs only, got {g.dtype}, "
                        f"{c.dtype}")
    if g.device != c.device:
        raise ValueError("clip_reduce: g, c on different devices")
    if out is not None and (out.shape != g.shape[1:] or out.dtype != torch.float32
                            or out.device != g.device):
        raise ValueError(f"clip_reduce: out must be ({g.shape[1]},) float32 on "
                         f"{g.device}, got {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}")


def clip_reduce_path(g: torch.Tensor, out: torch.Tensor = None) -> str:
    """The kernel path ``clip_reduce(g, c, out=out)`` takes on the card:
    ``cp.async`` (a ring of 16-byte row chunks in shared memory, where the
    row is 16-byte aligned and its chunks fill the card) or ``loads`` (one
    column a thread: narrow or ragged rows, unaligned pointers).  Both sum
    on the CUDA cores."""
    if g.dtype not in _DTYPES:
        raise TypeError(f"clip_reduce: no kernel for {g.dtype}")
    if out is None:     # a fresh output: the caching allocator aligns it
        out_ptr = 256
    else:
        out_ptr = out.data_ptr()
    with torch.cuda.device(g.device):
        p = _path_fn()(g.data_ptr(), out_ptr, g.shape[1], _DTYPES[g.dtype])
    if p < 0:
        raise RuntimeError("clip_reduce: no CUDA device for the path query")
    return PATHS[p]


@build.counted(ref.clip_reduce_ref)
def clip_reduce(g: torch.Tensor, c: torch.Tensor,
                out: torch.Tensor = None) -> torch.Tensor:
    """g: (B, N) per-example gradients, c: (B,) clip factors -> (N,) float32
    ``Σ_b c_b·g_b``, summed over b in order; rows with ``c_b = 0`` add
    exactly nothing.  With ``out`` ((N,) float32) the sum is added into it
    in place, one float32 add a column after the sum over b, and ``out`` is
    returned."""
    global LAUNCHES
    _check(g, c, out)
    if g.device.type == "cpu":
        return ref.clip_reduce_ref(g, c, out=out)
    if g.device.type != "cuda":
        raise ValueError(f"clip_reduce: unsupported device {g.device}")
    if g.dtype not in _DTYPES or c.dtype != torch.float32:
        raise TypeError(f"clip_reduce: kernel takes g float32 or bfloat16 and "
                        f"c float32, got {g.dtype}, {c.dtype}")
    if not (g.is_contiguous() and c.is_contiguous()
            and (out is None or out.is_contiguous())):
        raise ValueError("clip_reduce: g, c and out must be contiguous")
    B, N = g.shape
    if B > 2 ** 31 - 1:
        raise ValueError(f"clip_reduce: {B} rows do not fit an int")
    accumulate = out is not None
    with build.on_device(g):
        if out is None:
            out = torch.empty((N,), dtype=torch.float32, device=g.device)
        if build.is_fake(g):        # a memory trace: the allocation only
            return out
        err = _kernel()(g.data_ptr(), c.data_ptr(), out.data_ptr(), B, N,
                     _DTYPES[g.dtype], int(accumulate),
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"clip_reduce: CUDA launch failed with cudaError_t "
                           f"{err}")
    LAUNCHES += 1
    return out
