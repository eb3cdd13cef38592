"""Flash attention forward: the CUDA kernel ``csrc/flash_attn_fwd.cu`` and
its wrapper.  Counterpart of ``repro/kernels/flash_attn.py``
``flash_attn_fwd`` (the Pallas TPU kernel).

A CPU tensor takes the plain version (``ref.flash_attn_fwd_ref``); a CUDA
tensor launches the kernel or raises.  ``LAUNCHES`` counts kernel launches
(and nothing else), so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0
MAX_HD = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    fn = build.load("flash_attn_fwd").repro_flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])       # q k v o lse, ints, stream
    fn.restype = ctypes.c_int                 # cudaError_t
    return fn


def _check(q, k, v, rep: int):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_attn_fwd: want q (BH,T,hd), k/v (BH/rep,S,hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BH, T, hd = q.shape
    if rep < 1 or BH % rep or k.shape != v.shape or k.shape[0] != BH // rep \
            or k.shape[2] != hd or min(BH, T, k.shape[1], hd) < 1:
        raise ValueError(f"flash_attn_fwd: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit rep={rep}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attn_fwd: mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attn_fwd: q, k, v on different devices")


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, rep: int = 1):
    """q: (BH, T, hd); k/v: (BH // rep, S, hd), query row b reading kv row
    b // rep.  Returns (o (BH,T,hd) in q's dtype, lse (BH,T) float32)."""
    global LAUNCHES
    _check(q, k, v, rep)
    if q.device.type == "cpu":
        return ref.flash_attn_fwd_ref(q, k, v, causal, rep)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attn_fwd: kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    BH, T, hd = q.shape
    if hd > MAX_HD:
        raise ValueError(f"flash_attn_fwd: head dim {hd} > {MAX_HD}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attn_fwd: q, k, v must be contiguous")
    kernel = _kernel()
    with torch.cuda.device(q.device):
        o = torch.empty_like(q)
        lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
        err = kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), BH, T, k.shape[1], hd, rep, int(causal),
            _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd: CUDA launch failed with "
                           f"cudaError_t {err}")
    LAUNCHES += 1
    return o, lse
