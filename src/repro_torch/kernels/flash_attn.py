"""Flash attention: the CUDA kernels ``csrc/flash_attn_fwd.cu`` and
``csrc/flash_attn_bwd.cu`` and their wrappers.  Counterpart of
``repro/kernels/flash_attn.py`` ``flash_attn_fwd`` and ``flash_attn_bwd``
(the Pallas TPU kernels).

A CPU tensor takes the plain version (``ref.flash_attn_fwd_ref``,
``ref.flash_attn_bwd_ref``); a CUDA tensor launches the kernel or raises;
a fake one (``launch/memory.py``'s trace) makes the launches' allocations
and launches nothing; under a cost trace (``launch/costs.py``) a call
records the work of its plain version, whichever branch runs
(``build.counted``).
``LAUNCHES`` and ``BWD_LAUNCHES`` count wrapper calls that launched the
forward and the backward kernels (and nothing else), so a run can show
that it went through them; ``fwd_path`` and ``bwd_path`` say which of
the forward's and the backward's paths CUDA operands take.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0
BWD_LAUNCHES = 0
MAX_HD = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    fn = build.load("flash_attn_fwd").repro_flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])       # q k v o lse, ints, stream
    fn.restype = ctypes.c_int                 # cudaError_t
    return fn


def _fwd_path_fn():
    fn = build.load("flash_attn_fwd").repro_flash_attn_fwd_path
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2   # q k v, hd dtype
    fn.restype = ctypes.c_int                 # PATHS index, -1 unknown dtype
    return fn


# the paths of the forward and of the backward (csrc/flash_attn_fwd.cu,
# csrc/flash_attn_bwd.cu): CUDA cores for float32; in bf16 the tensor cores,
# fed by 16-byte cp.async or, where hd % 8 != 0 or a base is not 16-byte
# aligned, by element loads
PATHS = ("cuda-cores", "mma+cp.async", "mma+loads")


def fwd_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The path ``flash_attn_fwd`` takes for these CUDA operands (one of
    ``PATHS``).  Launches nothing."""
    if q.device.type != "cuda" or q.dtype not in _DTYPES:
        raise ValueError(f"fwd_path: want a float32 or bf16 CUDA tensor, got "
                         f"{q.dtype} on {q.device}")
    return PATHS[_fwd_path_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                q.shape[-1], _DTYPES[q.dtype])]


def _bwd_kernel():
    fn = build.load("flash_attn_bwd").repro_flash_attn_bwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])       # q k v do lse delta dq dk dv, ints, stream
    fn.restype = ctypes.c_int                 # cudaError_t
    return fn


def _bwd_path_fn():
    fn = build.load("flash_attn_bwd").repro_flash_attn_bwd_path
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2   # q k v do, hd dtype
    fn.restype = ctypes.c_int                 # PATHS index, -1 unknown dtype
    return fn


def bwd_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             do: torch.Tensor) -> str:
    """The path ``flash_attn_bwd`` takes for these CUDA operands (one of
    ``PATHS``: the backward's two launches take the same one).
    Launches nothing."""
    if q.device.type != "cuda" or q.dtype not in _DTYPES:
        raise ValueError(f"bwd_path: want a float32 or bf16 CUDA tensor, got "
                         f"{q.dtype} on {q.device}")
    return PATHS[_bwd_path_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                do.data_ptr(), q.shape[-1], _DTYPES[q.dtype])]


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


@build.counted(lambda q, k, v, causal=True, rep=1:
               ref.flash_attn_fwd_ref(q, k, v, causal, rep))
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
    with build.on_device(q):
        o = torch.empty_like(q)
        lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
        if build.is_fake(q):        # a memory trace: the allocations only
            return o, lse
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), BH, T, k.shape[1], hd, rep, int(causal),
            _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd: CUDA launch failed with "
                           f"cudaError_t {err}")
    LAUNCHES += 1
    return o, lse


@build.counted(lambda q, k, v, o, lse, do, causal=True, rep=1:
               ref.flash_attn_bwd_ref(q, k, v, o, lse, do, causal, rep))
def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                   causal: bool = True, rep: int = 1):
    """q/o/do: (BH, T, hd); k/v: (BH // rep, S, hd); lse: (BH, T) float32
    from ``flash_attn_fwd``.  Returns float32 (dq (BH,T,hd), dk, dv
    (BH//rep,S,hd)).  As in the JAX package, ``delta = Σ do∘o`` is computed
    before the kernels and the GQA rep-sum of the per-query-head dk/dv
    after them."""
    global BWD_LAUNCHES
    _check(q, k, v, rep)
    BH, T, hd = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (BH, T):
        raise ValueError(f"flash_attn_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if not (o.dtype == do.dtype == q.dtype) or lse.dtype != torch.float32:
        raise TypeError(f"flash_attn_bwd: dtypes o {o.dtype}, do {do.dtype}, "
                        f"lse {lse.dtype} (want q's, q's, float32)")
    if not (q.device == o.device == do.device == lse.device):
        raise ValueError("flash_attn_bwd: inputs on different devices")
    if q.device.type == "cpu":
        return ref.flash_attn_bwd_ref(q, k, v, o, lse, do, causal, rep)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_bwd: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attn_bwd: kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if hd > MAX_HD:
        raise ValueError(f"flash_attn_bwd: head dim {hd} > {MAX_HD}")
    if not all(t.is_contiguous() for t in (q, k, v, o, lse, do)):
        raise ValueError("flash_attn_bwd: inputs must be contiguous")
    S = k.shape[1]
    fake = build.is_fake(q)
    with build.on_device(q):
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = torch.empty((BH, T, hd), dtype=torch.float32, device=q.device)
        dkh = torch.empty((BH, S, hd), dtype=torch.float32, device=q.device)
        dvh = torch.empty((BH, S, hd), dtype=torch.float32, device=q.device)
        err = 0 if fake else _bwd_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                     dkh.data_ptr(), dvh.data_ptr(), BH, T, S, hd, rep,
                     int(causal), _DTYPES[q.dtype],
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd: CUDA launch failed with "
                           f"cudaError_t {err}")
    if not fake:                    # a memory trace launches nothing
        BWD_LAUNCHES += 1
    if rep > 1:
        dkh = dkh.reshape(BH // rep, rep, S, hd).sum(dim=1)
        dvh = dvh.reshape(BH // rep, rep, S, hd).sum(dim=1)
    return dq, dkh, dvh
