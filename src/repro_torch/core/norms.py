"""Per-example squared-gradient-norm rules.  Counterpart of
``repro/core/norms.py``.

For a dense site ``y = x @ w`` with ``x: (B, G, T, d_in)``,
``gy: (B, G, T, d_out)``, the per-example weight-gradient norm is computed
without materialising the per-example weight gradients:

* ``materialize``: ``n_b² = Σ_g ‖x_bgᵀ gy_bg‖²``, the outer-product GEMM
  reduced on the fly.  FLOPs ≈ 2·B·G·T·d_in·d_out.
* ``gram`` (ghost norm): ``n_b² = Σ_g Σ_{t,t'} (x_t·x_t')(gy_t·gy_t')``.
  FLOPs ≈ 2·B·G·T²·(d_in + d_out).
* ``fused``: the ``materialize`` mathematics computed jointly with the
  activation gradient in one backward sweep (core/sites.py routes it to the
  ``dense_bwd_norm`` kernel when ``use_kernels``).

The plain rules below are chunked so their transient stays under
``MAX_CHUNK_ELEMS`` elements, as in the JAX package, and accumulate in
float32 whatever the input type.  An all-zero ``gy`` row gives an exactly
zero norm²: every formula is a sum of products with a ``gy`` factor.
"""
from __future__ import annotations

import torch

F32 = torch.float32

# elements budget for any transient in the norm rules (f32)
MAX_CHUNK_ELEMS = 2 ** 31


def canon4(x: torch.Tensor) -> torch.Tensor:
    """Canonicalize a dense-site operand to (B, G, T, d)."""
    if x.dim() == 2:          # (B, d)
        return x[:, None, None, :]
    if x.dim() == 3:          # (B, T, d)
        return x[:, None, :, :]
    if x.dim() == 4:          # (B, G, T, d)
        return x
    raise ValueError(f"dense site operand must be 2/3/4-D, got {tuple(x.shape)}")


def fold_views4(x4: torch.Tensor, k: int) -> torch.Tensor:
    """Fold the augmentation-multiplicity axis into the contraction axis:
    ``(B·K, G, T, d) -> (B, G, K·T, d)``, rows b-major / k-minor.  With the
    1/K-scaled cotangents every rule then computes the norm² of the
    K-averaged per-example gradient.  ``k == 1`` returns the input."""
    if k == 1:
        return x4
    R, G, T, d = x4.shape
    if R % k:
        raise ValueError(f"{R} rows do not hold {k} views each")
    B = R // k
    return (x4.reshape(B, k, G, T, d).permute(0, 2, 1, 3, 4)
            .reshape(B, G, k * T, d))


def unfold_views4(x4: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of ``fold_views4``: ``(B, G, K·T, d) -> (B·K, G, T, d)``."""
    if k == 1:
        return x4
    B, G, KT, d = x4.shape
    if KT % k:
        raise ValueError(f"contraction length {KT} does not hold {k} views")
    T = KT // k
    return (x4.reshape(B, G, k, T, d).permute(0, 2, 1, 3, 4)
            .reshape(B * k, G, T, d))


def flops_materialize(xs, gys) -> int:
    """``2·B·G·T·d_in·d_out``: one outer-product GEMM per (example, group)."""
    b, g, t, di = xs
    return 2 * b * g * t * di * gys[-1]


def flops_gram(xs, gys) -> int:
    """``2·B·G·T²·(d_in + d_out)``: two (T, T) Grams per (example, group)."""
    b, g, t, di = xs
    return 2 * b * g * t * t * (di + gys[-1])


def flops_fused(xs, gys) -> int:
    """The fused strategy's norm side-channel: the same wgrad-tile sweep as
    ``materialize`` (the dgrad is backprop's own work)."""
    return flops_materialize(xs, gys)


def _divisor_chunk(dim: int, budget_rows: int) -> int:
    """Largest divisor of ``dim`` that is <= budget_rows (>= 1)."""
    budget_rows = max(1, min(dim, budget_rows))
    for c in range(budget_rows, 0, -1):
        if dim % c == 0:
            return c
    return 1


def dense_nsq_materialize(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """(B,G,T,di),(B,G,T,do) -> (B,) squared per-example grad norms,
    chunked over d_in so the (B,G,bi,do) transient stays bounded."""
    B, G, T, di = x.shape
    do = gy.shape[-1]
    bi = _divisor_chunk(di, max(8, MAX_CHUNK_ELEMS // max(B * G * do, 1)))
    gyf = gy.float()
    acc = torch.zeros((B,), dtype=F32, device=x.device)
    for i in range(0, di, bi):
        g = torch.matmul(x[..., i:i + bi].float().transpose(-1, -2), gyf)
        acc += (g * g).sum(dim=(1, 2, 3))
    return acc


def dense_nsq_gram(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Ghost norm, chunked over T so the (B,G,bt,T) Grams stay bounded."""
    B, G, T, di = x.shape
    bt = _divisor_chunk(T, max(8, MAX_CHUNK_ELEMS // max(2 * B * G * T, 1)))
    xf, gyf = x.float(), gy.float()
    acc = torch.zeros((B,), dtype=F32, device=x.device)
    for t in range(0, T, bt):
        a = torch.matmul(xf[:, :, t:t + bt], xf.transpose(-1, -2))
        c = torch.matmul(gyf[:, :, t:t + bt], gyf.transpose(-1, -2))
        acc += (a * c).sum(dim=(1, 2, 3))
    return acc


def embed_nsq(ids: torch.Tensor, gy: torch.Tensor,
              use_kernels: bool = False) -> torch.Tensor:
    """Per-example norm² of the embedding-table gradient, exact under
    repeated tokens.  ids: (B, T) int; gy: (B, T, d).

    With ``use_kernels``: the id-masked ``gram_norm`` kernel
    (Σ_{t,s: id_t = id_s} gy_t·gy_s).  Otherwise the O(B·T·d) sorted
    segment sum: rows of the per-example table gradient are
    Σ_{t: id_t = v} gy_t, so n² = Σ_v ‖Σ_{t: id_t = v} gy_t‖²."""
    if use_kernels:
        from repro_torch.kernels import ops as kops
        return kops.gram_norm(gy[:, None], gy[:, None], mask_ids=ids,
                              square=False)
    B, T = ids.shape
    d = gy.shape[-1]
    ids_s, order = torch.sort(ids, dim=1, stable=True)
    gy_s = torch.gather(gy.float(), 1, order[..., None].expand(B, T, d))
    new_seg = torch.ones((B, T), dtype=torch.int64, device=ids.device)
    new_seg[:, 1:] = (ids_s[:, 1:] != ids_s[:, :-1]).long()
    seg = torch.cumsum(new_seg, dim=1) - 1                      # (B,T) in [0,T)
    sums = torch.zeros((B, T, d), dtype=F32, device=gy.device)
    sums.scatter_add_(1, seg[..., None].expand(B, T, d), gy_s)
    return (sums * sums).sum(dim=(1, 2))


def tap_nsq(gp_b: torch.Tensor) -> torch.Tensor:
    """(B, *param_shape) per-example grads -> (B,) squared norms."""
    g = gp_b.float()
    return (g * g).sum(dim=tuple(range(1, g.dim())))


def bias_nsq(gy: torch.Tensor) -> torch.Tensor:
    """Bias-site rule for ``y = x + b`` (b broadcast over every leading
    dim): n² = Σ_d (Σ_positions gy[b, ..., d])²."""
    g = gy.float().sum(dim=tuple(range(1, gy.dim() - 1)))
    return (g * g).sum(dim=tuple(range(1, g.dim())))
