"""RDP accountant for the Poisson-subsampled Gaussian mechanism: the part
the serving ledger prices requests with.

The port's own copy of those functions of ``repro/core/accountant.py``
(pure Python; importing the JAX package's module would run
``repro/core/__init__.py``, which imports JAX).  Integer-order RDP bound of
Mironov et al. (2019) and the Canonne–Kamath–Steinke (2020) RDP -> (ε, δ)
conversion.  The training slice copies the rest (``compute_epsilon_*``,
``PrivacyAccountant``) when it needs them.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence, Tuple

# Dense low-order coverage (the optimum for practical (q, σ) almost always
# lies below 128), then geometric tail for tiny-ε / huge-σ regimes.
DEFAULT_ORDERS: Tuple[int, ...] = tuple(range(2, 129)) + (
    144, 160, 192, 224, 256, 320, 384, 448, 512, 768, 1024, 1536, 2048,
    3072, 4096)


def _log_binom(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def _logsumexp(xs: Iterable[float]) -> float:
    xs = list(xs)
    m = max(xs)
    if m == -math.inf:
        return -math.inf
    return m + math.log(sum(math.exp(x - m) for x in xs))


def rdp_subsampled_gaussian(q: float, sigma: float, order: int) -> float:
    """RDP(order) of one step of the Poisson-subsampled Gaussian mechanism."""
    if q < 0 or q > 1:
        raise ValueError(f"sampling rate q={q} not in [0,1]")
    if sigma <= 0:
        return math.inf
    if q == 0.0:
        return 0.0
    if order < 2 or order != int(order):
        raise ValueError(f"integer order >= 2 required, got {order}")
    order = int(order)
    if q == 1.0:
        return order / (2 * sigma ** 2)
    # log E_k [ C(a,k) (1-q)^(a-k) q^k exp((k^2-k)/(2 sigma^2)) ]
    terms = []
    for k in range(order + 1):
        t = (_log_binom(order, k)
             + (order - k) * math.log1p(-q)
             + k * math.log(q)
             + (k * k - k) / (2 * sigma ** 2))
        terms.append(t)
    return _logsumexp(terms) / (order - 1)


def rdp_to_eps(rdp: float, order: int, delta: float) -> float:
    """Canonne–Kamath–Steinke conversion: tighter than the classic
    eps = rdp + log(1/delta)/(order-1)."""
    if delta <= 0 or delta >= 1:
        raise ValueError(f"delta={delta} not in (0,1)")
    a = float(order)
    return max(0.0, rdp + math.log((a - 1) / a)
               - (math.log(delta) + math.log(a)) / (a - 1))


def rdp_curve(sample_rate: float, noise_multiplier: float,
              orders: Sequence[int] = DEFAULT_ORDERS) -> Tuple[float, ...]:
    """Per-order RDP of ONE step of the subsampled Gaussian — the additive
    unit of heterogeneous composition (the serving ledger composes one
    curve per admitted request and converts the running sum)."""
    return tuple(rdp_subsampled_gaussian(sample_rate, noise_multiplier, a)
                 for a in orders)


def eps_from_rdp_curve(rdp: Sequence[float], orders: Sequence[int],
                       delta: float,
                       conversion=rdp_to_eps) -> Tuple[float, int]:
    """(ε, best_order): optimize the conversion of an accumulated RDP curve
    over a FIXED order grid (the curve is a running sum keyed to
    ``orders``, so the grid cannot grow after the fact)."""
    if len(rdp) != len(orders):
        raise ValueError(f"curve length {len(rdp)} != grid length "
                         f"{len(orders)}")
    best_eps, best_a = math.inf, int(orders[0])
    for r, a in zip(rdp, orders):
        try:
            e = conversion(float(r), int(a), delta)
        except (OverflowError, ValueError):
            continue
        if e < best_eps:
            best_eps, best_a = e, int(a)
    return best_eps, best_a
