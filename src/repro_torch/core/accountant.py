"""RDP accountant for the Poisson-subsampled Gaussian mechanism: what the
trainer reports ε with and the serving ledger prices requests with.

The port's own copy of ``repro/core/accountant.py`` (pure Python; importing
the JAX package's module would run ``repro/core/__init__.py``, which imports
JAX).  Integer-order RDP bound of Mironov et al. (2019) and the
Canonne–Kamath–Steinke (2020) RDP -> (ε, δ) conversion.  The order grid
extends itself while the optimum sits on its upper edge, and the winning
order is re-derived through an independent numerical path.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

# Dense low-order coverage (the optimum for practical (q, σ) almost always
# lies below 128), then geometric tail for tiny-ε / huge-σ regimes.
DEFAULT_ORDERS: Tuple[int, ...] = tuple(range(2, 129)) + (
    144, 160, 192, 224, 256, 320, 384, 448, 512, 768, 1024, 1536, 2048,
    3072, 4096)

# hard ceiling for automatic grid extension (ε(a) is flat this far out)
MAX_ORDER = 1 << 17


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


def rdp_to_eps_classic(rdp: float, order: int, delta: float) -> float:
    """The classic Mironov (2017) conversion, eps = rdp + log(1/δ)/(a-1).

    Looser than CKS; kept so ε can be compared against published
    TF-Privacy / Opacus numbers, which use this conversion."""
    if delta <= 0 or delta >= 1:
        raise ValueError(f"delta={delta} not in (0,1)")
    return max(0.0, rdp + math.log(1.0 / delta) / (order - 1))


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


def _rdp_direct_sum(q: float, sigma: float, order: int) -> Optional[float]:
    """Independent re-derivation of ``rdp_subsampled_gaussian`` for the
    self-consistency check: exact integer binomials and compensated
    linear-space summation.  None where float64 would overflow."""
    a = int(order)
    if a > 512 or (a * a - a) / (2 * sigma ** 2) > 700:
        return None
    total = math.fsum(
        math.comb(a, k) * (1 - q) ** (a - k) * q ** k
        * math.exp((k * k - k) / (2 * sigma ** 2))
        for k in range(a + 1))
    if total <= 0.0 or math.isinf(total):
        return None
    return math.log(total) / (a - 1)


def _extend_orders(orders: Sequence[int]) -> Tuple[int, ...]:
    """Geometric continuation past the current grid max."""
    top = orders[-1]
    new = []
    a = top
    while a < min(top * 8, MAX_ORDER):
        a = min(int(a * 1.5) + 1, MAX_ORDER)
        new.append(a)
    return tuple(orders) + tuple(new)


class Mechanism(NamedTuple):
    """One Poisson-subsampled Gaussian mechanism running every step."""
    name: str
    sample_rate: float
    noise_multiplier: float


def compute_epsilon_composed(
        steps: int, mechanisms: Sequence[Mechanism], delta: float,
        orders: Sequence[int] = DEFAULT_ORDERS, conversion=rdp_to_eps,
        rdp1_cache: Optional[Dict[int, float]] = None) -> Tuple[float, int]:
    """(ε, best_order) after ``steps`` steps, each running every mechanism
    once: per-step RDP(a) = Σᵢ RDPᵢ(a), optimized over orders.
    ``rdp1_cache``: optional {order: per-step RDP} for repeated queries at a
    fixed mechanism set."""
    if steps < 0:
        raise ValueError(f"steps={steps} < 0")
    mechs = [m for m in mechanisms if m.sample_rate != 0.0]
    if steps == 0 or not mechs:
        return 0.0, int(orders[0])
    if any(m.noise_multiplier <= 0 for m in mechs):
        return math.inf, int(orders[0])

    grid = tuple(sorted({int(a) for a in orders}))
    evaluated: Dict[int, float] = {}

    def rdp1(a: int) -> float:
        if rdp1_cache is not None and a in rdp1_cache:
            return rdp1_cache[a]
        r = math.fsum(rdp_subsampled_gaussian(m.sample_rate,
                                              m.noise_multiplier, a)
                      for m in mechs)
        if rdp1_cache is not None:
            rdp1_cache[a] = r
        return r

    def eps_at(a: int) -> float:
        if a not in evaluated:
            try:
                evaluated[a] = conversion(steps * rdp1(a), a, delta)
            except (OverflowError, ValueError):
                evaluated[a] = math.inf
        return evaluated[a]

    while True:
        best_a = min(grid, key=eps_at)
        if eps_at(best_a) == math.inf:
            return math.inf, grid[0]
        if eps_at(best_a) == 0.0:
            return 0.0, best_a
        if best_a != grid[-1] or grid[-1] >= MAX_ORDER:
            break
        grid = _extend_orders(grid)          # optimum on the edge: grow

    # ternary search between the neighbouring grid points (ε(a) unimodal)
    i = grid.index(best_a)
    lo = grid[i - 1] if i > 0 else 2
    hi = grid[i + 1] if i + 1 < len(grid) else min(2 * best_a, MAX_ORDER)
    while hi - lo > 2:
        m1 = lo + (hi - lo) // 3
        m2 = hi - (hi - lo) // 3
        if eps_at(m1) <= eps_at(m2):
            hi = m2
        else:
            lo = m1
    best_a = min(range(lo, hi + 1), key=eps_at)
    best_eps = eps_at(best_a)
    directs = [_rdp_direct_sum(m.sample_rate, m.noise_multiplier, best_a)
               for m in mechs]
    if all(d is not None for d in directs):
        direct, r = math.fsum(directs), rdp1(best_a)
        if not math.isclose(direct, r, rel_tol=1e-6, abs_tol=1e-9):
            raise AssertionError(
                f"accountant self-consistency: per-step RDP({best_a}) = {r} "
                f"vs independent re-derivation {direct}")
    for a in (best_a - 1, best_a + 1):
        if a >= 2 and eps_at(a) < best_eps - 1e-12:
            raise AssertionError(
                f"accountant grid not locally minimal: eps({a}) = "
                f"{eps_at(a)} < eps({best_a}) = {best_eps}")
    return best_eps, best_a


def compute_epsilon_from_rate(
        steps: int, sample_rate: float, noise_multiplier: float, delta: float,
        orders: Sequence[int] = DEFAULT_ORDERS, conversion=rdp_to_eps,
        rdp1_cache: Optional[Dict[int, float]] = None) -> Tuple[float, int]:
    """(ε, best_order) after ``steps`` steps at per-step sample rate q."""
    return compute_epsilon_composed(
        steps, (Mechanism("grad", sample_rate, noise_multiplier),), delta,
        orders=orders, conversion=conversion, rdp1_cache=rdp1_cache)


def compute_epsilon(steps: int, batch_size: int, dataset_size: int,
                    noise_multiplier: float, delta: float,
                    orders: Sequence[int] = DEFAULT_ORDERS) -> Tuple[float, int]:
    """(ε, best_order) after ``steps`` DP-SGD steps at q = B/N."""
    return compute_epsilon_from_rate(steps, batch_size / dataset_size,
                                     noise_multiplier, delta, orders)


class PrivacyAccountant:
    """Stateful wrapper the trainer polls: the step count prices the
    composition of ``mechanisms`` (the gradient mechanism first).
    ``sample_rate`` takes precedence over ``batch_size / dataset_size``."""

    def __init__(self, batch_size: int, dataset_size: int,
                 noise_multiplier: float, delta: float,
                 sample_rate: Optional[float] = None):
        self.batch_size = batch_size
        self.dataset_size = dataset_size
        self.noise_multiplier = noise_multiplier
        self.delta = delta
        self.sample_rate = (sample_rate if sample_rate is not None
                            else batch_size / dataset_size)
        self.mechanisms: List[Mechanism] = [
            Mechanism("grad", self.sample_rate, noise_multiplier)]
        # per-step RDP does not depend on the step count: cached per set
        self._caches: Dict[tuple, Dict[int, float]] = {}

    def compose(self, mechanism: Mechanism) -> None:
        """Add a per-step mechanism (re-composing a name replaces it)."""
        if any(m.name == mechanism.name for m in self.mechanisms):
            self.mechanisms = [mechanism if m.name == mechanism.name else m
                               for m in self.mechanisms]
        else:
            self.mechanisms = self.mechanisms + [mechanism]

    def _epsilon(self, step: int, mechs: Tuple[Mechanism, ...]) -> float:
        if step <= 0:
            return 0.0
        key = tuple((m.sample_rate, m.noise_multiplier) for m in mechs)
        cache = self._caches.setdefault(key, {})
        eps, _ = compute_epsilon_composed(step, mechs, self.delta,
                                          rdp1_cache=cache)
        return eps

    def epsilon_at(self, step: int) -> float:
        """ε of the full composition after ``step`` steps."""
        return self._epsilon(step, tuple(self.mechanisms))

    def epsilon_breakdown(self, step: int) -> Dict[str, float]:
        """{"eps_<name>": ε of that mechanism alone, ..., "eps_total"}."""
        out = {f"eps_{m.name}": self._epsilon(step, (m,))
               for m in self.mechanisms}
        out["eps_total"] = self.epsilon_at(step)
        return out
