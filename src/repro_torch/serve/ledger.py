"""Per-user privacy-budget ledger for the serving tier.

The port's own copy of ``repro/serve/ledger.py`` (numpy only; the JAX
package's ``repro.serve`` cannot be imported without JAX).

"How to DP-fy ML" makes *user-level* ε the unit that matters for a
fine-tuning-as-a-service deployment: each tenant's queries against a
DP-trained model (or each private fine-tuning job they trigger) compose,
and once a tenant's cumulative ε crosses their contract budget, further
requests must be refused — by the serving tier at admission, because the
trainer is long gone by then.

The ledger accumulates, per user, a full RDP curve over a fixed order
grid (``core/accountant.py`` ``rdp_curve``): heterogeneous charges —
different (sample_rate, noise_multiplier) per request — compose additively
per order, and ε is the order-optimized conversion of the running sum
(``eps_from_rdp_curve``).  This is strictly tighter than adding per-request
ε values, and unlike ``compute_epsilon_composed`` it does not assume every
mechanism runs every step.

Admission protocol (engine-side):

* ``submit``  — policy "refuse": an already-over-budget user's request
  raises ``BudgetExceeded`` immediately.  Policy "queue": the request is
  deferred instead, replayed after ``refresh`` restores the budget.
* admission — the real gate.  ``admits(user, charge)`` asks whether the
  *post-charge* ε stays within budget; ``charge`` commits it.  Charging at
  admission (not submit) means queued requests can't collectively
  overdraw: each is priced the moment it gets a slot.

State is three numbers per user plus the grid, so checkpoint/restore is a
JSON round-trip (``save``/``load``), mirroring the adaptive-clip rider.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.accountant import (DEFAULT_ORDERS, eps_from_rdp_curve,
                                   rdp_curve, rdp_to_eps)


class RequestCharge(NamedTuple):
    """Privacy price of one request: ``steps`` compositions of the
    subsampled Gaussian at (sample_rate, noise_multiplier).  The serving
    default (one private query per request) is steps=1."""
    sample_rate: float
    noise_multiplier: float
    steps: int = 1


class BudgetExceeded(Exception):
    """Raised (policy "refuse") when a request would overdraw its user's ε
    budget.  ``user``/``epsilon``/``budget`` carry the refusal context."""

    def __init__(self, user: str, epsilon: float, budget: float):
        self.user = user
        self.epsilon = epsilon
        self.budget = budget
        super().__init__(f"user {user!r}: composed eps {epsilon:.4g} "
                         f"exceeds budget {budget:.4g}")


class PrivacyLedger:
    """Per-user RDP composition with a hard ε budget.

    ``policy``: "refuse" — over-budget submits raise ``BudgetExceeded``;
    "queue" — the engine parks them on a deferred list and replays after
    ``refresh()`` (the ``version`` counter tells the engine a refresh
    happened).  ``default_charge`` prices requests that don't carry their
    own ``Request.charge``; with neither, admission is free (the ledger
    only *tracks*)."""

    POLICIES = ("refuse", "queue")

    def __init__(self, budget_eps: float, delta: float,
                 policy: str = "refuse",
                 orders: Sequence[int] = DEFAULT_ORDERS,
                 default_charge: Optional[RequestCharge] = None,
                 conversion=rdp_to_eps):
        if budget_eps <= 0:
            raise ValueError(f"budget_eps={budget_eps} must be > 0")
        if policy not in self.POLICIES:
            raise ValueError(f"policy {policy!r} not in {self.POLICIES}")
        self.budget_eps = float(budget_eps)
        self.delta = float(delta)
        self.policy = policy
        self.orders = tuple(int(a) for a in orders)
        self.default_charge = default_charge
        self.conversion = conversion
        self.version = 0                 # bumped by refresh(); the engine
        self._rdp: Dict[str, np.ndarray] = {}  # replays deferred reqs on it
        self._curves: Dict[Tuple[float, float], np.ndarray] = {}

    # -- pricing -----------------------------------------------------------
    def _curve(self, charge: RequestCharge) -> np.ndarray:
        key = (float(charge.sample_rate), float(charge.noise_multiplier))
        c = self._curves.get(key)
        if c is None:
            c = np.array(rdp_curve(key[0], key[1], self.orders), np.float64)
            self._curves[key] = c
        return c * int(charge.steps)

    def _user_rdp(self, user: str) -> np.ndarray:
        r = self._rdp.get(user)
        if r is None:
            r = np.zeros((len(self.orders),), np.float64)
            self._rdp[user] = r
        return r

    # -- queries -----------------------------------------------------------
    def epsilon(self, user: str) -> float:
        """Composed ε of everything charged to ``user`` so far."""
        r = self._rdp.get(user)
        if r is None or not r.any():
            return 0.0
        eps, _ = eps_from_rdp_curve(r, self.orders, self.delta,
                                    self.conversion)
        return eps

    def admits(self, user: str, charge: Optional[RequestCharge] = None) -> bool:
        """Would charging ``user`` keep them within budget?  Pure query —
        commits nothing."""
        charge = charge if charge is not None else self.default_charge
        if charge is None:
            return self.epsilon(user) <= self.budget_eps
        post = self._user_rdp(user) + self._curve(charge)
        eps, _ = eps_from_rdp_curve(post, self.orders, self.delta,
                                    self.conversion)
        return eps <= self.budget_eps

    # -- mutation ----------------------------------------------------------
    def charge(self, user: str, charge: Optional[RequestCharge] = None) -> float:
        """Commit a charge; returns the user's post-charge ε."""
        charge = charge if charge is not None else self.default_charge
        if charge is not None:
            self._rdp[user] = self._user_rdp(user) + self._curve(charge)
        return self.epsilon(user)

    def refresh(self, user: Optional[str] = None) -> None:
        """Reset one user's (or everyone's) accumulated budget — the
        contract-renewal event.  Bumps ``version`` so the engine replays
        queued-behind-refresh requests."""
        if user is None:
            self._rdp.clear()
        else:
            self._rdp.pop(user, None)
        self.version += 1

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "budget_eps": self.budget_eps,
            "delta": self.delta,
            "policy": self.policy,
            "orders": list(self.orders),
            "version": self.version,
            # without this, a restored ledger would price requests at None
            # and silently stop enforcing anything
            "default_charge": (None if self.default_charge is None
                               else list(self.default_charge)),
            "rdp": {u: [float(x) for x in r] for u, r in self._rdp.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        if tuple(state["orders"]) != self.orders:
            raise ValueError("ledger restore: order grid mismatch (curves "
                             "are keyed to the grid and cannot be resampled)")
        self.budget_eps = float(state["budget_eps"])
        self.delta = float(state["delta"])
        self.policy = state["policy"]
        self.version = int(state["version"])
        dc = state.get("default_charge")
        self.default_charge = None if dc is None else RequestCharge(*dc)
        self._rdp = {u: np.array(r, np.float64)
                     for u, r in state["rdp"].items()}

    def save(self, path: str) -> None:
        d = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".ledger.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.state_dict(), f, indent=2)
            os.replace(tmp, path)       # atomic: restore never sees a torn file
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, path: str, conversion=rdp_to_eps) -> "PrivacyLedger":
        with open(path) as f:
            state = json.load(f)
        led = cls(state["budget_eps"], state["delta"], state["policy"],
                  orders=tuple(state["orders"]), conversion=conversion)
        led.load_state_dict(state)
        return led
