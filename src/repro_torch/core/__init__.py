"""DP core of the port: the ``DPContext`` side-channel, the site registry,
the norm rules, clipping, noise, the algorithms and the accountant."""
from repro_torch.core.accountant import PrivacyAccountant, compute_epsilon
from repro_torch.core.algo import make_noisy_grad_fn, register_algo
from repro_torch.core.context import DPContext

__all__ = ["DPContext", "PrivacyAccountant", "compute_epsilon",
           "make_noisy_grad_fn", "register_algo"]
