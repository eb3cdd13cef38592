"""DP core of the port: the ``DPContext`` side-channel, the site registry,
the norm rules, clipping, noise, the algorithms and the accountant."""
from repro_torch.core.accountant import (PrivacyAccountant, compute_epsilon,
                                         rdp_to_eps_classic)
from repro_torch.core.algo import (list_algos, make_noisy_grad_fn,
                                   register_algo, unregister_algo)
from repro_torch.core.context import DPContext
from repro_torch.core.sites import (SiteSpec, get_site, list_sites,
                                    list_strategies, register_site, site_flops,
                                    unregister_site)

__all__ = ["DPContext", "PrivacyAccountant", "compute_epsilon",
           "rdp_to_eps_classic", "make_noisy_grad_fn", "register_algo",
           "unregister_algo", "list_algos", "SiteSpec", "register_site",
           "unregister_site", "get_site", "list_sites", "list_strategies",
           "site_flops"]
