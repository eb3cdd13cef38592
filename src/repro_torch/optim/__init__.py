"""Optimizers of the port (``repro/optim`` counterpart)."""
from repro_torch.optim.optimizers import Optimizer, lr_at, make_optimizer

__all__ = ["Optimizer", "lr_at", "make_optimizer"]
