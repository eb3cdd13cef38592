"""Training runtime of the port (``repro/train`` counterpart)."""
from repro_torch.train.state import TrainState
from repro_torch.train.trainer import Trainer

__all__ = ["TrainState", "Trainer"]
