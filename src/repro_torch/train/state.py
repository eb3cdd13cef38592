"""TrainState: the step count, the params and the optimizer state.
Counterpart of ``repro/train/state.py``; the params are the model's own
tensors, which the optimizer updates in place."""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any
