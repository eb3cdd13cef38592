"""Data pipeline of the port (``repro/data`` counterpart)."""
from repro_torch.data.pipeline import SyntheticSource, batch_for, make_source

__all__ = ["SyntheticSource", "batch_for", "make_source"]
