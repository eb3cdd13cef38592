"""Data pipeline of the port (``repro/data`` counterpart)."""
from repro_torch.data.pipeline import (MemmapSource, SyntheticSource,
                                       augment_expand, batch_for, make_source,
                                       poisson_batch_for, poisson_capacity,
                                       poisson_sample_indices)

__all__ = ["MemmapSource", "SyntheticSource", "augment_expand", "batch_for",
           "make_source", "poisson_batch_for", "poisson_capacity",
           "poisson_sample_indices"]
