"""repro_torch.dist: the distribution layer, counterpart of
``repro/dist``.

* ``sharding``: logical-axis -> mesh placement rules and the placement
  trees of params, batches, train states (ZeRO-1) and caches.
* ``runtime``: the ambient ``layout``, ``batch_local``/``attn_local``,
  the collectives of data-parallel DP-SGD and the init fingerprint.
* ``compress``: int8 + error-feedback gradient compression.
"""
from repro_torch.dist import compress, runtime, sharding
from repro_torch.dist.compress import compress_grads, init_error_state
from repro_torch.dist.runtime import (attn_local, batch_local, init_fingerprint,
                                      layout, verify_init_consistency)
from repro_torch.dist.sharding import (batch_axis_width, batch_pspec,
                                       batch_shardings, cache_shardings,
                                       mesh_from_config, param_shardings,
                                       spec_for_param, stage_axis_width,
                                       state_shardings)

__all__ = [
    "compress", "runtime", "sharding",
    "compress_grads", "init_error_state",
    "attn_local", "batch_local", "layout",
    "init_fingerprint", "verify_init_consistency",
    "batch_axis_width", "batch_pspec", "batch_shardings", "cache_shardings",
    "mesh_from_config", "param_shardings", "spec_for_param",
    "stage_axis_width", "state_shardings",
]
