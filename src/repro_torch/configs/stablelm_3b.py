"""stablelm-3b — dense, partial rotary (25%), SwiGLU. [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
    mlp_act="swiglu",
    rotary_pct=0.25,
    source="hf:stabilityai/stablelm-2-1_6b",
)
