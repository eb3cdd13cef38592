"""chatglm3-6b — dense, GQA kv=2, 2d-RoPE (partial, 50%), SwiGLU. [arXiv:2406.12793]"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    mlp_act="swiglu",
    rotary_pct=0.5,   # ChatGLM's 2d-RoPE == rotary applied to half the head dim
    source="arXiv:2406.12793",
)
