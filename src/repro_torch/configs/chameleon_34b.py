"""chameleon-34b — early-fusion VLM backbone, VQ image tokens, qk-norm. [arXiv:2405.09818]

Backbone only: the VQ-GAN image tokenizer is a stub, and the model takes
precomputed (B, T, d) patch and token embeddings of the fused mixed-modal
sequence (``embed_stub``) with (B, T) labels.
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    mlp_act="swiglu",
    qk_norm=True,
    embed_stub=True,
    use_fsdp=True,
    source="arXiv:2405.09818",
)
