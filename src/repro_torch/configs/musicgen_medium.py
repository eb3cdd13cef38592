"""musicgen-medium — audio decoder backbone over EnCodec tokens. [arXiv:2306.05284]

Backbone only: the EnCodec frontend is a stub, and the model takes
precomputed (B, T, d) frame embeddings (``embed_stub``) with (B, T) labels.
Text-conditioning cross-attention is out of scope, as in the JAX package.
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    mlp_act="gelu",
    embed_stub=True,
    source="arXiv:2306.05284",
)
