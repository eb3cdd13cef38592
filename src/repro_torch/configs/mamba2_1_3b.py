"""mamba2-1.3b — attention-free SSM with SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig, MambaConfig

ARCH = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    tie_embeddings=True,
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
    source="arXiv:2405.21060",
)
