"""grok-1-314b — MoE, 8 experts top-2, GQA kv=8. [hf:xai-org/grok-1]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

ARCH = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    mlp_act="swiglu",
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32768, capacity_factor=1.25),
    use_fsdp=True,
    source="hf:xai-org/grok-1",
)
