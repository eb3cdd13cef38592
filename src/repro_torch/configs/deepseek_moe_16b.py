"""deepseek-moe-16b — fine-grained MoE: 64 routed top-6 + 2 shared experts,
first layer dense (d_ff 10944). [arXiv:2401.06066]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

ARCH = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    mlp_act="swiglu",
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        num_shared_experts=2,
        d_expert=1408,
        d_shared=2816,        # 2 shared experts x 1408
        capacity_factor=1.25,
        moe_skip_first=1,     # layer 0 is a dense FFN
        d_ff_dense=10944,
    ),
    source="arXiv:2401.06066",
)
