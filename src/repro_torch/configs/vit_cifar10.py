"""vit-cifar10 — a small ViT (patch 4 over 32 x 32 x 3: 64 patches, 8
layers at d_model 256), the scale of the DP vision-transformer studies the
augmentation-multiplicity recipe comes from.  The transformer dims are the
``ArchConfig``'s; ``ViTConfig`` holds the image frontend and the explicit
class count (models/vit.py reads ``arch.n_classes``)."""
from repro_torch.configs.base import ArchConfig, ViTConfig

ARCH = ArchConfig(
    name="vit-cifar10",
    family="vit",
    n_layers=8,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    d_ff=1024,
    vocab=10,          # kept in sync with num_classes (the data source uses it)
    mlp_act="gelu",
    rotary_pct=0.0,    # positions come from the learned embedding
    vit=ViTConfig(
        image_size=32,
        in_channels=3,
        patch_size=4,
        num_classes=10,
    ),
    source="ViT-S/4-style CIFAR-10 ViT (DP augmult recipe scale)",
)
