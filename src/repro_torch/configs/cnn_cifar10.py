"""cnn-cifar10 — a pre-activation ResNet (3 stages x 3 blocks, 16/32/64
channels over 32 x 32 x 3 inputs: ResNet-20-class capacity), the scale of
DP-SGD CNN studies.  ``vocab`` doubles as the class count (models/cnn.py)."""
from repro_torch.configs.base import ArchConfig, CNNConfig

ARCH = ArchConfig(
    name="cnn-cifar10",
    family="cnn",
    n_layers=0,        # transformer fields unused by family="cnn"
    d_model=0,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=10,          # class count
    cnn=CNNConfig(
        image_size=32,
        in_channels=3,
        stage_channels=(16, 32, 64),
        blocks_per_stage=3,
        kernel=3,
    ),
    source="ResNet-20-style CIFAR-10 CNN (DP-SGD benchmark scale)",
)
