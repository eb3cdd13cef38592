"""Configs: the port's own copy of ``repro.configs.base``.

``ArchConfig`` is limited to the fields the dense, MoE, SSM and hybrid
decoders and the two image families (``cnn``, ``vit``) read, so a layer
pattern reads the same as there.  The shape, DP, optimizer, mesh and
training configs keep the JAX package's field names, so ``--set a.b=c``
overrides read the same in both packages, but only for what the port runs.
``TuneConfig`` is the launch autotuner's (launch/autotune.py), as in the
JAX package.  A key of a part the port has not taken over would be listed
in ``NOT_PORTED`` and raise ``NotImplementedError`` on ``--set`` (none is
now).  The ``Trainer`` holds the model's parameter and compute types to
``param_dtype`` and ``compute_dtype``, and its remat policy to ``remat``.
"""
from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

# Layer kinds used in ``layer_pattern``.
ATTN = "attn"
MAMBA = "mamba"


@dataclass(frozen=True)
class MoEConfig:
    """The routed-expert FFN of family ``"moe"`` (models/moe.py) and which
    layers carry it."""
    num_experts: int = 0            # routed experts (0 = dense FFN)
    top_k: int = 2
    num_shared_experts: int = 0     # DeepSeek-style always-on experts
    capacity_factor: float = 1.25
    d_expert: int = 0               # per-expert FFN hidden dim
    d_shared: int = 0               # shared-expert FFN hidden dim (total)
    # which layers are MoE: every `moe_period` layers, starting at `moe_offset`
    moe_period: int = 1
    moe_offset: int = 0
    moe_skip_first: int = 0         # first N layers stay dense
    d_ff_dense: int = 0             # dense-FFN width for non-MoE layers (0 -> d_ff)

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class CNNConfig:
    """The pre-activation ResNet of family ``"cnn"`` (models/cnn.py): per
    stage ``blocks_per_stage`` residual blocks of ``kernel`` x ``kernel``
    convolutions; normalisation per example, never BatchNorm."""
    image_size: int = 32
    in_channels: int = 3
    stage_channels: Tuple[int, ...] = (16, 32, 64)   # one entry per stage
    blocks_per_stage: int = 2
    kernel: int = 3
    num_classes: int = 0            # 0 = inherit ArchConfig.vocab


@dataclass(frozen=True)
class ViTConfig:
    """The image frontend of family ``"vit"`` (models/vit.py): a patch
    embedding of stride = kernel = ``patch_size``; the transformer dims are
    the ``ArchConfig``'s."""
    image_size: int = 32
    in_channels: int = 3
    patch_size: int = 4
    num_classes: int = 0            # 0 = inherit ArchConfig.vocab

    @property
    def grid(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(f"patch {self.patch_size} does not tile image "
                             f"{self.image_size}")
        return self.image_size // self.patch_size

    @property
    def n_patches(self) -> int:
        return self.grid * self.grid


@dataclass(frozen=True)
class MambaConfig:
    """The Mamba2 mixer of families ``"ssm"`` and ``"hybrid"``
    (models/mamba2.py)."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256                # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str             # dense | ssm | moe | hybrid | audio | vlm | cnn | vit
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0         # partial rotary (stablelm 0.25, chatglm 0.5)
    qk_norm: bool = False
    mlp_act: str = "swiglu"         # swiglu | gelu
    # read only by the GEMM tables (sim/models.py): the decoder keeps its
    # own head, as the JAX transformer does
    tie_embeddings: bool = False
    layer_pattern: Optional[Tuple[str, ...]] = None
    moe: MoEConfig = field(default_factory=MoEConfig)
    mamba: MambaConfig = field(default_factory=MambaConfig)
    cnn: CNNConfig = field(default_factory=CNNConfig)  # family == "cnn" only
    vit: ViTConfig = field(default_factory=ViTConfig)  # family == "vit" only
    embed_stub: bool = False
    # shard params over the data axis too (FSDP; dist/sharding.py)
    use_fsdp: bool = False
    norm_eps: float = 1e-5
    source: str = ""

    @property
    def n_classes(self) -> int:
        """Classifier width of the image families: the explicit
        ``num_classes``, else ``vocab``."""
        if self.family == "vit":
            return self.vit.num_classes or self.vocab
        return self.cnn.num_classes or self.vocab

    def image_shape(self) -> Tuple[int, int, int]:
        """(H, W, C) input geometry of the image families."""
        c = self.vit if self.family == "vit" else self.cnn
        return (c.image_size, c.image_size, c.in_channels)

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern is not None:
            per = self.layer_pattern
            if self.n_layers % len(per):
                raise ValueError(f"{self.name}: {self.n_layers} layers do "
                                 f"not tile the {len(per)}-layer pattern")
            return per * (self.n_layers // len(per))
        if self.family == "ssm":
            return (MAMBA,) * self.n_layers
        return (ATTN,) * self.n_layers

    def is_moe_layer(self, i: int) -> bool:
        m = self.moe
        return (m.enabled and i >= m.moe_skip_first
                and (i % m.moe_period == m.moe_offset))

    def ff_dense(self) -> int:
        return self.moe.d_ff_dense or self.d_ff


# ---------------------------------------------------------------------------
# Input shapes: train / prefill / decode / long-context decode
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence mixing: only ssm/hybrid run it
LONG_OK_FAMILIES = ("ssm", "hybrid")
IMAGE_FAMILIES = ("cnn", "vit")


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> bool:
    if arch.family in IMAGE_FAMILIES:
        return shape.kind == "train"   # image models neither prefill nor decode
    if shape.name == "long_500k":
        return arch.family in LONG_OK_FAMILIES
    return True


# ---------------------------------------------------------------------------
# Mesh / DP / optim / train configs
# ---------------------------------------------------------------------------

# "none" stores every activation for the backward, "block" only each
# block's input, "sites" the operands the DP norm rules consume
# (models/layers.py remat_wrap)
REMAT_POLICIES: Tuple[str, ...] = ("none", "block", "sites")


# each family's remat policies (launch/autotune.py's remat gene), as in the
# JAX package: every family implements the same three
FAMILY_REMAT_POLICIES: Dict[str, Tuple[str, ...]] = {
    family: REMAT_POLICIES for family in (
        "dense", "ssm", "moe", "hybrid", "audio", "vlm", "cnn", "vit")}


def validate_remat(remat: str) -> str:
    """Raise on a policy the port does not implement, listing the known
    ones; never a silent fall-through to no checkpointing."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; known policies: "
                         f"{sorted(REMAT_POLICIES)}")
    return remat

# --set keys of the JAX package's configs that the port leaves out: the key
# (or its first part) -> the feature, named in the error
NOT_PORTED: Dict[str, str] = {}


@dataclass(frozen=True)
class MeshConfig:
    """A device mesh: one size an axis, the axes named from ``data``,
    ``pod``, ``model`` and ``stage`` (dist/sharding.py)."""
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class DPConfig:
    """DP-SGD configuration, as in the JAX package (its docstring is the
    reference).  In the port:

    ``algo``: ``"sgd"`` (non-private mean-loss gradient), ``"dpsgd"``
    (vanilla DP-SGD: per-example gradients, ``microbatch`` examples at a
    time, clipped and summed), ``"dpsgd_r"`` (reweighted DP-SGD(R): a
    per-example norm pass through the ``DPContext`` side-channel, then
    backprop of the clip-reweighted loss) or ``"dpsgd_r1f"`` (DP-SGD(R)
    with one forward and two pullbacks through its graph).

    ``microbatch``: ``dpsgd``'s examples per chunk of per-example
    gradients (0 = the whole batch); it must divide the batch.

    ``norm_strategy``: per-site norm rule, resolved against each site's
    registered rules (``core/sites.py``): ``"materialize"``, ``"gram"``,
    ``"fused"`` (the activation gradient and the norm² in one backward
    sweep: the DiVa dataflow) or ``"auto"`` (cheapest by each site's FLOP
    formulas; never ``"fused"``).

    ``use_kernels``: take each site's kernel route (``pegrad_norm`` for
    ``materialize``, ``gram_norm`` for ``gram`` and the embedding,
    ``dense_bwd_norm`` and the flash backward for ``fused``) instead of the
    plain PyTorch rules.  On a CPU tensor every kernel wrapper runs its
    plain version.

    ``sampling``: ``"fixed"`` or ``"poisson"`` (each example enters a step
    with probability q = B/N; the batch is padded to a fixed capacity and
    masked).

    ``augmult``: K augmented views of each example (rows B·K, b-major /
    k-minor); the per-example gradient is the mean over its views, clipped
    once, so the example stays the privacy unit and the accounting is
    unchanged.  K = 1 is the single-view dataflow bit for bit.

    ``adaptive_clip``: quantile-adaptive clip norm (core/adaptive_clip.py):
    each step a noisy count (std ``clip_count_noise``) of the examples with
    norm <= C moves C geometrically (rate ``clip_lr``) toward the
    ``clip_quantile`` quantile; the count is a second mechanism the
    accountant composes.  ``clip_norm`` is then the initial C.
    """
    enabled: bool = True
    algo: str = "dpsgd_r"          # sgd | dpsgd | dpsgd_r | dpsgd_r1f
    clip_norm: float = 1.0         # C (the initial C under adaptive_clip)
    noise_multiplier: float = 1.0  # sigma
    delta: float = 1e-5
    sampling: str = "fixed"        # fixed | poisson
    norm_strategy: str = "auto"    # auto | materialize | gram | fused
    use_kernels: bool = False      # route norm rules through the kernels
    microbatch: int = 0            # dpsgd: examples per chunk (0 = batch)
    augmult: int = 1               # K augmented views per example
    adaptive_clip: bool = False    # quantile-adaptive C
    clip_quantile: float = 0.5     # target quantile of unclipped norms
    clip_lr: float = 0.2           # geometric update rate of C
    clip_count_noise: float = 10.0  # std of the noisy below-C count


@dataclass(frozen=True)
class OptimConfig:
    name: str = "adamw"            # sgd | adamw | adam8bit
    lr: float = 1e-3
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "warmup_cosine"  # constant | warmup_cosine
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    block_size: int = 256          # adam8bit quantization block


@dataclass(frozen=True)
class MemConfig:
    """Memory-capacity plan (``launch/memory.py`` is the estimator), as in
    the JAX package.

    ``hbm_budget_bytes`` — per-device memory the training step's estimated
    peak must fit in (0 = unlimited, never raises: with no budget the
    trainer skips the auto-microbatch search entirely).
    ``auto_microbatch`` — let the trainer pick the largest microbatch /
    grad_accum split whose estimated peak fits the budget, respecting the
    Poisson capacity's lcm rounding (grad_accum x microbatch x batch-axis
    width).  Raises at build time if even the smallest split exceeds the
    (non-zero) budget.
    ``compiled_check`` — have the launcher measure the steps' peak on the
    card (``torch.cuda.max_memory_allocated``) and log it beside the
    estimate; the JAX package compiles the step for XLA's figure instead.
    """
    hbm_budget_bytes: int = 0      # 0 = unlimited
    auto_microbatch: bool = False
    compiled_check: bool = True


@dataclass(frozen=True)
class TuneConfig:
    """The launch autotuner (launch/autotune.py ``solve``), as in the JAX
    package: it searches the launch-plan space (grad_accum x microbatch x
    remat x norm strategy x kernels x mesh shape x grad compression x
    pipeline stages) for the fastest *feasible* plan: step seconds from the
    ``sim/dataflow`` cycle model over the traced step's GEMMs, subject to
    the ``launch/memory`` peak estimate fitting ``MemConfig.hbm_budget_bytes``
    and the divisibility rules.  The top-``topk`` predicted plans and the
    hand-picked default are then measured, and the fastest measured plan
    whose measured peak does not exceed the default's (or the budget) wins.

    Determinism: the GA draws every random number from one
    ``random.Random(seed)``, candidate orderings are sorted and the
    estimators are pure functions of the plan, so one seed on one config
    gives one winning plan.  ``method``: ``"auto"`` enumerates up to
    ``exhaustive_limit`` candidates and takes the GA above it; ``"ga"``,
    ``"beam"`` or ``"exhaustive"`` force a backend.  ``include_kernels``
    admits ``use_kernels=True`` plans (the CUDA kernel routes on the card;
    on the CPU their plain versions)."""
    seed: int = 0
    method: str = "auto"           # auto | ga | beam | exhaustive
    population: int = 32           # GA population size
    generations: int = 12          # GA generations
    beam_width: int = 8            # beam-search width
    exhaustive_limit: int = 128    # auto: enumerate spaces up to this size
    topk: int = 4                  # plans to measure
    measure_iters: int = 5         # best-of-N timing per measured plan
    include_kernels: bool = False  # admit kernel-route plans


@dataclass(frozen=True)
class TrainConfig:
    """Top-level training configuration.  ``seed`` keys the data stream,
    init and the DP noise.  ``remat`` is the model's activation
    checkpointing policy (``REMAT_POLICIES``), ``"block"`` by default as in
    the JAX package.  Checkpoints go to ``ckpt_dir`` every ``ckpt_every``
    steps and at the last (``ckpt_keep`` kept, written on a thread under
    ``ckpt_async``); a step slower than ``watchdog_factor`` times the
    median is logged.  ``mem`` is the memory plan (``MemConfig``).

    Distribution, as in the JAX package: ``pp_stages`` contiguous pipeline
    stages of the repeated blocks, ``pp_microbatches`` microbatches a call
    (0: one a stage; models/transformer.py); ``compress_pod_grads`` sends
    the noised gradient through the int8 error-feedback codec
    (dist/compress.py), its residual riding in the optimizer state;
    ``zero1`` shards the param-shaped optimizer state over the ``data``
    axis; ``mesh`` is the device mesh the launcher builds.  ``tune`` keys
    the launch autotuner (``TuneConfig``; ``tune.seed`` its GA)."""
    arch: str = "phi3-mini-3.8b"
    shape: str = "train_4k"
    seed: int = 0
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_keep: int = 3
    ckpt_async: bool = True
    remat: str = "block"           # none | block | sites (REMAT_POLICIES)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    grad_accum: int = 1
    pp_stages: int = 1
    pp_microbatches: int = 0
    compress_pod_grads: bool = False  # int8 + error feedback after noise
    zero1: bool = True             # shard opt state over the data axis
    dp: DPConfig = field(default_factory=DPConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    mem: MemConfig = field(default_factory=MemConfig)
    tune: TuneConfig = field(default_factory=TuneConfig)
    data_source: str = "synthetic"  # synthetic | memmap:<path>
    watchdog_factor: float = 3.0    # straggler logging threshold

    def __post_init__(self):
        validate_remat(self.remat)
        if self.pp_stages < 1:
            raise ValueError(f"pp_stages must be >= 1, got {self.pp_stages}")
        if self.pp_microbatches < 0:
            raise ValueError(
                f"pp_microbatches must be >= 0 (0 = one per stage), got "
                f"{self.pp_microbatches}")


# ---------------------------------------------------------------------------
# --set a.b=c overrides
# ---------------------------------------------------------------------------

def _coerce(old: Any, s: str) -> Any:
    if isinstance(old, bool):
        return s.lower() in ("1", "true", "yes")
    if isinstance(old, int):
        return int(s)
    if isinstance(old, float):
        return float(s)
    if isinstance(old, tuple):
        parts = [p for p in s.strip("()").split(",") if p]
        elt = old[0] if old else ""
        return tuple(_coerce(elt, p.strip()) for p in parts)
    return s


def _coerce_to_type(tp: Any, s: str, key: str) -> Any:
    """Coerce ``s`` via a declared field type (for fields now ``None``)."""
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        if s.lower() in ("none", "null"):
            return None
        for arg in typing.get_args(tp):
            if arg is not type(None):
                return _coerce_to_type(arg, s, key)
    if origin is tuple:
        args = typing.get_args(tp)
        elt = args[0] if args else str
        parts = [p for p in s.strip("()").split(",") if p]
        return tuple(_coerce_to_type(elt, p.strip(), key) for p in parts)
    if tp is bool:
        return s.lower() in ("1", "true", "yes")
    if tp in (int, float, str):
        return tp(s)
    raise ValueError(f"cannot coerce override {key}={s!r}: declared type "
                     f"{tp!r} is not bool/int/float/str/tuple/Optional")


def _field_type(cfg: Any, name: str) -> Any:
    try:
        return typing.get_type_hints(type(cfg))[name]
    except (NameError, TypeError, KeyError):
        return None


def _is_optional(tp: Any) -> bool:
    return (typing.get_origin(tp) is typing.Union
            and type(None) in typing.get_args(tp))


def apply_overrides(cfg: Any, overrides: Dict[str, str]) -> Any:
    """Apply {'dp.clip_norm': '0.5', 'optim.lr': '3e-4'} style overrides to
    a (possibly nested) frozen dataclass."""
    for key, val in overrides.items():
        feature = NOT_PORTED.get(key) or NOT_PORTED.get(key.split(".")[0])
        if feature:
            raise NotImplementedError(
                f"--set {key}: {feature} is not ported yet (ROADMAP queue 1)")
        cfg = _apply_one(cfg, key.split("."), val, key)
    return cfg


def _apply_one(cfg: Any, parts, val: str, key: str) -> Any:
    name = parts[0]
    if not dataclasses.is_dataclass(cfg) or not hasattr(cfg, name):
        raise KeyError(f"unknown config key {key} on {type(cfg).__name__}")
    cur = getattr(cfg, name)
    if len(parts) == 1:
        tp = _field_type(cfg, name)
        if val.lower() in ("none", "null") and _is_optional(tp):
            return replace(cfg, **{name: None})
        if cur is None:
            if tp is None:
                raise ValueError(f"cannot coerce override {key}={val!r}: the "
                                 f"field's declared type is unresolvable")
            return replace(cfg, **{name: _coerce_to_type(tp, val, key)})
        return replace(cfg, **{name: _coerce(cur, val)})
    return replace(cfg, **{name: _apply_one(cur, parts[1:], val, key)})


def parse_set_args(pairs) -> Dict[str, str]:
    out = {}
    for p in pairs or []:
        k, sep, v = p.partition("=")
        if not sep or not k:
            raise ValueError(f"--set expects key=value, got {p!r}")
        out[k] = v
    return out
