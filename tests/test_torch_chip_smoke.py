"""The yardsticks ``chip_smoke.py`` holds the kernels' card times against,
pinned on the CPU: the least time the card could take for the training
step's dense calls and for the serving path's first prefill wave (H100 SXM
peaks: 989 TFLOP/s bf16, 3.35 TB/s).  A change to the work counted, to the
mix of calls or to the traffic moves these numbers and every share of
bound reported beside them.  Also pinned: the parser that reads
``-Xptxas -v`` for the no-spill check on the main-path tensor-core
kernels."""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.configs import get_arch
from repro_torch.kernels import launch_counters

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_training_mix_is_phi3_at_sixteen_layers(smoke):
    mix = smoke.dense_mix(get_arch("phi3-mini-3.8b"), smoke.TRAIN_LAYERS)
    assert mix == [("qkvo", 3072, 3072, 64), ("w1w3", 3072, 8192, 32),
                   ("w2", 8192, 3072, 16), ("head", 3072, 32256, 1)]


def test_dgrad_bound_over_the_training_mix(smoke):
    mix = smoke.dense_mix(get_arch("phi3-mini-3.8b"), smoke.TRAIN_LAYERS)
    parts = [smoke.dgrad_bound_ms(smoke.TRAIN_B, smoke.TRAIN_T, di, do, 1, "bfloat16")
             for _, di, do, _ in mix]
    assert {by for _, by in parts} == {"operations"}
    total = sum(n * ms for (_, _, _, n), (ms, _) in zip(mix, parts))
    assert total == pytest.approx(15.8293, abs=1e-4)
    # one (3072, 3072) call: 77.3 GFLOP at 989 TFLOP/s
    assert parts[0][0] == pytest.approx(0.078169, abs=1e-6)


def test_norm_bound_over_the_training_mix(smoke):
    """The norm launch (pegrad_norm, dense_bwd_norm's norm half) does the
    gx launch's FLOPs on x and gy: bound by operations at every training
    shape, 15.83 ms over one step's 113 calls."""
    mix = smoke.dense_mix(get_arch("phi3-mini-3.8b"), smoke.TRAIN_LAYERS)
    parts = [smoke.norm_bound_ms(smoke.TRAIN_B, smoke.TRAIN_T, di, do, "bfloat16")
             for _, di, do, _ in mix]
    assert {by for _, by in parts} == {"operations"}
    total = sum(n * ms for (_, _, _, n), (ms, _) in zip(mix, parts))
    assert total == pytest.approx(15.8293, abs=1e-4)
    # the auto route's q, k, v, o: (2, 2048, 3072, 3072), 77.3 GFLOP
    ms, by = smoke.norm_bound_ms(smoke.AUTO_B, smoke.AUTO_T, 3072, 3072, "bfloat16")
    assert by == "operations" and ms == pytest.approx(0.078169, abs=1e-6)
    # in float32 the same call is bound by operations at 67 TFLOP/s
    ms, by = smoke.norm_bound_ms(smoke.TRAIN_B, smoke.TRAIN_T, 3072, 3072, "float32")
    assert by == "operations" and ms == pytest.approx(1.153872, abs=1e-6)


def test_ptxas_report_names_the_norm_kernel(smoke):
    """The bf16 norm kernel is a main-path tensor-core kernel of both
    pegrad_norm and dense_bwd_norm; the f32 CUDA-core kernel is
    neither."""
    log = """ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__c68f755b_14_pegrad_norm_cu_fd4a27362tc11norm_kernelE14CUtensorMap_stS1_PK13__nv_bfloat16S4_Pfiiiiixi' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__c68f755b_14_pegrad_norm_cu_fd4a27362tc11norm_kernelE14CUtensorMap_stS1_PK13__nv_bfloat16S4_Pfiiiiixi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 154 registers, used 2 barriers, 128 bytes smem
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__c68f755b_14_pegrad_norm_cu_fd4a273611norm_kernelEPKfS1_Pfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__c68f755b_14_pegrad_norm_cu_fd4a273611norm_kernelEPKfS1_Pfiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 113 registers, used 1 barriers, 8480 bytes smem
"""
    got = smoke.ptxas_report(log)
    assert [(r["registers"], r["spill_stores"]) for r in got] == [(154, 0), (113, 0)]
    assert "tc11norm_kernel" in smoke.MAIN_PATH_KERNELS
    for src in ("pegrad_norm", "dense_bwd_norm"):
        pieces = smoke.TENSOR_CORE_KERNELS[src]
        assert [any(p in r["function"] for p in pieces) for r in got] == [True, False]
    main = [any(p in r["function"] for p in smoke.MAIN_PATH_KERNELS) for r in got]
    assert main == [True, False]


def test_flash_bound_at_the_serving_wave(smoke):
    arch = get_arch("phi3-mini-3.8b")
    wave_t = smoke.first_wave_t(smoke.request_stream(arch.vocab))
    assert wave_t == 896
    ms, by = smoke.flash_bound_ms(8 * arch.n_heads, wave_t, wave_t, arch.hd, 1, True,
                                  "bfloat16")
    assert by == "bytes" and ms == pytest.approx(0.052859, abs=1e-6)
    # the training forward: (8 x 32 heads, T 512, hd 96), causal
    ms, by = smoke.flash_bound_ms(8 * arch.n_heads, 512, 512, arch.hd, 1, True,
                                  "bfloat16")
    assert by == "bytes" and ms == pytest.approx(0.030205, abs=1e-6)


def test_ptxas_report_reads_registers_and_spills(smoke):
    """The no-spill check on the main-path tensor-core kernels reads
    ``-Xptxas -v`` output through this parser: a spill must show."""
    log = """ptxas info    : Compiling entry function '_ZN2tc12dgrad_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc12dgrad_kernelEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 154 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN3mma16flash_fwd_kernelILi96EEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN3mma16flash_fwd_kernelILi96EEvv
    8 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""
    got = smoke.ptxas_report(log)
    assert [(r["registers"], r["spill_stores"], r["spill_loads"]) for r in got] == \
        [(154, 0, 0), (255, 16, 12)]
    assert all(any(p in r["function"] for p in smoke.MAIN_PATH_KERNELS) for r in got)


def test_flash_bwd_bounds_at_the_training_and_auto_shapes(smoke):
    """The backward's five products (32.2 GFLOP at the training shape) are
    bound by bytes at T 512 and by operations at the auto route's T 2048."""
    arch = get_arch("phi3-mini-3.8b")
    BH = smoke.TRAIN_B * arch.n_heads
    assert smoke.flash_bwd_flops(BH, 512, arch.hd, True) == pytest.approx(3.2212e10, rel=1e-4)
    ms, by = smoke.flash_bwd_bound_ms(BH, BH, smoke.TRAIN_T, arch.hd, True, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(0.082791, abs=1e-6)
    BH = smoke.AUTO_B * arch.n_heads
    ms, by = smoke.flash_bwd_bound_ms(BH, BH, smoke.AUTO_T, arch.hd, True, "bfloat16")
    assert by == "operations" and ms == pytest.approx(0.130282, abs=1e-6)
    # a causal launch does half the products of a full one
    assert smoke.flash_bwd_flops(BH, 2048, 96, False) == 2 * smoke.flash_bwd_flops(
        BH, 2048, 96, True)


@pytest.mark.parametrize("shape,want", [
    (("embed", 8, 512, 3072, 3072, True, False), (0.007522, "bytes")),
    (("auto-w1w3", 2, 2048, 3072, 8192, False, True), (0.095587, "operations")),
    (("auto-w2", 2, 2048, 8192, 3072, False, True), (0.095587, "operations")),
    (("auto-head", 2, 2048, 3072, 32256, False, True), (0.299795, "operations"))])
def test_gram_bounds_at_the_training_and_auto_shapes(smoke, shape, want):
    _, BG, T, di, do, masked, square = shape
    ms, by = smoke.gram_bound_ms(BG, T, di, do, masked, square, "bfloat16")
    assert by == want[1] and ms == pytest.approx(want[0], abs=1e-6)


def test_gram_flops_count_the_s_le_t_pairs(smoke):
    # the embedding rule: one Gram of gy over T (T + 1) / 2 pairs, 2 FLOPs each
    assert smoke.gram_flops(8, 512, 3072, 3072, False) == 8 * 512 * 513 * 3072
    assert smoke.gram_flops(2, 2048, 3072, 8192, True) == 2 * 2048 * 2049 * (3072 + 8192)


def test_ptxas_report_names_the_backward_and_gram_kernels(smoke):
    """The bf16 attention backward's two launches at hd 96 (phi3) and hd
    128 (chatglm3, phase 10) and the bf16 Gram kernel are main-path
    kernels; their f32 siblings are not."""
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_13mma13bwd_kv_kernelILi96EEEvPK13__nv_bfloat16S4_S4_S4_PKfS6_PfS7_iiiiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_13mma13bwd_kv_kernelILi96EEEvPK13__nv_bfloat16S4_S4_S4_PKfS6_PfS7_iiiiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 232 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_13mma12bwd_q_kernelILi128EEEvPK13__nv_bfloat16S4_S4_S4_PKfS6_Pfiiiiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_13mma12bwd_q_kernelILi128EEEvPK13__nv_bfloat16S4_S4_S4_PKfS6_Pfiiiiiifi
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_13mma11gram_kernelEPK13__nv_bfloat16S3_PKiPfiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_13mma11gram_kernelEPK13__nv_bfloat16S3_PKiPfiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113bwd_kv_kernelIfLi96EEEvPKT_S3_S3_S3_PKfS5_PfS6_iiiiiif' for 'sm_90a'
ptxas info    : Used 120 registers, used 1 barriers
"""
    got = smoke.ptxas_report(log)
    assert [(r["registers"], r["spill_stores"]) for r in got] == \
        [(232, 0), (255, 4), (128, 0), (120, None)]
    main = [any(p in r["function"] for p in smoke.MAIN_PATH_KERNELS) for r in got]
    assert main == [True, True, True, False]
    tc = [any(p in r["function"] for pieces in smoke.TENSOR_CORE_KERNELS.values()
              for p in pieces) for r in got]
    assert tc == [True, True, True, False]


@pytest.mark.parametrize("algo,route,remat,microbatch", [
    ("sgd", "fused", "none", 0), ("sgd", "fused", "block", 0),
    ("dpsgd_r", "fused", "none", 0), ("dpsgd_r", "fused", "block", 0),
    ("dpsgd_r", "fused", "sites", 0), ("dpsgd_r", "materialize", "block", 0),
    ("dpsgd_r1f", "fused", "none", 0), ("dpsgd_r1f", "fused", "sites", 0),
    ("dpsgd_r1f", "materialize", "block", 0),
    ("dpsgd", "fused", "none", 1), ("dpsgd", "fused", "block", 2),
    ("dpsgd", "fused", "sites", 0)])
def test_path_launches_count_the_wrapper_calls(smoke, monkeypatch, algo, route,
                                               remat, microbatch):
    """``path_launches``, which the card's run holds every path's launch
    counts to, against the calls one Trainer step of the reduced phi3
    makes to each kernel wrapper on the CPU (where a wrapper takes its
    plain version and counts nothing, so each is wrapped here to count
    its calls): every algorithm, under each remat policy."""
    import torch
    from repro_torch.configs import reduced
    from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    for name, (mod, attr) in launch_counters().items():
        def counting(*args, _fn=getattr(mod, name), _mod=mod, _attr=attr,
                     **kwargs):
            setattr(_mod, _attr, getattr(_mod, _attr) + 1)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counting)
        monkeypatch.setattr(mod, attr, 0)
    arch = reduced(get_arch("phi3-mini-3.8b"))
    model = Model(arch, dtype=torch.float32, device="cpu", remat=remat)
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                      remat=remat, optim=OptimConfig(schedule="constant"),
                      dp=DPConfig(algo=algo, norm_strategy=route,
                                  use_kernels=True, microbatch=microbatch))
    trainer = Trainer(model, cfg, ShapeConfig("t", 8, 4, "train"))
    state = trainer.init_state()
    smoke.zero_counts()
    trainer.train_step(state, trainer.make_batch(0))
    assert smoke.read_counts() == smoke.path_launches(
        route, arch.n_layers, algo=algo, remat=remat, examples=4,
        microbatch=microbatch, dtype_groups=smoke.dtype_groups(model.params))


@pytest.mark.parametrize("algo", ["dpsgd_r", "dpsgd"])
def test_path_launches_count_a_split_step(smoke, monkeypatch, algo):
    """Phase 12's split steps: ``path_launches`` with ``chunks`` =
    grad_accum and ``dpsgd``'s examples counted a chunk, against the
    wrapper calls of one Trainer step at grad_accum 2 (the whole chunk in
    one ``dpsgd`` buffer)."""
    import torch
    from repro_torch.configs import reduced
    from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    for name, (mod, attr) in launch_counters().items():
        def counting(*args, _fn=getattr(mod, name), _mod=mod, _attr=attr,
                     **kwargs):
            setattr(_mod, _attr, getattr(_mod, _attr) + 1)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counting)
        monkeypatch.setattr(mod, attr, 0)
    arch = reduced(get_arch("phi3-mini-3.8b"))
    model = Model(arch, dtype=torch.float32, device="cpu", remat="none")
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                      remat="none", grad_accum=2,
                      optim=OptimConfig(schedule="constant"),
                      dp=DPConfig(algo=algo, norm_strategy="fused",
                                  use_kernels=True, microbatch=0))
    trainer = Trainer(model, cfg, ShapeConfig("t", 8, 4, "train"))
    state = trainer.init_state()
    smoke.zero_counts()
    trainer.train_step(state, trainer.make_batch(0))
    assert smoke.read_counts() == smoke.path_launches(
        "fused", arch.n_layers, chunks=2, algo=algo, remat="none", examples=2,
        dtype_groups=smoke.dtype_groups(model.params))


@pytest.mark.parametrize("algo,route,remat,microbatch", [
    ("dpsgd_r", "fused", "block", 0), ("dpsgd_r", "materialize", "none", 0),
    ("dpsgd_r", "gram", "sites", 0), ("dpsgd_r", "auto", "block", 0),
    ("dpsgd_r1f", "fused", "sites", 0), ("dpsgd", "fused", "none", 2),
    ("sgd", "fused", "block", 0)])
def test_path_launches_count_the_moe_wrapper_calls(smoke, monkeypatch, algo, route,
                                                   remat, microbatch):
    """Phase 13's path: ``path_launches`` of the MoE decoder (1 dense + 2
    MoE layers of the reduced deepseek-moe-16b: 7 + 2 x 11 + 1 = 30 norm
    sites, the experts' ``moe_dense`` among them) against the wrapper
    calls of one Trainer step on the CPU, every route and algorithm; at
    the card's B 8 x T 512, 6 layers make 63 sites, ``auto`` sending the
    5 routers to ``pegrad_norm`` and the other 58 to ``gram_norm``."""
    import dataclasses
    import torch
    from repro_torch.configs import reduced
    from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    for name, (mod, attr) in launch_counters().items():
        def counting(*args, _fn=getattr(mod, name), _mod=mod, _attr=attr,
                     **kwargs):
            setattr(_mod, _attr, getattr(_mod, _attr) + 1)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counting)
        monkeypatch.setattr(mod, attr, 0)
    arch = dataclasses.replace(reduced(get_arch("deepseek-moe-16b")), n_layers=3)
    model = Model(arch, dtype=torch.float32, device="cpu", remat=remat)
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                      remat=remat, optim=OptimConfig(schedule="constant"),
                      dp=DPConfig(algo=algo, norm_strategy=route,
                                  use_kernels=True, microbatch=microbatch))
    trainer = Trainer(model, cfg, ShapeConfig("t", 8, 4, "train"))
    state = trainer.init_state()
    smoke.zero_counts()
    trainer.train_step(state, trainer.make_batch(0))
    shape = smoke.launch_shape(arch, 4, 8)
    assert shape["sites"] == 30
    assert smoke.read_counts() == smoke.path_launches(
        route, algo=algo, remat=remat, examples=4, microbatch=microbatch,
        dtype_groups=smoke.dtype_groups(model.params), **shape)
    full = dataclasses.replace(get_arch("deepseek-moe-16b"), n_layers=6)
    assert smoke.launch_shape(full) == dict(L=6, family="moe", sites=63,
                                            auto_norms=(5, 58))


def test_agreeing_prefix(smoke):
    assert smoke.agreeing_prefix([1, 2, 3], [1, 2, 3]) == 3
    assert smoke.agreeing_prefix([1, 2, 3], [1, 5, 3]) == 1
    assert smoke.agreeing_prefix([4], [5]) == 0
    assert smoke.agreeing_prefix([1, 2], [1, 2, 3]) == 2


def test_chatglm3_mix_bounds_and_launches(smoke):
    """Phase 10's path: chatglm3-6b at 28 layers, B 8 x T 512.  Its dense
    calls split q and o (4096 -> 4096) from k and v (4096 -> 256, GQA on 2
    kv heads of hd 128), the only ones bound by bytes; one step launches
    dense_bwd_norm 28 x 7 + 1 = 197 times and the flash pair 140 and 56
    times under remat="block"."""
    arch = get_arch("chatglm3-6b")
    mix = smoke.dense_mix(arch, arch.n_layers)
    assert mix == [("qo", 4096, 4096, 56), ("kv", 4096, 256, 56),
                   ("w1w3", 4096, 13696, 56), ("w2", 13696, 4096, 28),
                   ("head", 4096, 65024, 1)]
    parts = [smoke.norm_bound_ms(smoke.TRAIN_B, smoke.TRAIN_T, di, do, "bfloat16")
             for _, di, do, _ in mix]
    assert [by for _, by in parts] == ["operations", "bytes", "operations",
                                       "operations", "operations"]
    total = sum(n * ms for (_, _, _, n), (ms, _) in zip(mix, parts))
    assert total == pytest.approx(49.6168, abs=1e-4)
    ms, by = smoke.flash_bwd_bound_ms(smoke.TRAIN_B * 32, smoke.TRAIN_B * 2,
                                      smoke.TRAIN_T, 128, True, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(0.053994, abs=1e-6)
    assert smoke.flash_bwd_flops(256, 512, 128, True) == 42949672960.0
    ms, by = smoke.flash_bound_ms(256, 512, 512, 128, 16, True, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(0.021441, abs=1e-6)
    ms, by = smoke.gram_bound_ms(8, 512, 4096, 4096, True, False, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(0.010026, abs=1e-6)
    want = dict.fromkeys(smoke.read_counts(), 0)
    want.update(flash_attn_fwd=140, flash_attn_bwd=56, dense_bwd_norm=197,
                gram_norm=1)
    assert smoke.path_launches("fused", arch.n_layers, remat="block") == want


def test_path_launches_count_chatglm3s_wrapper_calls(smoke, monkeypatch, tmp_path):
    """``path_launches`` against the wrapper calls of one Trainer step of
    the reduced chatglm3 (GQA, rotary on half the head) under phase 10's
    route, remat and optimizer, from a memmap corpus."""
    import numpy as np
    import torch
    from repro_torch.configs import reduced
    from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    for name, (mod, attr) in launch_counters().items():
        def counting(*args, _fn=getattr(mod, name), _mod=mod, _attr=attr,
                     **kwargs):
            setattr(_mod, _attr, getattr(_mod, _attr) + 1)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counting)
        monkeypatch.setattr(mod, attr, 0)
    corpus = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 256, 4096, dtype=np.int32).tofile(corpus)
    arch = reduced(get_arch("chatglm3-6b"))
    model = Model(arch, dtype=torch.float32, device="cpu", remat="block")
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                      remat="block", ckpt_dir=str(tmp_path / "ckpt"),
                      data_source=f"memmap:{corpus}",
                      optim=OptimConfig(name="adam8bit", schedule="constant"),
                      dp=DPConfig(norm_strategy="fused", use_kernels=True))
    trainer = Trainer(model, cfg, ShapeConfig("t", 8, 4, "train"))
    state = trainer.init_state()
    smoke.zero_counts()
    trainer.train_step(state, trainer.make_batch(0))
    assert smoke.read_counts() == smoke.path_launches("fused", arch.n_layers,
                                                      remat="block")


@pytest.mark.parametrize("name,algo,route,remat,k", [
    ("cnn-cifar10", "dpsgd_r", "fused", "block", 2),
    ("cnn-cifar10", "dpsgd_r", "materialize", "none", 1),
    ("cnn-cifar10", "dpsgd_r", "gram", "block", 2),
    ("cnn-cifar10", "dpsgd_r1f", "fused", "sites", 2),
    ("cnn-cifar10", "dpsgd", "fused", "block", 2),
    ("cnn-cifar10", "sgd", "fused", "block", 1),
    ("vit-cifar10", "dpsgd_r", "fused", "block", 2),
    ("vit-cifar10", "dpsgd_r", "materialize", "none", 2),
    ("vit-cifar10", "dpsgd_r", "gram", "sites", 1),
    ("vit-cifar10", "dpsgd_r1f", "fused", "block", 2),
    ("vit-cifar10", "dpsgd", "fused", "none", 2),
    ("vit-cifar10", "sgd", "fused", "block", 1)])
def test_path_launches_count_the_image_wrapper_calls(smoke, monkeypatch, tmp_path,
                                                     name, algo, route, remat, k):
    """``path_launches`` of the image families (phase 11) against the
    wrapper calls of one Trainer step of the reduced CNN and ViT on the
    CPU, K views an example, adaptive clipping on: every algorithm and
    norm route, each remat policy.  The images' first site (the stem, the
    patch embedding) takes no ``dense_dgrad``: its input needs no
    gradient."""
    import torch
    from repro_torch.configs import reduced
    from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.models import build_model_for
    from repro_torch.train import Trainer
    for kname, (mod, attr) in launch_counters().items():
        def counting(*args, _fn=getattr(mod, kname), _mod=mod, _attr=attr,
                     **kwargs):
            setattr(_mod, _attr, getattr(_mod, _attr) + 1)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, kname, counting)
        monkeypatch.setattr(mod, attr, 0)
    arch = reduced(get_arch(name))
    model = build_model_for(arch, dtype=torch.float32, device="cpu", remat=remat)
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                      remat=remat, ckpt_dir=str(tmp_path),
                      optim=OptimConfig(schedule="constant"),
                      dp=DPConfig(algo=algo, norm_strategy=route, use_kernels=True,
                                  augmult=k, adaptive_clip=True))
    trainer = Trainer(model, cfg, ShapeConfig("t", 1, 3, "train"))
    state = trainer.init_state()
    smoke.zero_counts()
    metrics = trainer.train_step(state, trainer.make_batch(0))
    assert smoke.read_counts() == smoke.path_launches(
        route, algo=algo, remat=remat, examples=3,
        dtype_groups=smoke.dtype_groups(model.params), **smoke.launch_shape(arch))
    assert ("clip_norm_next" in metrics) == (algo != "sgd")


def test_image_mixes_and_their_bounds(smoke):
    """Phase 11's norm sites as dense problems (256 examples, K 16 views
    folded into T): the CNN's 21 conv2d sites and head, the ViT's patch
    embedding, 8 x 6 dense sites and head.  ``dense_bwd_norm``'s bound (x
    read, gy read, w read, gx written): every CNN call and all but the
    ViT's w1 (256 -> 1024, by operations) bound by bytes; 7.96 ms over
    the CNN's step, 9.01 ms over the ViT's."""
    cnn = smoke.image_mix(get_arch("cnn-cifar10"))
    assert cnn == [("stem", 16384, 27, 16, 1), ("s0-conv", 16384, 144, 16, 6),
                   ("s1-w1s2", 4096, 144, 32, 1), ("s1-conv", 4096, 288, 32, 5),
                   ("s1-proj", 4096, 16, 32, 1), ("s2-w1s2", 1024, 288, 64, 1),
                   ("s2-conv", 1024, 576, 64, 5), ("s2-proj", 1024, 32, 64, 1),
                   ("head", 16, 64, 10, 1)]
    vit = smoke.image_mix(get_arch("vit-cifar10"))
    assert vit == [("patch", 1024, 48, 256, 1), ("qkvo", 1024, 256, 256, 32),
                   ("w1", 1024, 256, 1024, 8), ("w2", 1024, 1024, 256, 8),
                   ("head", 16, 256, 10, 1)]
    assert sum(n for *_, n in cnn) == smoke.launch_shape(get_arch("cnn-cifar10"))[
        "convs"] + 1
    for mix, want in ((cnn, 7.9584), (vit, 9.0133)):
        total = 0.0
        for nm, T, di, do, n in mix:
            ms, by = smoke.bound_ms(4.0 * smoke.IMAGE_B * T * di * do,
                                    2 * smoke.IMAGE_B * T * (2 * di + do)
                                    + 2 * di * do + 4 * smoke.IMAGE_B, "bfloat16")
            assert by == ("operations" if (nm, mix) == ("w1", vit) else "bytes")
            total += n * ms
        assert total == pytest.approx(want, abs=1e-4)
    assert smoke.largest_leaf(get_arch("cnn-cifar10"))[1] == 3 * 3 * 64 * 64
    assert smoke.largest_leaf(get_arch("vit-cifar10"))[1] == 256 * 1024


def test_flat_widths_and_dpsgd_clip_launches(smoke):
    """``dpsgd``'s flat buffers (``clipping.flat_stacks``): the image models'
    parameters of each dtype end to end, padded to 16-byte rows, in the
    order of each dtype's first leaf: the bf16 weights (CNN 270,896, ViT
    6,306,304) and the float32 norm scales and biases (1,386 -> 1,392 and
    21,002 -> 21,008) of 272,282 and 6,327,306 parameters; one ``clip_reduce`` per parameter dtype per microbatch: 2
    dtypes x 4 microbatches of 2 examples = 8."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    assert smoke.flat_groups(get_arch("cnn-cifar10")) == (
        [(f32, 1386, 1392), (bf16, 270896, 270896)], 272282)
    assert smoke.flat_groups(get_arch("vit-cifar10")) == (
        [(bf16, 6306304, 6306304), (f32, 21002, 21008)], 6327306)
    n = smoke.path_launches("fused", 2, algo="dpsgd", examples=8, microbatch=2,
                            dtype_groups=2)
    assert n["clip_reduce"] == 8 and n["flash_attn_bwd"] == 16
    assert smoke.clip_bound_ms(256, 270896, 2) == smoke.bound_ms(
        2.0 * 256 * 270896, 2 * 256 * 270896 + 4 * 256 + 4 * 270896, "bfloat16")
    ms, by = smoke.clip_bound_ms(256, 270896, 2)
    assert by == "bytes" and ms == pytest.approx(0.041727, abs=1e-6)


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "cnn-cifar10", "vit-cifar10"])
def test_meta_leaves_match_the_built_model(smoke, name):
    """``flat_groups`` sizes a model's flat buffers from meta tensors (no
    memory, so phi3-mini at 16 layers costs nothing): at the reduced size
    they have the built bf16 model's leaves, shapes and types in its order,
    and the same flat buffers."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import reduced
    from repro_torch.core import clipping
    from repro_torch.models import build_model_for
    arch = reduced(get_arch(name))
    real = tree.leaves(build_model_for(arch, dtype=torch.bfloat16, device="cpu",
                                       seed=0).params)
    meta = smoke._meta_leaves(arch)
    assert [(p.shape, p.dtype) for p in meta] == [(p.shape, p.dtype) for p in real]
    bufs, *_ = clipping.flat_stacks(real, 1)
    groups, n_all = smoke.flat_groups(arch)
    assert [(b.dtype, b.shape[1]) for b in bufs] == [(dt, n) for dt, _, n in groups]
    assert n_all == sum(p.numel() for p in real)


def test_phase9_flat_widths(smoke):
    """Phase 9's ``dpsgd`` launches on phi3-mini at 16 layers: the bf16
    weights end to end (2,010,120,192 columns, just under 2^31: 32 GB at B
    8, so its check keeps one copy of g) and the float32 norm scales
    (101,376)."""
    import dataclasses
    import torch
    arch = dataclasses.replace(get_arch("phi3-mini-3.8b"), n_layers=smoke.TRAIN_LAYERS)
    groups, n_all = smoke.flat_groups(arch)
    assert groups == [(torch.bfloat16, 2010120192, 2010120192),
                      (torch.float32, 101376, 101376)]
    assert n_all == 2010221568 < 2**31
    assert smoke.TRAIN_B * 2010120192 * 2 > smoke.WIDE_BYTES > 2010120192 * 2


@pytest.mark.parametrize("spans, floor, want", [
    ([("k", 3000.0)] * 10, 2.9, (3.0, None)),
    ([("k", 3000.0)] * 10 + [("mm", 10.0), ("mm", 30.0)] * 10, 0.0, (3.04, None)),
    ([("k", 3000.0)] * 9 + [("mm", 20.0)] * 20, 2.9, (3.04, None)),
    ([("k", 1500.0)] * 10, 2.9, (None, "1.5000 ms < the bound's 2.9000 ms")),
    ([], 0.0, (None, "no kernel")),
])
def test_profile_ms_keeps_only_profiles_at_or_above_the_bound(smoke, spans, floor,
                                                              want):
    """A launch the profiler did not record lowers no mean; a profile whose
    time is below the least the work can take is not a device time."""
    ms, why = smoke.profile_ms(spans, 10, floor)
    assert why == want[1]
    assert ms == pytest.approx(want[0]) if want[0] is not None else ms is None


def _ssm_arch(name):
    """mamba2-reduced (2 Mamba layers), or jamba's two-layer cut at reduced
    width (attention with its dense FFN, Mamba with the MoE FFN)."""
    import dataclasses
    from repro_torch.configs import reduced
    from repro_torch.configs.base import ATTN, MAMBA
    if name == "mamba2-1.3b":
        return reduced(get_arch(name))
    return dataclasses.replace(reduced(get_arch("jamba-1.5-large-398b")), n_layers=2,
                               layer_pattern=(ATTN, MAMBA))


def _count_wrapper_calls(smoke, monkeypatch):
    """Every kernel wrapper adds one to its count per call, as its launch
    does on the card."""
    for kname, (mod, attr) in launch_counters().items():
        def counting(*args, _fn=getattr(mod, kname), _mod=mod, _attr=attr,
                     **kwargs):
            setattr(_mod, _attr, getattr(_mod, _attr) + 1)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, kname, counting)
        monkeypatch.setattr(mod, attr, 0)


@pytest.mark.parametrize("name,algo,route,remat,microbatch", [
    ("mamba2-1.3b", "dpsgd_r", "fused", "block", 0),
    ("mamba2-1.3b", "dpsgd_r", "auto", "none", 0),
    ("mamba2-1.3b", "dpsgd_r1f", "fused", "sites", 0),
    ("jamba-cut", "dpsgd_r", "fused", "block", 0),
    ("jamba-cut", "dpsgd_r", "materialize", "sites", 0),
    ("jamba-cut", "dpsgd_r", "gram", "none", 0),
    ("jamba-cut", "dpsgd_r", "auto", "block", 0),
    ("jamba-cut", "dpsgd", "fused", "block", 2)])
def test_path_launches_count_the_ssm_wrapper_calls(smoke, monkeypatch, name, algo,
                                                   route, remat, microbatch):
    """Phase 14's paths: ``path_launches`` of the SSM and hybrid decoders
    against the wrapper calls of one Trainer step on the CPU.  A Mamba
    layer's norm sites are its in and out projections, not its (K, C) conv
    weight (a tap): mamba2-reduced has 2 x 2 + 1 = 5 and no attention, the
    hybrid cut 7 + (2 + 4) + 1 = 14 (the MoE's router and three expert
    weights) and one attention.  At the card's shapes, mamba2-1.3b's 48
    layers make 97 sites, the full-width cut 14."""
    import dataclasses
    import torch
    from repro_torch.configs.base import (ATTN, MAMBA, DPConfig, OptimConfig,
                                          ShapeConfig, TrainConfig)
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    _count_wrapper_calls(smoke, monkeypatch)
    arch = _ssm_arch(name)
    model = Model(arch, dtype=torch.float32, device="cpu", remat=remat)
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                      remat=remat, optim=OptimConfig(schedule="constant"),
                      dp=DPConfig(algo=algo, norm_strategy=route,
                                  use_kernels=True, microbatch=microbatch))
    trainer = Trainer(model, cfg, ShapeConfig("t", 8, 4, "train"))
    state = trainer.init_state()
    smoke.zero_counts()
    trainer.train_step(state, trainer.make_batch(0))
    shape = smoke.launch_shape(arch, 4, 8)
    assert (shape["sites"], shape["attn"]) == ((5, 0) if name == "mamba2-1.3b"
                                               else (14, 1))
    assert smoke.read_counts() == smoke.path_launches(
        route, algo=algo, remat=remat, examples=4, microbatch=microbatch,
        dtype_groups=smoke.dtype_groups(model.params), **shape)
    full = smoke.launch_shape(get_arch("mamba2-1.3b"), smoke.TRAIN_B, 4096)
    assert (full["sites"], full["attn"]) == (97, 0)
    cut = dataclasses.replace(get_arch("jamba-1.5-large-398b"), n_layers=2,
                              layer_pattern=(ATTN, MAMBA))
    assert (smoke.launch_shape(cut)["sites"], smoke.launch_shape(cut)["attn"]) == (14, 1)


@pytest.mark.parametrize("name,route", [("mamba2-1.3b", "materialize"),
                                        ("mamba2-1.3b", "auto"),
                                        ("jamba-cut", "fused"),
                                        ("jamba-cut", "auto")])
def test_pass1_launches_count_the_norm_pass(smoke, monkeypatch, name, route):
    """Phase 14 counts pass 1 alone (``algo.norm_pass``) for mamba2's
    ``materialize`` and ``auto`` norms²: ``pass1_launches`` against the
    wrapper calls of one norm pass on the CPU, under ``remat="block"``."""
    import torch
    from repro_torch.configs.base import DPConfig
    from repro_torch.core import algo
    from repro_torch.models.transformer import Model
    _count_wrapper_calls(smoke, monkeypatch)
    arch = _ssm_arch(name)
    model = Model(arch, dtype=torch.float32, device="cpu", remat="block")
    dp = DPConfig(norm_strategy=route, use_kernels=True)
    toks = torch.randint(0, arch.vocab, (4, 8), generator=torch.Generator().manual_seed(0))
    smoke.zero_counts()
    nsq, _ = algo.norm_pass(model.loss_fn, model.params, {"tokens": toks}, dp, None)
    assert nsq.shape == (4,) and bool(torch.all(nsq > 0))
    want = smoke.pass1_launches(route, remat="block", **smoke.launch_shape(arch, 4, 8))
    assert smoke.read_counts() == want
    assert sum(want.values()) > 0


@pytest.mark.parametrize("name,algo,route,remat", [
    ("musicgen-medium", "dpsgd_r", "fused", "block"),
    ("musicgen-medium", "dpsgd_r", "auto", "none"),
    ("musicgen-medium", "dpsgd_r1f", "fused", "block"),
    ("chameleon-34b", "dpsgd_r", "fused", "sites"),
    ("chameleon-34b", "dpsgd_r", "materialize", "block"),
    ("chameleon-34b", "dpsgd_r", "gram", "none")])
def test_path_launches_count_the_embed_model_wrapper_calls(smoke, monkeypatch, name,
                                                           algo, route, remat):
    """Phase 15's paths: ``path_launches`` of the embedding-input decoders
    (no embedding site, so no embedding ``gram_norm``: the fused route
    launches none) against the wrapper calls of one Trainer step on the
    CPU.  musicgen-reduced has 2 x 6 + 1 = 13 norm sites (its gelu MLP has
    no w3), chameleon-reduced 2 x 7 + 1 = 15.  At the card's shapes
    musicgen's 48 layers at B 8 x T 1500 make 289 sites, all sent to
    ``pegrad_norm`` by ``auto``, and chameleon's 6-layer cut at B 8 x T
    512 makes 43, all sent to ``gram_norm``."""
    import dataclasses
    import torch
    from repro_torch.configs import reduced
    from repro_torch.configs.base import DPConfig, OptimConfig, ShapeConfig, TrainConfig
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    _count_wrapper_calls(smoke, monkeypatch)
    arch = reduced(get_arch(name))
    model = Model(arch, dtype=torch.float32, device="cpu", remat=remat)
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32", remat=remat,
                      optim=OptimConfig(schedule="constant"),
                      dp=DPConfig(algo=algo, norm_strategy=route, use_kernels=True))
    trainer = Trainer(model, cfg, ShapeConfig("t", 8, 4, "train"))
    state = trainer.init_state()
    smoke.zero_counts()
    trainer.train_step(state, trainer.make_batch(0))
    shape = smoke.launch_shape(arch, 4, 8)
    assert (shape["sites"], shape["attn"], shape["embeds"]) == (
        (13, 2, 0) if name == "musicgen-medium" else (15, 2, 0))
    want = smoke.path_launches(route, algo=algo, remat=remat, **shape)
    assert smoke.read_counts() == want
    if route == "fused":
        assert want["gram_norm"] == 0 and want["dense_bwd_norm"] == shape["sites"]
    full = smoke.launch_shape(get_arch("musicgen-medium"), smoke.TRAIN_B, 1500)
    assert (full["sites"], full["auto_norms"]) == (289, (289, 0))
    cut = smoke.launch_shape(dataclasses.replace(get_arch("chameleon-34b"), n_layers=6))
    assert (cut["sites"], cut["auto_norms"], cut["embeds"]) == (43, (0, 43), 0)


@pytest.mark.parametrize("algo,remat,mb", [
    ("dpsgd_r", "block", 0), ("dpsgd_r", "block", 4), ("dpsgd_r1f", "none", 2),
    ("sgd", "sites", 4)])
def test_path_launches_count_the_pipelined_wrapper_calls(smoke, monkeypatch, algo,
                                                         remat, mb):
    """Phase 16 (a): ``path_launches`` with the pipeline's M microbatches
    (every block site and attention M times a pass, the embedding and the
    head once) against the wrapper calls of one Trainer step of the reduced
    phi3 at pp_stages 2 on the CPU."""
    import torch
    from repro_torch.configs import reduced
    from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.core.algo import stage_microbatches
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    _count_wrapper_calls(smoke, monkeypatch)
    arch = reduced(get_arch("phi3-mini-3.8b"))
    model = Model(arch, dtype=torch.float32, device="cpu", remat=remat,
                  pp_stages=2, pp_microbatches=mb)
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                      remat=remat, optim=OptimConfig(schedule="constant"),
                      dp=DPConfig(algo=algo, norm_strategy="fused", use_kernels=True))
    trainer = Trainer(model, cfg, ShapeConfig("t", 8, 4, "train"))
    state = trainer.init_state()
    smoke.zero_counts()
    trainer.train_step(state, trainer.make_batch(0))
    M = stage_microbatches(4, 2, mb)
    assert M == (mb or 2)
    assert smoke.read_counts() == smoke.path_launches(
        "fused", arch.n_layers, algo=algo, remat=remat, microbatches=M)
    with pytest.raises(ValueError, match="dense decoder"):
        smoke.path_launches("fused", 2, family="vit", microbatches=2)


def test_parse_launcher_reads_interleaved_ranks(smoke):
    """Two ranks' lines, interleaved mid-line as their prints land: the
    backend, the fingerprints, each step's records (one a rank) and the
    memory lines."""
    text = (
        "[train] backend gloo: rank 0 of 2 on cuda:0"
        "[train] backend gloo: rank 1 of 2 on cuda:0\n\n"
        "[train] init fingerprint 0x1234abcd (2 process(es) agree)\n"
        "[train] init fingerprint 0x1234abcd (2 process(es) agree)\n"
        "[train] memory: estimated peak 9.500 GB (remat=block, grad_accum=1, "
        "per-example side-channel 0.000 GB); per device 7.250 GB over a 2-wide "
        "batch axis\n"
        "[trainer] step     0 loss 10.4321 grad_norm_mean 3.5 eps inf (812 ms)"
        "[trainer] step     0 loss 10.4321 grad_norm_mean 3.5 eps inf (790 ms)\n\n"
        "[trainer] step     1 loss 10.1 grad_norm_mean 3.25 eps inf (640 ms)\n"
        "[trainer] step     1 loss 10.1 grad_norm_mean 3.25 eps inf (655 ms)\n"
        "[train] memory: measured peak 11.000 GB over steps 0..1 (estimate/measured 0.86)\n")
    got = smoke.parse_launcher(text)
    assert got["backend"] == [("gloo", "0", "2", "cuda:0"), ("gloo", "1", "2", "cuda:0")]
    assert [f for f, _ in got["fingerprint"]] == ["0x1234abcd"] * 2
    assert got["steps"][0] == [dict(loss=10.4321, grad_norm_mean=3.5, ms=812),
                               dict(loss=10.4321, grad_norm_mean=3.5, ms=790)]
    assert [r["ms"] for r in got["steps"][1]] == [640, 655]
    assert got["estimate"] == [("9.500", "7.250")] and got["measured"] == ["11.000"]


def test_leaf_gap_and_zero1_shards(smoke):
    """The leaf-by-leaf comparison of two restored checkpoints (a share of
    each reference leaf's max), and the ZeRO-1 shard files phase 16 (c)
    expects of phi3-mini at 2 layers on a 2-wide data axis: 2 for every
    weight matrix, 1 for the norm scales."""
    import dataclasses
    import torch
    want = [torch.tensor([1.0, -4.0]), torch.zeros(3), torch.tensor([[2.0]])]
    got = [torch.tensor([1.0, -3.0]), torch.zeros(3), torch.tensor([[2.5]])]
    assert smoke.leaf_gap(got, want) == pytest.approx(0.25)
    assert smoke.leaf_gap(want, want) == 0.0
    arch = dataclasses.replace(get_arch("phi3-mini-3.8b"), n_layers=smoke.DIST_LAYERS)
    shards = smoke.zero1_expected_shards(arch, 2)
    # blocks (wk, wo, wq, wv, ln1, ln2, w1, w2, w3), embed, final_norm, head
    assert shards == [2, 2, 2, 2, 1, 1, 2, 2, 2, 2, 1, 2]
    manifest = {"leaves": [{"shards": [0]}] * (1 + 2 * 12)
                + [{"shards": [0] * k} for k in shards] + [{"shards": [0]}] * 24}
    assert smoke.ckpt_shard_counts(manifest, range(25, 37)) == shards
    assert smoke.dist_cmd(2, "/x")[3:6] == ["--standalone", "--nproc_per_node", "2"]
    assert smoke.fsdp_cmd(1, "/x")[3:6] == ["--standalone", "--nproc_per_node", "1"]


def test_printed_unit_is_the_launchers_last_loss_digit(smoke):
    """Phase 18 holds the two worlds' losses to one unit of the last of the
    6 significant digits the launcher prints (``:.6g``)."""
    for x, unit in ((11.5838, 1e-4), (10.872, 1e-4), (6.10056, 1e-5),
                    (0.0123456, 1e-7), (123456.0, 1.0)):
        assert smoke.printed_unit(x) == pytest.approx(unit, rel=1e-12)
        assert float(f"{x:.6g}") == x


@pytest.mark.parametrize("route,algo", [("fused", "dpsgd_r"), ("materialize", "dpsgd_r"),
                                        ("fused", "dpsgd_r1f")])
def test_kernel_records_equal_the_formulas_times_launches(smoke, route, algo):
    """Phase 17 (a)'s gate on the CPU: a traced step's kernel cost records
    (the wrappers' plain versions' work) equal this script's per-launch
    FLOP formulas without the causal and symmetric-tile halvings, times
    ``path_launches``; a perturbed count fails the check.  Phase 6's
    16-layer mix holds 15.66 TFLOP of dense products a pass (its 113
    calls), twice that in ``dense_bwd_norm``'s records."""
    import dataclasses

    import torch
    from repro_torch.configs import reduced
    from repro_torch.configs.base import DPConfig, TrainConfig
    from repro_torch.launch.memory import abstract_batch, estimate_train_memory
    from repro_torch.models import build_model_for
    arch = reduced(get_arch("phi3-mini-3.8b"))
    B, T, L = 2, 24, arch.n_layers
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32", remat="none",
                      dp=DPConfig(algo=algo, norm_strategy=route, use_kernels=True))
    model = build_model_for(arch, dtype=torch.float32, param_dtype=torch.float32,
                            device="cpu", seed=0, remat="none")
    costs = estimate_train_memory(model, cfg, abstract_batch(arch, B, T), costs=True)["costs"]
    launches = smoke.path_launches(route, L, algo=algo)
    want = smoke.kernel_record_flops(arch, L, B, T, launches)
    assert smoke.check_kernel_records(costs, want) <= smoke.KERNEL_FLOPS_RTOL
    assert {k: v["calls"] for k, v in costs["kernels"].items()} == \
        {k: v for k, v in launches.items() if v}
    with pytest.raises(AssertionError):
        smoke.check_kernel_records(costs, dict(want, flash_attn_fwd=want["flash_attn_fwd"]
                                               * (1 + 1e-6)))
    phi3 = dataclasses.replace(get_arch("phi3-mini-3.8b"), n_layers=smoke.TRAIN_LAYERS)
    one = smoke.kernel_record_flops(phi3, smoke.TRAIN_LAYERS, smoke.TRAIN_B, smoke.TRAIN_T,
                                    smoke.path_launches("fused", smoke.TRAIN_LAYERS))
    assert one["dense_bwd_norm"] == 2 * 2.0 * 4096 * 1_911_029_760


def test_parse_autotune_launch_reads_the_launcher(smoke):
    text = ("[train] backend none (one process): rank 0 of 1 on cuda\n"
            "[train] autotune (ga, seed=0): searched 192 plans, 5 traces (10 cache "
            "hits); winner LaunchPlan(grad_accum=1, microbatch=0, remat='block', "
            "norm_strategy='fused', use_kernels=True, mesh_shape=(1, 1), "
            "compress_grads=False, pp_stages=1)\n"
            "[train] autotune predicted-vs-measured rank correlation: -0.500 over 3 "
            "measured plans\n"
            "[trainer] step     0 loss 10.87840 grad_norm_mean 12.372 eps 0.1 (1649 ms)\n"
            "[trainer] step     1 loss 10.87220 grad_norm_mean 12.1 eps 0.3 (116 ms)\n"
            "[train] finished at step 2; privacy spent: eps=0.320 (delta=1e-05, q=8e-06)\n")
    got = smoke.parse_autotune_launch(text)
    (method, seed, size, traces, hits, winner), = got["autotune"]
    assert (method, seed, size, traces, hits) == ("ga", "0", "192", "5", "10")
    assert winner.endswith("pp_stages=1)") and "mesh_shape=(1, 1)" in winner
    assert got["correlation"] == [("-0.500", "3")]
    assert [s[1] for s in got["step"]] == ["10.87840", "10.87220"]
    assert got["privacy"] == [("2", "0.320")]
    cmd = smoke.launch_tune_cmd("/tmp/x")
    assert "--autotune" in cmd and "tune.include_kernels=true" in cmd
    assert cmd[cmd.index("--layers") + 1] == str(smoke.LAUNCH_TUNE_LAYERS)


@pytest.mark.parametrize("plan", [
    dict(grad_accum=1, remat="none", norm_strategy="fused", use_kernels=True, pp_stages=1),
    dict(grad_accum=2, remat="none", norm_strategy="auto", use_kernels=True, pp_stages=2),
    dict(grad_accum=1, remat="block", norm_strategy="gram", use_kernels=True, pp_stages=2),
    dict(grad_accum=2, remat="sites", norm_strategy="materialize", use_kernels=True,
         pp_stages=1),
    dict(grad_accum=1, remat="block", norm_strategy="fused", use_kernels=False, pp_stages=1),
    dict(grad_accum=1, remat="none", norm_strategy="auto", use_kernels=False, pp_stages=2)],
    ids=lambda p: "-".join(str(v) for v in p.values()))
def test_autotune_launches_count_the_measured_plans(smoke, monkeypatch, plan):
    """Phase 17 (b)'s count: ``autotune_launches`` (each measured plan's
    ``plan_launches`` times its warm-up and timed steps) against the
    wrapper calls ``autotune.measure_plan`` makes for that plan with the
    reduced phi3 on the CPU, kernel and plain plans, with grad_accum chunks,
    remat and pipeline stages.  (Here the counting stand-ins count the
    scorer's fake-tensor trace too, so the counts start after it; on the
    card a wrapper's fake branch launches nothing.)"""
    from repro_torch.configs import reduced
    from repro_torch.configs.base import DPConfig, ShapeConfig, TrainConfig
    from repro_torch.launch import autotune
    _count_wrapper_calls(smoke, monkeypatch)
    arch = reduced(get_arch("phi3-mini-3.8b"))
    B, T, iters = 8, 16, 1
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                      dp=DPConfig(algo="dpsgd_r"))
    scorer = autotune.PlanScorer(arch, cfg, ShapeConfig("t", T, B, "train"), device="cpu")
    lp = autotune.LaunchPlan(mesh_shape=(1, 1), **plan)
    assert scorer.score(lp).feasible
    smoke.zero_counts()
    rec = autotune.measure_plan(scorer, lp, iters=iters)
    want = smoke.autotune_launches(arch, [rec], iters, B, T)
    assert smoke.read_counts() == want
    assert want["flash_attn_fwd"] > 0 and (want["gram_norm"] > 0) == plan["use_kernels"]


def _launcher_text(ranks, losses, fingerprints, ms=700):
    """The launcher's lines of ``ranks`` ranks, each rank's steps at
    ``losses`` (one per step) and its fingerprint from ``fingerprints``."""
    backend = "nccl" if ranks == 1 else "gloo"
    lines = [f"[train] backend {backend}: rank {r} of {ranks} on cuda:0"
             for r in range(ranks)]
    lines += [f"[train] init fingerprint {fp} ({ranks} process(es) agree)"
              for fp in fingerprints]
    for step, loss in enumerate(losses):
        lines += [f"[trainer] step {step:5d} loss {loss:.6g} grad_norm_mean "
                  f"{2 * loss:.6g} eps inf ({ms} ms)"] * ranks
    return "\n".join(lines) + "\n"


def test_worlds_agree_on_a_model_axis(smoke):
    """``compare_worlds``' checks of the two worlds' lines, as phase 19
    reads them: the backends, one fingerprint on world 2's ranks (world 1's
    apart when world 2 holds slices), equal step lines on world 2's ranks
    and losses within the tolerance of world 1's; each difference raises."""
    one = smoke.parse_launcher(_launcher_text(1, [10.5, 10.25], ["0x00000001"]))
    two = smoke.parse_launcher(_launcher_text(2, [10.5001, 10.2502],
                                              ["0x0000abcd"] * 2))
    tol = lambda x: smoke.NSQ_RTOL * abs(x)
    assert smoke.worlds_agree(one, two, 2, tol, sliced=True) == "0x0000abcd"
    with pytest.raises(AssertionError):                 # whole params: one fp
        smoke.worlds_agree(one, two, 2, tol, sliced=False)
    far = smoke.parse_launcher(_launcher_text(2, [10.5, 11.0], ["0x0000abcd"] * 2))
    with pytest.raises(AssertionError):
        smoke.worlds_agree(one, far, 2, tol, sliced=True)
    split = smoke.parse_launcher(
        _launcher_text(1, [10.5, 10.25], ["0x0000abcd"]).replace("nccl", "gloo")
        + _launcher_text(1, [10.5, 10.3], ["0x0000abcd"]).replace("nccl", "gloo"))
    with pytest.raises(AssertionError):                 # ranks disagree
        smoke.worlds_agree(one, split, 2, tol, sliced=True)


def test_tp_command_and_shards(smoke):
    """Phase 19's launcher commands (a data axis of 1; a (1, 2) data,model
    mesh; a (1, 2) data,stage mesh), the slices it expects in the
    checkpoints (model: 2 files for every weight matrix, 1 for the norm
    scales; stage: 2 for every block leaf, 1 for the rest) and the bytes
    each rank holds whole beside its slices."""
    import dataclasses
    two, one = smoke.tp_cmd(2, "/x"), smoke.tp_cmd(1, "/x")
    assert two[3:6] == ["--standalone", "--nproc_per_node", "2"]
    at = two.index("--mesh")
    assert two[at:at + 4] == ["--mesh", "1,2", "--axes", "data,model"]
    at = one.index("--mesh")
    assert one[at:at + 4] == ["--mesh", "1", "--axes", "data"]
    assert "ckpt_dir=/x" in two and f"optim.name={smoke.TP_OPTIM}" in two
    arch = dataclasses.replace(get_arch("phi3-mini-3.8b"), n_layers=smoke.TP_LAYERS)
    # blocks (wk, wo, wq, wv, ln1, ln2, w1, w2, w3), embed, final_norm, head
    assert smoke.zero1_expected_shards(arch, 2, axis="model") == \
        [2, 2, 2, 2, 1, 1, 2, 2, 2, 2, 1, 2]
    d, L = arch.d_model, smoke.TP_LAYERS
    # float32 scales, SGD's float32 momentum of each
    assert smoke.replicated_bytes(arch, 2, "sgd") == ((2 * L + 1) * d * 4,) * 2
    # the stage world: a (1, 2) data,stage mesh at pp_stages 2; the blocks in
    # 2 files, the embedding, final norm and head in 1, held whole on a rank
    stage = smoke.stage_cmd("/x")
    at = stage.index("--mesh")
    assert stage[at:at + 4] == ["--mesh", "1,2", "--axes", "data,stage"]
    assert "pp_stages=2" in stage and stage[3:6] == ["--standalone",
                                                      "--nproc_per_node", "2"]
    assert smoke.zero1_expected_shards(arch, 2, axis="stage") == [2] * 9 + [1] * 3
    V = 32256
    assert smoke.replicated_bytes(arch, 2, "sgd", axis="stage") == (
        2 * V * d * 2 + d * 4, (2 * V * d + d) * 4)


@pytest.mark.parametrize("algo,remat", [("dpsgd_r", "none"), ("dpsgd_r1f", "block"),
                                        ("sgd", "none")])
def test_path_launches_count_a_model_ranks_wrapper_calls(smoke, monkeypatch, algo,
                                                         remat):
    """Phase 19: ``path_launches`` of the whole batch against the wrapper
    calls of one Trainer step of a model rank's slices (reduced phi3 cut
    for a 2-wide model axis, its local shapes), the model collectives the
    identity (``runtime.suspended``): the counts are by site, not width."""
    import types
    import torch
    from repro_torch.configs import reduced
    from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.dist import runtime
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    _count_wrapper_calls(smoke, monkeypatch)
    arch = reduced(get_arch("phi3-mini-3.8b"))
    mesh = types.SimpleNamespace(axis_names=("data", "model"), shape=(1, 2),
                                 get_local_rank=lambda axis: 1)
    model = Model(arch, dtype=torch.float32, device="cpu", remat=remat, mesh=mesh)
    assert model.params["head"].shape[1] * 2 == model.abstract_params()["head"].shape[1]
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                      remat=remat, optim=OptimConfig(schedule="constant"),
                      dp=DPConfig(algo=algo, norm_strategy="fused", use_kernels=True))
    trainer = Trainer(model, cfg, ShapeConfig("t", 8, 4, "train"))
    with runtime.suspended():
        state = trainer.init_state()
        smoke.zero_counts()
        trainer.train_step(state, trainer.make_batch(0))
    assert smoke.read_counts() == smoke.path_launches(
        "fused", arch.n_layers, algo=algo, remat=remat)


@pytest.mark.parametrize("algo,remat", [("dpsgd_r", "none"), ("dpsgd_r1f", "block"),
                                        ("sgd", "none")])
def test_stage_launches_count_a_stage_ranks_wrapper_calls(smoke, monkeypatch, algo,
                                                          remat):
    """Phase 19's stage world: ``stage_launches`` of each rank against the
    wrapper calls of one Trainer step of that stage rank's blocks (reduced
    phi3 at pp_stages 2 on a 2-wide stage axis), in one process under a
    cost trace's layout, whose stage messages are recorded and received as
    zeros; the two ranks' counts sum to the pipelined whole's
    ``path_launches``."""
    import types
    import torch
    from repro_torch.configs import reduced
    from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.dist import runtime
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    _count_wrapper_calls(smoke, monkeypatch)
    arch = reduced(get_arch("phi3-mini-3.8b"))
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32", remat=remat,
                      pp_stages=2, optim=OptimConfig(schedule="constant"),
                      dp=DPConfig(algo=algo, norm_strategy="fused", use_kernels=True))
    got = []
    for index in range(2):
        mesh = types.SimpleNamespace(axis_names=("data", "stage"), shape=(1, 2),
                                     get_local_rank=lambda axis, i=index: i)
        model = Model(arch, dtype=torch.float32, device="cpu", remat=remat,
                      pp_stages=2, mesh=mesh)
        trainer = Trainer(model, cfg, ShapeConfig("t", 8, 4, "train"))
        with runtime.traced(), runtime.layout(mesh, None):
            state = trainer.init_state()
            smoke.zero_counts()
            trainer.train_step(state, trainer.make_batch(0))
        got.append(smoke.read_counts())
        assert got[-1] == smoke.stage_launches(index, 2, "fused", arch.n_layers,
                                               algo=algo, remat=remat, microbatches=2)
    whole = smoke.path_launches("fused", arch.n_layers, algo=algo, remat=remat,
                                microbatches=2)
    assert {k: got[0][k] + got[1][k] for k in whole} == whole


def test_stage_moved_is_a_traced_stage_rank(smoke):
    """Phase 19's prediction of the first stage rank's bytes a step by kind
    (``stage_moved``) against ``traced_rank_collectives`` of that rank at
    reduced phi3 (float32); the last rank sends the losses besides."""
    import collections
    import torch
    from repro_torch.configs import reduced
    from repro_torch.configs.base import DPConfig, TrainConfig
    from repro_torch.launch.costs import traced_rank_collectives
    from repro_torch.launch.memory import abstract_batch
    from repro_torch.models.transformer import Model
    arch = reduced(get_arch("phi3-mini-3.8b"))
    model = Model(arch, dtype=torch.float32, device="cpu", pp_stages=2)
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32", pp_stages=2,
                      dp=DPConfig(norm_strategy="fused"))
    traced = collections.Counter()
    for r in traced_rank_collectives(model, cfg, abstract_batch(arch, 8, 16), 1,
                                     stages=2):
        traced[r["kind"]] += r["bytes"]
    first, last = smoke.stage_moved(arch, 8, 16, element=4)
    assert dict(traced) == first
    assert last == dict(first, send=first["send"] + 2 * 4 * 8)


def test_phase20_cells_and_commands(smoke):
    """Phase 20: the dry-run's cells (phi3-mini's three shapes on the
    single mesh, train_4k on the multi one; chatglm3-6b refused), the
    serving cut and its ranks' command (two ranks under
    ``torch.distributed.run`` running this script's rank body); a model
    rank's prefill shape is 16 of phi3-mini's 32 heads of hd 96."""
    assert smoke.DRYRUN_CELLS == (("train_4k", "single"), ("prefill_32k", "single"),
                                  ("decode_32k", "single"), ("train_4k", "multi"))
    assert smoke.DRYRUN_REFUSED == ("chatglm3-6b", "train_4k", "single")
    assert (smoke.SERVE_TP_LAYERS, smoke.SERVE_TP_B, smoke.SERVE_TP_T, smoke.SERVE_TP_S,
            smoke.SERVE_TP_STEPS) == (8, 4, 512, 1024, 32)
    assert smoke.SERVE_TP_COMPUTE == ("bfloat16", "float32")
    cmd = smoke.serve_tp_cmd("/x")
    assert cmd[1:6] == ["-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node", "2"]
    assert cmd[-3].endswith("chip_smoke.py") and cmd[-2:] == ["--serve-tp-rank", "/x"]
    assert smoke._first_divergence([[1, 2], [3, 4], [5, 6]],
                                   [[1, 2], [3, 9], [7, 6]]) == [2, 1]
    assert smoke.dryrun_cmd("/x", 1)[1:] == [str(smoke.ROOT / "chip_smoke.py"),
                                             "--dryrun-cells", "/x", "1"]
    # every cell in one group; each train cell in a group of its own
    assert sorted(i for g in smoke.DRYRUN_GROUPS for i in g) == [0, 1, 2, 3]
    assert (0,) in smoke.DRYRUN_GROUPS and (3,) in smoke.DRYRUN_GROUPS
    arch, shapes = smoke.serve_tp_cells()
    assert arch.n_layers == smoke.SERVE_TP_LAYERS and arch.d_model == 3072
    assert [(s.kind, s.seq_len, s.global_batch) for s in shapes.values()] == [
        ("prefill", 512, 4), ("decode", 1024, 4)]
    arch = get_arch("phi3-mini-3.8b")
    assert (arch.n_heads // 2, arch.n_kv_heads // 2, arch.hd) == (16, 16, 96)
