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
    from repro_torch import tree
    from repro_torch.configs import reduced
    from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    for name, (mod, attr) in smoke.kernel_counts().items():
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
        microbatch=microbatch, leaves=len(tree.leaves(model.params)))


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
    want = dict.fromkeys(smoke.kernel_counts(), 0)
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
    for name, (mod, attr) in smoke.kernel_counts().items():
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
    from repro_torch import tree
    from repro_torch.configs import reduced
    from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.models import build_model_for
    from repro_torch.train import Trainer
    for kname, (mod, attr) in smoke.kernel_counts().items():
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
        leaves=len(tree.leaves(model.params)), **smoke.launch_shape(arch))
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
