"""The yardsticks ``chip_smoke.py`` holds the kernels' card times against,
pinned on the CPU: the least time the card could take for the training
step's dense calls and for the serving path's first prefill wave (H100 SXM
peaks: 989 TFLOP/s bf16, 3.35 TB/s).  A change to the work counted, to the
mix of calls or to the traffic moves these numbers and every share of
bound reported beside them."""
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
