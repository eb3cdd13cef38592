"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (a CUDA
kernel has no CPU mode).  The file imports no JAX, so it also runs on a
machine without it; there, skip the JAX-importing conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: float32 at rtol 2e-4 / atol 2e-5 (tests/test_kernels.py);
bf16 against the plain version computed in float32 at atol 2e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attn as tfa
from repro_torch.kernels import ref as tref

# (BH, KV rows, T, hd, causal): every head width the kernel is built for
# (16 reduced, 20 and 8 odd widths, 80 / 96 / 128 stablelm, phi3,
# starcoder2), GQA (rep > 1), ragged T, one T below a tile, non-causal
SHAPES = [(8, 4, 16, 8, True), (3, 1, 33, 20, True), (8, 8, 24, 96, True),
          (4, 2, 16, 8, False), (6, 2, 70, 96, True), (4, 2, 37, 96, False),
          (18, 2, 130, 128, True), (4, 4, 65, 80, True), (4, 4, 9, 16, False),
          (9, 1, 200, 64, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 reference
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attn_fwd_matches_plain(cuda, shape, dtype):
    BH, KVR, T, hd, causal = shape
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, T, hd), dtype=np.float32))
               .to(cuda, dtype) for n in (BH, KVR, KVR))
    before = tfa.LAUNCHES
    o, lse = tfa.flash_attn_fwd(q, k, v, causal=causal, rep=BH // KVR)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    o_ref, lse_ref = tref.flash_attn_fwd_ref(q.float(), k.float(), v.float(),
                                             causal, BH // KVR)
    rtol, atol = (2e-4, 2e-5) if dtype == torch.float32 else (0.0, 2e-2)
    torch.testing.assert_close(o.float(), o_ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(lse, lse_ref, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_flash_attn_fwd_rejects_what_it_cannot_run(cuda):
    q = torch.zeros(2, 8, 160, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attn_fwd(q, q, q)
    with pytest.raises(TypeError):
        tfa.flash_attn_fwd(*(torch.zeros(2, 8, 16, device=cuda,
                                         dtype=torch.float16),) * 3)
    x = torch.zeros(2, 16, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attn_fwd(x, x, x)
