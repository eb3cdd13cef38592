"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (a CUDA
kernel has no CPU mode).  The file imports no JAX, so it also runs on a
machine without it; there, skip the JAX-importing conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: float32 at rtol 2e-4 / atol 2e-5 (tests/test_kernels.py);
bf16 against the plain version computed in float32 at atol 2e-2.  The
backward and norm kernels convert bf16 inputs to float32 exactly and
accumulate in float32, so their float32 outputs (norms², attention grads)
differ from the plain version on the same inputs only by summation order:
rtol 1e-4 (norms²) and 1e-3 (float32 attention grads, which also go
through exp); a bf16 gx also rounds its output (one bf16 ulp, 2^-8
relative).  The bf16 attention backward runs on the tensor cores, which
take p and ds rounded to bf16 as operands (as every tensor-core attention
backward does), so its grads are held to ``BWD_BF16_TOL`` of each
output's largest entry.  ``pegrad_norm`` and
``dense_dgrad`` are ``dense_bwd_norm``'s two launches alone and must equal
its outputs bit for bit; ``clip_reduce`` sums in float32 in row order
(rtol 1e-5 against the plain version's float32 product, atol 1e-5 of the
largest |g| times Σ|c| for the cancellations), fresh or added into a
running sum.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import clip_reduce as tcr
from repro_torch.kernels import flash_attn as tfa
from repro_torch.kernels import fused_bwd as tfb
from repro_torch.kernels import gram_norm as tgn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pegrad_norm as tpn
from repro_torch.kernels import ref as tref

# (BH, KV rows, T, hd, causal): every head width the kernel is built for
# (16 reduced, 20 and 8 odd widths, 80 / 96 / 128 stablelm, phi3,
# starcoder2), GQA (rep > 1), ragged T, one T below a tile, non-causal
SHAPES = [(8, 4, 16, 8, True), (3, 1, 33, 20, True), (8, 8, 24, 96, True),
          (4, 2, 16, 8, False), (6, 2, 70, 96, True), (4, 2, 37, 96, False),
          (18, 2, 130, 128, True), (4, 4, 65, 80, True), (4, 4, 9, 16, False),
          (9, 1, 200, 64, True),
          # the bf16 tensor-core tiles' edges: T below one 16-row fragment,
          # S ragged over several 64-key tiles (the cp.async ring wraps),
          # every head width at rep > 1
          (8, 4, 9, 8, True), (6, 2, 45, 20, False), (8, 2, 77, 80, True),
          (4, 2, 300, 96, True), (6, 3, 129, 128, False), (4, 1, 5, 96, True),
          (6, 2, 200, 16, False), (4, 2, 150, 64, True),
          # chatglm3-6b's training shape: 8 x 32 heads on 2 kv heads (rep
          # 16), T 512, hd 128
          (256, 16, 512, 128, True),
          # the ViT's: non-causal over its 64 patches at hd 32
          (64, 64, 64, 32, False)]


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


def _randn(cuda, shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda, dtype)


# (BG, T, di, do, E): aligned, ragged in every dim, grouped, one row tile;
# then the bf16 tensor-core tile's edges (128 x 256 output tiles, 64-deep
# stages in a ring of 4): T not a multiple of 64 or 128, di not a multiple
# of 128, do < 64, do over more stages than the ring holds (TMA), do % 8 != 0
# over several stages (element loads), grouped E 4 with di % 128 != 0
DENSE_SHAPES = [(2, 128, 128, 256, 1), (3, 37, 100, 70, 1), (4, 33, 65, 129, 2),
                (2, 200, 300, 260, 1), (5, 9, 8, 24, 3),
                (2, 130, 384, 512, 1), (3, 100, 200, 40, 1), (2, 70, 130, 1000, 2),
                (3, 45, 70, 333, 1), (4, 96, 520, 136, 4), (8, 300, 1024, 768, 4),
                # the image families' folded patch pairs (K views of an
                # example in T): the CNN's stem (d_in 27) and the ViT's head
                # (d_out 10) take the element-load paths
                (2, 2048, 27, 16, 1), (3, 32, 256, 10, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_dense_bwd_norm_matches_plain(cuda, shape, dtype):
    BG, T, di, do, E = shape
    x = _randn(cuda, (BG, T, di), dtype, 0)
    gy = _randn(cuda, (BG, T, do), dtype, 1)
    w = _randn(cuda, (E, di, do), dtype, 2)
    before = tfb.LAUNCHES
    gx, nsq = tfb.dense_bwd_norm(x, gy, w)
    torch.cuda.synchronize()
    assert tfb.LAUNCHES == before + 1
    assert gx.dtype == dtype and nsq.dtype == torch.float32
    gx_ref, nsq_ref = tref.dense_bwd_norm_ref(x, gy, w)
    torch.testing.assert_close(nsq, nsq_ref, rtol=1e-4, atol=0.0)
    gx_want = tref.dense_bwd_norm_ref(x.float(), gy.float(), w.float())[0]
    if dtype == torch.float32:
        torch.testing.assert_close(gx, gx_want, rtol=2e-4, atol=2e-4)
    else:
        torch.testing.assert_close(gx.float(), gx_want, rtol=1e-2,
                                   atol=1e-2 * gx_want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_bwd_norm_zero_rows_and_determinism(cuda, dtype):
    x = _randn(cuda, (4, 70, 96), dtype)
    gy = _randn(cuda, (4, 70, 130), dtype, 1)
    gy[1] = 0
    gy[3] = 0
    w = _randn(cuda, (2, 96, 130), dtype, 2)
    gx, nsq = tfb.dense_bwd_norm(x, gy, w)
    gx2, nsq2 = tfb.dense_bwd_norm(x, gy, w)
    torch.cuda.synchronize()
    for b in (1, 3):
        assert torch.all(gx[b] == 0) and nsq[b].item() == 0.0
    assert torch.all(nsq[[0, 2]] > 0)
    assert torch.equal(nsq, nsq2) and torch.equal(gx, gx2)


# (BG, T, di, do): one tile, ragged T over several tiles, wide d; one row
# at the auto route's T (32 x 32 tile pairs)
GRAM_SHAPES = [(2, 16, 8, 24), (3, 70, 33, 65), (2, 130, 64, 300), (1, 2048, 64, 96),
               (2, 2048, 27, 16), (3, 32, 256, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("shape", GRAM_SHAPES)
def test_gram_norm_matches_plain(cuda, shape, masked, square, dtype):
    BG, T, di, do = shape
    x = _randn(cuda, (BG, T, di), dtype, 0)
    gy = _randn(cuda, (BG, T, do), dtype, 1)
    ids = None
    if masked:   # a small vocab, so tokens repeat
        ids = torch.from_numpy(np.random.default_rng(3).integers(0, 7, (BG, T))).to(cuda)
    before = tgn.LAUNCHES
    out = tgn.gram_norm(x, gy, ids, square=square)
    torch.cuda.synchronize()
    assert tgn.LAUNCHES == before + 1 and out.dtype == torch.float32
    want = tref.gram_norm_ref(x, gy, ids, square)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


@pytest.mark.cuda
def test_gram_norm_zero_rows_and_determinism(cuda):
    gy = _randn(cuda, (3, 200, 96), torch.bfloat16)
    gy[1] = 0
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 5, (3, 200))).to(cuda)
    a = tgn.gram_norm(gy, gy, ids, square=False)
    b = tgn.gram_norm(gy, gy, ids, square=False)
    torch.cuda.synchronize()
    assert a[1].item() == 0.0 and torch.all(a[[0, 2]] > 0)
    assert torch.equal(a, b)


# the bf16 attention backward against the float32 plain version: a share
# of each output's largest entry (p and ds are bf16 tensor-core operands,
# as in every tensor-core attention backward, SDPA's included)
BWD_BF16_TOL = 5e-3

# (BH, KV rows, T, hd, causal)
BWD_SHAPES = [(8, 4, 16, 8, True), (3, 1, 33, 20, True), (4, 2, 37, 96, False),
              (6, 2, 70, 96, True), (18, 2, 130, 128, True), (4, 4, 65, 80, False),
              (9, 1, 200, 64, True), (256, 16, 512, 128, True),
              (64, 64, 64, 32, False)]


def _bwd_inputs(cuda, shape, dtype):
    BH, KVR, T, hd, causal = shape
    q, k, v, do = (_randn(cuda, (n, T, hd), dtype, s)
                   for s, n in enumerate((BH, KVR, KVR, BH)))
    o, lse = tref.flash_attn_fwd_ref(q, k, v, causal, BH // KVR)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_attn_bwd_matches_plain(cuda, shape, dtype):
    BH, KVR, T, hd, causal = shape
    q, k, v, o, lse, do = _bwd_inputs(cuda, shape, dtype)
    before = tfa.BWD_LAUNCHES
    got = tfa.flash_attn_bwd(q, k, v, o, lse, do, causal=causal, rep=BH // KVR)
    torch.cuda.synchronize()
    assert tfa.BWD_LAUNCHES == before + 1
    want = tref.flash_attn_bwd_ref(q, k, v, o, lse, do, causal, BH // KVR)
    for g, r in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == r.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-3 * r.abs().max().item())
        else:
            torch.testing.assert_close(g, r, rtol=0.0,
                                       atol=BWD_BF16_TOL * r.abs().max().item())


@pytest.mark.cuda
def test_flash_attn_bwd_zero_rows_and_determinism(cuda):
    shape = (6, 3, 100, 96, True)
    q, k, v, o, lse, do = _bwd_inputs(cuda, shape, torch.bfloat16)
    do[0:2] = 0     # kv head 0's two query heads see no gradient
    do[4, 10:30] = 0
    a = tfa.flash_attn_bwd(q, k, v, o, lse, do, causal=True, rep=2)
    b = tfa.flash_attn_bwd(q, k, v, o, lse, do, causal=True, rep=2)
    torch.cuda.synchronize()
    dq, dk, dv = a
    assert torch.all(dq[0:2] == 0) and torch.all(dq[4, 10:30] == 0)
    assert torch.all(dk[0] == 0) and torch.all(dv[0] == 0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_autograd_matches_plain_autograd(cuda, causal):
    B, T, KV, rep, hd = 2, 45, 2, 3, 32
    q = _randn(cuda, (B, T, KV, rep, hd), torch.float32, 0).requires_grad_()
    k = _randn(cuda, (B, T, KV, hd), torch.float32, 1).requires_grad_()
    v = _randn(cuda, (B, T, KV, hd), torch.float32, 2).requires_grad_()
    do = _randn(cuda, (B, T, KV, rep, hd), torch.float32, 3)
    before = tfa.BWD_LAUNCHES
    got = torch.autograd.grad(tops.flash_attention(q, k, v, causal), (q, k, v), do)
    assert tfa.BWD_LAUNCHES == before + 1
    want = torch.autograd.grad(tref.flash_attn_ref(q, k, v, causal), (q, k, v), do)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_pegrad_norm_and_dgrad_match_plain_and_the_fused_kernel(cuda, shape, dtype):
    BG, T, di, do, E = shape
    x = _randn(cuda, (BG, T, di), dtype, 0)
    gy = _randn(cuda, (BG, T, do), dtype, 1)
    w = _randn(cuda, (E, di, do), dtype, 2)
    before = (tpn.LAUNCHES, tfb.DGRAD_LAUNCHES, tfb.LAUNCHES)
    nsq = tpn.pegrad_norm(x, gy)
    gx = tfb.dense_dgrad(gy, w)
    torch.cuda.synchronize()
    assert (tpn.LAUNCHES, tfb.DGRAD_LAUNCHES, tfb.LAUNCHES) == \
        (before[0] + 1, before[1] + 1, before[2])
    assert nsq.dtype == torch.float32 and gx.dtype == dtype
    torch.testing.assert_close(nsq, tref.pegrad_norm_ref(x, gy), rtol=1e-4, atol=0.0)
    gx_want = tref.dense_dgrad_ref(gy.float(), w.float())
    if dtype == torch.float32:
        torch.testing.assert_close(gx, gx_want, rtol=2e-4, atol=2e-4)
    else:
        torch.testing.assert_close(gx.float(), gx_want, rtol=1e-2,
                                   atol=1e-2 * gx_want.abs().max().item())
    fgx, fnsq = tfb.dense_bwd_norm(x, gy, w)
    assert torch.equal(gx, fgx) and torch.equal(nsq, fnsq)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pegrad_norm_and_dgrad_zero_rows_and_determinism(cuda, dtype):
    x = _randn(cuda, (4, 70, 96), dtype)
    gy = _randn(cuda, (4, 70, 130), dtype, 1)
    gy[1] = 0
    gy[3] = 0
    w = _randn(cuda, (2, 96, 130), dtype, 2)
    a, b = tpn.pegrad_norm(x, gy), tpn.pegrad_norm(x, gy)
    ga, gb = tfb.dense_dgrad(gy, w), tfb.dense_dgrad(gy, w)
    torch.cuda.synchronize()
    for r in (1, 3):
        assert a[r].item() == 0.0 and torch.all(ga[r] == 0)
    assert torch.all(a[[0, 2]] > 0)
    assert torch.equal(a, b) and torch.equal(ga, gb)


@pytest.mark.cuda
def test_dense_shims_on_the_card(cuda):
    """ops.pegrad_norm / ops.dense_dgrad: (B,G,T,d) operands, w (G,di,do),
    against the plain versions over the flattened rows."""
    B, G, T, di, do = 2, 3, 33, 40, 24
    x = _randn(cuda, (B, G, T, di), torch.float32, 0)
    gy = _randn(cuda, (B, G, T, do), torch.float32, 1)
    w = _randn(cuda, (G, di, do), torch.float32, 2)
    nsq = tops.pegrad_norm(x, gy)
    gx = tops.dense_dgrad(gy, w)
    want = tref.pegrad_norm_ref(x.reshape(B * G, T, di),
                                gy.reshape(B * G, T, do)).reshape(B, G).sum(1)
    torch.testing.assert_close(nsq, want, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(gx, tref.dense_dgrad_ref(
        gy.reshape(B * G, T, do), w).reshape(B, G, T, di), rtol=2e-4, atol=2e-4)


# (B, N): small aligned and ragged widths, one row, a row count past a
# ring group; the image models' flat microbatch buffers, one a parameter
# dtype (the CNN's bf16 weights, 270,896, and float32 scales and biases,
# 1,386 padded to 1,392; the ViT's 6,306,304 at 32 examples and 21,008) and
# all their parameters end to end, unpadded (272,282 and 6,327,306); a
# narrow leaf (the CNN head's bias)
CLIP_SHAPES = [(8, 4096), (3, 1003), (1, 8), (13, 777), (9, 2048 + 4),
               (256, 270896), (256, 1392), (32, 6306304), (256, 21008),
               (256, 272282), (32, 6327306), (256, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fresh", "out"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CLIP_SHAPES)
def test_clip_reduce_matches_plain(cuda, shape, dtype, mode):
    """A fresh sum, and one added into a running float32 sum (``out=``):
    within the plain version's float32 product, and the added one equal to
    the running sum plus the fresh one bit for bit (one float add a
    column)."""
    B, N = shape
    g = _randn(cuda, (B, N), dtype, 0)
    c = torch.rand(B, generator=torch.Generator().manual_seed(1)).to(cuda)
    acc0 = _randn(cuda, (N,), torch.float32, 2)
    before = tcr.LAUNCHES
    fresh = tcr.clip_reduce(g, c)
    out = fresh if mode == "fresh" else tcr.clip_reduce(g, c, out=acc0.clone())
    torch.cuda.synchronize()
    assert tcr.LAUNCHES == before + (1 if mode == "fresh" else 2)
    assert out.dtype == torch.float32 and out.shape == (N,)
    want = tref.clip_reduce_ref(g, c)
    scale = g.float().abs().max().item() * c.abs().sum().item()
    if mode == "out":
        assert torch.equal(out, acc0 + fresh)
        want = want + acc0
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fresh", "out"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [4096, 1003, 36864, 270896])
def test_clip_reduce_zero_rows_equal_compacted_and_repeat(cuda, dtype, N, mode):
    """Zeroed clip factors give the compacted batch's sum bit for bit, and a
    repeat the same bits, on both paths: 36,864 (the CNN's stage-2 conv) in
    bf16 takes the column loads, 270,896 (its flat bf16 buffer) the
    cp.async ring."""
    g = _randn(cuda, (10, N), dtype, 3)
    c = torch.rand(10, generator=torch.Generator().manual_seed(4)).to(cuda)
    keep = torch.tensor([1, 0, 1, 1, 0, 0, 1, 1, 1, 0], dtype=torch.bool, device=cuda)
    cm = torch.where(keep, c, torch.zeros_like(c))
    acc0 = _randn(cuda, (N,), torch.float32, 5)

    def run(g_, c_):
        return tcr.clip_reduce(g_, c_) if mode == "fresh" else \
            tcr.clip_reduce(g_, c_, out=acc0.clone())

    a, b = run(g, cm), run(g, cm)
    compact = run(g[keep].contiguous(), c[keep].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, compact)


@pytest.mark.cuda
def test_clip_reduce_paths(cuda):
    """The ring takes the flat buffers (16-byte rows whose chunks fill the
    card); the column loads take narrow, ragged and unaligned rows; B 256 x
    the CNN's stage-2 conv (36,864 bf16 columns) is narrow."""
    def g(B, N, dtype=torch.bfloat16):
        return torch.zeros(B, N, dtype=dtype, device=cuda)
    assert tcr.clip_reduce_path(g(256, 270896)) == "cp.async"
    assert tcr.clip_reduce_path(g(32, 6306304)) == "cp.async"
    assert tcr.clip_reduce_path(g(256, 1392, torch.float32)) == "loads"
    assert tcr.clip_reduce_path(g(8, 262144, torch.float32)) == "cp.async"
    assert tcr.clip_reduce_path(g(256, 6327306)) == "loads"      # rows not 16-byte
    assert tcr.clip_reduce_path(g(256, 36864)) == "loads"
    assert tcr.clip_reduce_path(g(256, 10)) == "loads"
    def offset(k):         # a (2, 272288) view k bf16 elements into its storage
        return torch.rand(2 * 272288 + k, device=cuda).to(torch.bfloat16)[k:].view(2, 272288)

    assert tcr.clip_reduce_path(offset(8)) == "cp.async"          # 16 bytes in: aligned
    skew = offset(1)                                                # 2 bytes in
    assert tcr.clip_reduce_path(skew) == "loads"
    acc = torch.zeros(272288 + 1, device=cuda)[1:]                  # out 4 bytes off
    assert tcr.clip_reduce_path(g(2, 272288), acc) == "loads"
    c = torch.rand(2, device=cuda)
    got = tcr.clip_reduce(skew, c, out=acc)
    torch.testing.assert_close(got, tref.clip_reduce_ref(skew, c), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_new_wrappers_reject_what_they_cannot_run(cuda):
    x = torch.zeros(2, 8, 16, device=cuda)
    with pytest.raises(TypeError):
        tpn.pegrad_norm(x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        tpn.pegrad_norm(x.transpose(1, 2), x.transpose(1, 2))
    with pytest.raises(TypeError):
        tfb.dense_dgrad(x.double(), torch.zeros(1, 4, 16, device=cuda).double())
    with pytest.raises(ValueError):
        tfb.dense_dgrad(x, torch.zeros(1, 4, 15, device=cuda))
    g = torch.zeros(3, 10, device=cuda)
    with pytest.raises(TypeError):
        tcr.clip_reduce(g, torch.zeros(3, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        tcr.clip_reduce(g, torch.zeros(4, device=cuda))


# (BG, T, di, do, E, path of the bf16 gx launch)
DGRAD_PATH_SHAPES = [(4, 70, 96, 512, 2, "wgmma+tma"), (4, 70, 96, 136, 2, "wgmma+tma"),
                     (4, 70, 96, 333, 2, "wgmma+loads"), (6, 333, 700, 517, 3, "wgmma+loads"),
                     (4, 200, 300, 64, 1, "wgmma+tma")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DGRAD_PATH_SHAPES)
def test_dgrad_tensor_core_paths_zero_rows_repeats_and_fused_bits(cuda, shape):
    """bf16 gx on both tensor-core paths: the path the library reports,
    exact zeros for all-zero gy rows, bit-identical repeats, and
    ``dense_dgrad`` equal to ``dense_bwd_norm``'s gx bit for bit."""
    BG, T, di, do, E, path = shape
    x = _randn(cuda, (BG, T, di), torch.bfloat16, 0)
    gy = _randn(cuda, (BG, T, do), torch.bfloat16, 1)
    w = _randn(cuda, (E, di, do), torch.bfloat16, 2)
    gy[1] = 0
    assert tfb.dgrad_path(gy, w) == path
    assert tfb.dgrad_path(gy.float(), w.float()) == "cuda-cores"
    a, b = tfb.dense_dgrad(gy, w), tfb.dense_dgrad(gy, w)
    fgx, _ = tfb.dense_bwd_norm(x, gy, w)
    torch.cuda.synchronize()
    assert torch.all(a[1] == 0) and torch.equal(a, b) and torch.equal(a, fgx)
    want = tref.dense_dgrad_ref(gy.float(), w.float())
    torch.testing.assert_close(a.float(), want, rtol=1e-2,
                               atol=1e-2 * want.abs().max().item())


@pytest.mark.cuda
def test_dgrad_and_flash_take_element_loads_for_unaligned_bases(cuda):
    """A contiguous view one element into its storage is not 16-byte
    aligned: TMA and 16-byte cp.async cannot address it, the element-load
    paths run, and the results still match the plain versions."""
    gy = _randn(cuda, (2 * 70 * 128 + 1,), torch.bfloat16, 1)[1:].view(2, 70, 128)
    w = _randn(cuda, (1, 96, 128), torch.bfloat16, 2)
    assert tfb.dgrad_path(gy, w) == "wgmma+loads"
    assert tfb.dgrad_path(gy.clone(), w) == "wgmma+tma"
    got = tfb.dense_dgrad(gy, w)
    want = tref.dense_dgrad_ref(gy.float(), w.float())
    torch.testing.assert_close(got.float(), want, rtol=1e-2,
                               atol=1e-2 * want.abs().max().item())
    q = _randn(cuda, (4 * 50 * 96 + 1,), torch.bfloat16, 3)[1:].view(4, 50, 96)
    k, v = (_randn(cuda, (2, 50, 96), torch.bfloat16, s) for s in (4, 5))
    assert tfa.fwd_path(q, k, v) == "mma+loads"
    assert tfa.fwd_path(q.clone(), k, v) == "mma+cp.async"
    assert tfa.fwd_path(q.float(), k.float(), v.float()) == "cuda-cores"
    assert tfa.fwd_path(*(t[..., :20].contiguous() for t in (q, k, v))) == "mma+loads"
    o, lse = tfa.flash_attn_fwd(q, k, v, causal=True, rep=2)
    o_ref, lse_ref = tref.flash_attn_fwd_ref(q.float(), k.float(), v.float(), True, 2)
    torch.testing.assert_close(o.float(), o_ref, rtol=0.0, atol=2e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=0.0, atol=2e-2)


# (BH, KV rows, T, hd, causal, path of the bf16 launches): the ViT's
# non-causal hd 32, the training head width, the auto route's T, hd 20
# (rows of 40 bytes: element loads)
BWD_PATH_SHAPES = [(64, 64, 64, 32, False, "mma+cp.async"),
                   (8, 4, 130, 96, True, "mma+cp.async"),
                   (2, 2, 2048, 96, True, "mma+cp.async"),
                   (256, 16, 512, 128, True, "mma+cp.async"),
                   (6, 2, 70, 20, True, "mma+loads"), (4, 4, 65, 20, False, "mma+loads")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BWD_PATH_SHAPES)
def test_flash_attn_bwd_tensor_core_paths_zero_rows_and_repeats(cuda, shape):
    """bf16 attention backward on both tensor-core paths: the path the
    library reports, exact zeros from all-zero dO rows, bit-identical
    repeats, and the bf16 bound against the plain version."""
    BH, KVR, T, hd, causal, path = shape
    rep = BH // KVR
    q, k, v, o, lse, do = _bwd_inputs(cuda, shape[:5], torch.bfloat16)
    do[:rep] = 0     # every query head of kv head 0
    do[rep, 3:40] = 0
    assert tfa.bwd_path(q, k, v, do) == path
    assert tfa.bwd_path(q.float(), k.float(), v.float(), do.float()) == "cuda-cores"
    a = tfa.flash_attn_bwd(q, k, v, o, lse, do, causal=causal, rep=rep)
    b = tfa.flash_attn_bwd(q, k, v, o, lse, do, causal=causal, rep=rep)
    torch.cuda.synchronize()
    dq, dk, dv = a
    assert torch.all(dq[:rep] == 0) and torch.all(dq[rep, 3:40] == 0)
    assert torch.all(dk[0] == 0) and torch.all(dv[0] == 0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    want = tref.flash_attn_bwd_ref(q, k, v, o, lse, do, causal, rep)
    for g, r in zip(a, want):
        torch.testing.assert_close(g, r, rtol=0.0, atol=BWD_BF16_TOL * r.abs().max().item())


@pytest.mark.cuda
def test_flash_attn_bwd_takes_element_loads_for_an_unaligned_base(cuda):
    """dO one element into its storage is not 16-byte aligned: the
    element-load path runs and still matches the plain version."""
    q, k, v, o, lse, do = _bwd_inputs(cuda, (4, 2, 50, 96, True), torch.bfloat16)
    dos = _randn(cuda, (4 * 50 * 96 + 1,), torch.bfloat16, 9)[1:].view(4, 50, 96)
    assert tfa.bwd_path(q, k, v, dos) == "mma+loads"
    assert tfa.bwd_path(q, k, v, dos.clone()) == "mma+cp.async"
    got = tfa.flash_attn_bwd(q, k, v, o, lse, dos, causal=True, rep=2)
    want = tref.flash_attn_bwd_ref(q, k, v, o, lse, dos, True, 2)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0.0, atol=BWD_BF16_TOL * r.abs().max().item())


# (BG, T, di, do, square, path of the bf16 launch): the embedding rule at
# the training width, the auto route's square rule, the head's depth (2016
# k-steps: the tensor cores' own f32 sums would drift low past rtol 1e-4),
# D 517 (element loads), x unaligned under the square rule while gy is
# aligned
GRAM_PATH_SHAPES = [(3, 200, 3072, 3072, False, "mma+cp.async"),
                    (2, 300, 96, 256, True, "mma+cp.async"),
                    (3, 130, 3072, 32256, True, "mma+cp.async"),
                    (3, 130, 517, 517, False, "mma+loads"),
                    (2, 150, 20, 64, True, "mma+loads")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GRAM_PATH_SHAPES)
def test_gram_tensor_core_paths_zero_rows_and_repeats(cuda, shape):
    """bf16 gram_norm on both tensor-core paths: the path the library
    reports, an exact 0.0 for an all-zero gy row, bit-identical repeats,
    and rtol 1e-4 against the plain version (bf16 products are exact in
    float32)."""
    BG, T, di, do, square, path = shape
    gy = _randn(cuda, (BG, T, do), torch.bfloat16, 1)
    x = _randn(cuda, (BG, T, di), torch.bfloat16, 0) if square else gy
    gy[1] = 0
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 9, (BG, T))).to(cuda)
    assert tgn.gram_path(x, gy, square) == path
    assert tgn.gram_path(x.float(), gy.float(), square) == "cuda-cores"
    for mask in (None, ids):
        a = tgn.gram_norm(x, gy, mask, square=square)
        b = tgn.gram_norm(x, gy, mask, square=square)
        torch.cuda.synchronize()
        assert a[1].item() == 0.0 and torch.all(a[[0, 2] if BG > 2 else [0]] > 0)
        assert torch.equal(a, b)
        want = tref.gram_norm_ref(x, gy, mask, square)
        torch.testing.assert_close(a, want, rtol=1e-4, atol=0.0)


@pytest.mark.cuda
def test_gram_takes_element_loads_for_an_unaligned_base(cuda):
    gy = _randn(cuda, (2 * 100 * 64 + 1,), torch.bfloat16, 1)[1:].view(2, 100, 64)
    assert tgn.gram_path(gy, gy, False) == "mma+loads"
    assert tgn.gram_path(gy.clone(), gy.clone(), False) == "mma+cp.async"
    torch.testing.assert_close(tgn.gram_norm(gy, gy, None, square=False),
                               tref.gram_norm_ref(gy, gy, None, False), rtol=1e-4, atol=0.0)


# (BG, T, di, do, path of the bf16 norm launch): the training width at a T
# that is not a multiple of 64; T 2048 (the auto route: 32 stages an item);
# do 32256 (the head's width: 126 j pairs, two items a block); more items
# than blocks over a ragged T; one stage an item; i and j boxes wholly past
# di and do (TMA zero-fills them); di or do % 8 != 0 (element loads), over
# one item a block and over several
NORM_PATH_SHAPES = [(3, 300, 3072, 256, "wgmma+tma"), (2, 2048, 384, 512, "wgmma+tma"),
                    (2, 130, 128, 32256, "wgmma+tma"), (8, 200, 1024, 2048, "wgmma+tma"),
                    (140, 20, 64, 64, "wgmma+tma"), (3, 100, 8, 40, "wgmma+tma"),
                    (4, 96, 520, 136, "wgmma+tma"), (6, 333, 700, 517, "wgmma+loads"),
                    (40, 70, 200, 300, "wgmma+loads"),
                    # the image families' folded patch pairs: the CNN's stem
                    # (d_in 27), a stage-0 conv (d_out 16 in a 256-wide tile)
                    # at K 16 x 1024 positions, the ViT's head (d_out 10)
                    (2, 16384, 27, 16, "wgmma+loads"), (3, 16384, 144, 16, "wgmma+tma"),
                    (4, 16, 256, 10, "wgmma+loads")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", NORM_PATH_SHAPES)
def test_norm_tensor_core_paths_zero_rows_repeats_and_fused_bits(cuda, shape):
    """The bf16 norm launch on both tensor-core paths: the path the library
    reports, rtol 1e-4 against the plain version (bf16 products are exact
    in float32), an exact 0.0 for an all-zero gy row with the other rows'
    bits unchanged, bit-identical repeats, and ``pegrad_norm`` equal to
    ``dense_bwd_norm``'s norms² bit for bit."""
    BG, T, di, do, path = shape
    x = _randn(cuda, (BG, T, di), torch.bfloat16, 0)
    gy = _randn(cuda, (BG, T, do), torch.bfloat16, 1)
    w = _randn(cuda, (1, di, do), torch.bfloat16, 2)
    assert tpn.norm_path(x, gy) == path
    assert tpn.norm_path(x.float(), gy.float()) == "cuda-cores"
    nsq = tpn.pegrad_norm(x, gy)
    torch.testing.assert_close(nsq, tref.pegrad_norm_ref(x, gy), rtol=1e-4, atol=0.0)
    gy[1] = 0
    a, b = tpn.pegrad_norm(x, gy), tpn.pegrad_norm(x, gy)
    _, fnsq = tfb.dense_bwd_norm(x, gy, w)
    torch.cuda.synchronize()
    keep = torch.arange(BG, device=cuda) != 1
    assert a[1].item() == 0.0 and torch.equal(a[keep], nsq[keep])
    assert torch.equal(a, b) and torch.equal(a, fnsq)


@pytest.mark.cuda
def test_norm_takes_element_loads_for_an_unaligned_base(cuda):
    """x or gy one element into its storage is not 16-byte aligned: TMA
    cannot address it and the element loads fill the same swizzled stages,
    so their norms² equal the TMA path's bit for bit."""
    x = _randn(cuda, (3 * 100 * 256 + 1,), torch.bfloat16, 0)[1:].view(3, 100, 256)
    gy = _randn(cuda, (3 * 100 * 384 + 1,), torch.bfloat16, 1)[1:].view(3, 100, 384)
    xc, gyc = x.clone(), gy.clone()
    assert tpn.norm_path(x, gyc) == "wgmma+loads"
    assert tpn.norm_path(xc, gy) == "wgmma+loads"
    assert tpn.norm_path(xc, gyc) == "wgmma+tma"
    tma = tpn.pegrad_norm(xc, gyc)
    torch.testing.assert_close(tma, tref.pegrad_norm_ref(xc, gyc), rtol=1e-4, atol=0.0)
    assert torch.equal(tpn.pegrad_norm(x, gyc), tma)
    assert torch.equal(tpn.pegrad_norm(xc, gy), tma)


@pytest.mark.cuda
def test_flash_kernels_at_hd_128_do_not_spill(cuda):
    """The hd-128 bf16 instantiations of the flash forward and of both
    backward kernels (chatglm3-6b's and starcoder2-7b's head width) keep
    every value in registers: ``-Xptxas -v`` reports no spill stores or
    loads for any of them."""
    import importlib.util
    from pathlib import Path
    from repro_torch.kernels import build
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    pieces = ("mma16flash_fwd_kernelILi128E", "mma13bwd_kv_kernelILi128E",
              "mma12bwd_q_kernelILi128E")
    seen = set()
    for src in ("flash_attn_fwd", "flash_attn_bwd"):
        build.build([src])
        for r in smoke.ptxas_report(build.ptxas_log(src)):
            hit = [p for p in pieces if p in r["function"]]
            if hit:
                assert (r["spill_stores"], r["spill_loads"]) == (0, 0), r
                seen.update(hit)
    assert seen == set(pieces)
