#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; a failure in any of them raises, so
the script exits nonzero and prints no ``ok`` line:

1. the device: torch's name for it and ``nvidia-smi``'s name and power limit;
2. build every CUDA kernel of the port from this checkout's sources (one
   ``nvcc`` per source, all at once), and print ``-Xptxas -v``'s registers
   and spills of the bf16 tensor-core kernels (``[ptxas]``; the main-path
   ones must not spill);
3. every kernel against its plain PyTorch version on the card, at the
   shapes of the serving and training paths, float32 and bf16, timed beside
   the plain version, the one PyTorch call computing the same function
   (``library_ms``, timing only) and the card's bound; the norm kernels
   also give exact zeros for all-zero gy rows and bit-identical repeats;
   ``pegrad_norm`` and ``dense_dgrad`` equal ``dense_bwd_norm``'s two
   outputs bit for bit, and the fusion A/B times the separate pair against
   the fused call; ``clip_reduce`` with zeroed clip factors equals the
   compacted reduction bit for bit.  The dgrad kernel's, the norm
   launch's (``pegrad_norm``), the flash pair's and the Gram kernel's
   lines also give TFLOP/s, the share of the bound and the path each shape
   took (bf16 on the tensor cores, f32 on the CUDA cores); every training
   shape's bf16 gx and norm launch must take the TMA-fed path, its
   attention backward and Grams the cp.async-fed one.  The bf16
   attention backward is held to ``BWD_BF16_TOL`` of each output's max
   (the tensor cores take p and ds in bf16), with SDPA's bf16 backward
   error on the same inputs printed beside it.  The flash backward, the
   Gram kernel and ``pegrad_norm`` also run at the ``auto`` route's shapes
   (B 2 x T 2048).  Phase 11's shapes (``check_image_kernels``): the flash
   pair non-causal at hd 32 and T 64 over 4096 x 8 heads; at every
   distinct norm site of the CNN and the ViT, with the 16 views of each of
   256 examples folded into T (``image_mix``), ``dense_bwd_norm``,
   ``pegrad_norm`` and ``dense_dgrad`` (ragged d_in 27 and d_out 10 take
   the element-load paths, the rest TMA) and ``gram_norm`` on 4 examples;
   ``clip_reduce`` at each model's largest leaf over 256 examples;
4. small references in float32 (TF32 off): the reduced phi3 serving
   (prefill and decode logits) and one ``dpsgd_r`` fused training step
   (loss, per-example norms², clipped-sum gradients) of the reduced phi3,
   CNN and ViT (the last two at augmult 2) on the card through the
   kernels against the CPU through the plain versions;
5. the serving path: phi3-mini-3.8b at full width and depth, bf16, seeded
   random weights, serving 16 greedy requests through the contiguous engine
   and the same stream through the paged engine; outputs must agree;
6. the training path: phi3-mini-3.8b at full width with 16 of its 32
   layers, ``remat="none"``, bf16, B = 8 x T = 512 synthetic tokens,
   ``dpsgd_r`` with the fused norm route through the kernels, AdamW,
   through the port's ``Trainer``: one warm-up step and three timed steps
   (each split into its two passes by calling them directly on its batch,
   outside the counted step), then the next step through the plain norm
   rules (its norms² must agree) and one ``sgd`` step;
7. the per-site norm rules on phase 6's model and optimizer state:
   ``materialize`` + kernels at B 8 x T 512 in turns with the fused route
   (its norms² against the plain ``materialize`` rules); Poisson-sampled
   batches (expected 8 of N = 1e6, padded to a capacity of 25) through
   ``materialize``, whose padded rows must have norms² of exactly 0; and
   ``auto`` + kernels at B 2 x T 2048, where the FLOP formulas send the
   attention projections to ``pegrad_norm`` and the MLP and head to
   ``gram_norm`` (its norms² against the plain ``auto`` rules).  One
   fused, one materialize and one auto step run under ``torch.profiler``
   (``[profile]``: device busy share, the top kernels, and each of the
   port's kernels' share of the step);
8. activation checkpointing: on a fresh model of phase 6's shape, the
   norms² of one batch under ``none``, ``block`` and ``sites`` (block and
   sites held to none at ``NSQ_RTOL``), then one step under each, with its
   peak memory; then phi3-mini at full width and full depth (32 layers,
   3.822B params) under ``block``: one warm-up and three timed steps, split
   as in phase 6, one step by hand stage by stage (pass 1, pass 2, noise,
   optimizer, the peak reset before each) and one profiled step; then one
   step under ``sites``, timed and by hand;
9. the paper's comparison on a fresh 16-layer model of phase 6's shape
   and optimizer, ``remat="none"``: at σ = 0 the bf16 clipped sums of one
   batch from the same parameters through ``dpsgd_r``, ``dpsgd_r1f``
   (fused + kernels) and ``dpsgd`` (the whole batch at once,
   ``clip_reduce``) against ``dpsgd_r``'s in float32, and the last two
   against ``dpsgd_r``'s in bf16, within ``CLIP_SUM_TOL`` of each leaf's
   largest entry;
   then one warm-up and one timed step each of ``sgd``, ``dpsgd_r``,
   ``dpsgd_r1f`` and ``dpsgd`` at microbatch 1 and 8, with its peak memory
   and its step-time ratio to ``sgd``.  ``dpsgd_r1f``'s second pullback
   is ``dense_dgrad``'s path and ``dpsgd``'s clipped sum ``clip_reduce``'s;
10. chatglm3-6b at full width and full depth (28 layers, 6.24B params),
   bf16, GQA on 2 kv heads at hd 128, ``remat="block"``, ``dpsgd_r`` fused
   + kernels, ``adam8bit``, B 8 x T 512 from a memmap corpus of 2^24 int32
   tokens that the phase writes with numpy from a seed: its kernels at its
   shapes against their plain versions (the flash pair at hd 128 and rep
   16, ``dense_bwd_norm`` at every dense shape, ``gram_norm`` at the
   embedding); a warm-up and three timed steps, one by hand stage by
   stage, one profiled; then the checkpoint drill at full width and 4
   layers: two steps, an asynchronous save at step 2, step 3 while the
   write runs, a restore into a fresh Model and Trainer and step 3 again,
   whose loss, norms² and every leaf must equal the first run's bit for
   bit.  Its files live in a temporary directory under ``build/``, removed
   at the end; the full-depth run saves nothing;
11. the image families: ``cnn-cifar10`` (a 21-conv pre-activation ResNet)
   and ``vit-cifar10`` (8 non-causal layers at d_model 256, hd 32) at full
   width and depth, bf16, seeded random weights, synthetic CIFAR-shaped
   images (q = 256 / 50,000), ``dpsgd_r`` fused + kernels, 256 examples x
   augmult 16 = 4096 rows a step, adaptive clipping, ``remat="block"``,
   AdamW: for each a warm-up and three counted steps (the clip norm before
   and after each, rows/s, peak), one by hand stage by stage, one
   profiled, the norms² of one batch through the kernels against the plain
   rules; the CNN also one counted step under ``materialize`` (then four
   steps in turns with ``fused``) and one under ``gram`` (norms² against
   their plain rules); each one Poisson
   step (padded examples' norms² exactly 0) and one ``dpsgd`` step (all
   256 examples at once, ``clip_reduce``); ε composed with the clip
   mechanism and its split.  No phase steps through ``Trainer.run``,
   which checkpoints at its last step.

Each path counts the launches of every kernel from zero and must launch
each kernel exactly as often as the code says it does (``path_launches``,
by algorithm, norm route and remat policy): every kernel of the path at
least once, no other.  The line before the last
is the per-kernel JSON record; the last line is ``{"ok": true, "device":
{...}}``.
Imports nothing of JAX or of the JAX package.  Needs one card.
Measurements also go to ``chip_smoke.json`` in the output directory.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# float32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
F32_TOL = dict(rtol=2e-4, atol=2e-5)     # as tests/test_kernels.py
BF16_ATOL = 2e-2                          # bf16 vs the plain version in f32
# the main path's traffic: 16 greedy requests, prompts of 64-1024 tokens,
# 64 new tokens each, through 8 slots of a 2048-position cache
N_REQUESTS, MAX_NEW, MAX_BATCH, CACHE_LEN, BLOCK = 16, 64, 8, 2048, 16
# the training path: 16 layers, 8 examples of 512 tokens, 3 timed steps
TRAIN_LAYERS, TRAIN_B, TRAIN_T, TRAIN_STEPS = 16, 8, 512, 3
NSQ_RTOL = 2e-2     # bf16 kernel route vs plain route, per-example norms²
# bf16 attention backward vs its plain version in float32, a share of each
# output's largest entry: the tensor cores take p and ds rounded to bf16
# (check_flash_bwd prints SDPA's bf16 backward error on the same inputs
# beside the kernel's)
BWD_BF16_TOL = 5e-3
# phase 7: Poisson sampling at an expected batch of 8 (capacity 25 rows at
# N = 1e6) in one chunk; auto at 2 examples of 2048 tokens
POISSON_ACCUM = 1
AUTO_B, AUTO_T = 2, 2048
# phases 8 and 9: the remat policies, and vanilla DP-SGD one example at a
# time and the whole batch at once
REMATS = ("none", "block", "sites")
DPSGD_MICROBATCHES = (1, TRAIN_B)
# phase 9: the σ = 0 clipped sums in bf16 of dpsgd_r, dpsgd_r1f and dpsgd
# against dpsgd_r's in float32, and of the last two against dpsgd_r's in
# bf16, a share of each leaf's largest entry.  bf16 products and
# activations through 16 layers put each algorithm's sum up to 2.7-3.3e-2
# of a leaf's largest entry from float32's (phase 9 prints it), and the
# algorithms round in other places (dpsgd rounds each example's gradient
# to bf16, clip_reduce sums them in float32, dpsgd_r's backward sums the
# reweighted examples inside its bf16 products), so two of them can differ
# by up to the sum of their distances from float32
CLIP_SUM_TOL = 5e-2
# phase 11: the image families at full width and depth, train_4k's batch of
# 256 examples x augmentation multiplicity 16 (De et al. 2022's CIFAR-10
# setting), CIFAR-10's train split of N = 50,000 for q = B/N
IMAGE_ARCHS = ("cnn-cifar10", "vit-cifar10")
IMAGE_B, IMAGE_K, IMAGE_N = 256, 16, 50_000


def request_stream(vocab: int, seed: int = 0):
    """The main path's prompts, made with numpy from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = rng.integers(64, 1025, N_REQUESTS)
    return [rng.integers(0, vocab, int(n)) for n in lengths]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops, nbytes, dtype_name):
    """Least time for the work: the FLOPs over the type's peak against the
    bytes (each input read once, each output written once) over HBM
    bandwidth.  Returns (ms, "operations" | "bytes")."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flash_bound_ms(BH, T, S, hd, rep, causal, dtype_name):
    """The forward: QK^T and PV (halved when causal); q, k, v read, o and
    lse written."""
    item = 2 if dtype_name == "bfloat16" else 4
    flops = 4.0 * BH * T * S * hd * (0.5 if causal else 1.0)
    nbytes = item * (2 * BH * T * hd + 2 * (BH // rep) * S * hd) + 4 * BH * T
    return bound_ms(flops, nbytes, dtype_name)


def flash_bwd_flops(BH, T, hd, causal):
    """The backward's five products (S, dP, dV, dK, dQ; halved when
    causal), whatever the kernels recompute."""
    return 10.0 * BH * T * T * hd * (0.5 if causal else 1.0)


def flash_bwd_bound_ms(BH, KV, T, hd, causal, dtype_name):
    """q, o, do and k, v read in their type, lse read and dq, dk_h, dv_h
    written in float32 (dk/dv per query head, as the kernels write them)."""
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = (item * (3 * BH * T * hd + 2 * KV * T * hd) + 4 * BH * T
              + 4 * (BH * T * hd + 2 * KV * T * hd))
    return bound_ms(flash_bwd_flops(BH, T, hd, causal), nbytes, dtype_name)


def gram_flops(BG, T, di, do, square):
    """The s <= t tile pairs of C = gy·gyᵀ (and A = x·xᵀ when square)."""
    return 1.0 * BG * T * (T + 1) * (do + (di if square else 0))


def gram_bound_ms(BG, T, di, do, masked, square, dtype_name):
    """gy (and x when square) read in their type, int64 ids when masked,
    one float32 norm² a row written."""
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = item * BG * T * (do + (di if square else 0)) + 4 * BG \
        + (8 * BG * T if masked else 0)
    return bound_ms(gram_flops(BG, T, di, do, square), nbytes, dtype_name)


def dense_mix(arch, layers):
    """One training step's dense calls: (name, di, do, calls) for q, k, v,
    o (q and o apart from k and v under GQA); w1, w3; w2; the head over the
    padded vocab."""
    from repro_torch.models.transformer import padded_vocab
    d, f, v = arch.d_model, arch.d_ff, padded_vocab(arch.vocab)
    q, kv = arch.n_heads * arch.hd, arch.n_kv_heads * arch.hd
    assert q == d, (arch.name, q, d)
    attn = ([("qkvo", d, d, 4 * layers)] if kv == d else
            [("qo", d, d, 2 * layers), ("kv", d, kv, 2 * layers)])
    return attn + [("w1w3", d, f, 2 * layers), ("w2", f, d, layers),
                   ("head", d, v, 1)]


def image_mix(arch, K=IMAGE_K):
    """One image model's norm-site calls as dense problems, per example
    with its ``K`` views folded into T: (name, T, di, do, calls).  The
    CNN's conv2d sites (im2col: T = K x output positions, di = k·k·Cin,
    do = Cout; ``iter_conv_sites``) and its head; the ViT's patch
    embedding, its q, k, v, o, w1 and w2 (T = K x patches) and its head
    (T = K)."""
    calls = {}

    def add(name, T, di, do, n=1):
        key = (name, T, di, do)
        calls[key] = calls.get(key, 0) + n

    if arch.family == "cnn":
        from repro_torch.models.cnn import iter_conv_sites
        for label, (xs, w), gy in iter_conv_sites(arch):
            if label == "stem":
                kind = label
            elif label.endswith("proj"):
                kind = f"s{label[1]}-proj"
            else:        # the stride-2 first conv of a stage apart
                kind = f"s{label[1]}-{'w1s2' if gy[1] != xs[1] else 'conv'}"
            add(kind, K * gy[1] * gy[2], w[0] * w[1] * w[2], w[3])
        add("head", K, arch.cnn.stage_channels[-1], arch.n_classes)
    else:
        d, v = arch.d_model, arch.vit
        assert arch.n_heads * arch.hd == d == arch.n_kv_heads * arch.hd
        P = v.n_patches
        add("patch", K * P, v.patch_size ** 2 * v.in_channels, d)
        add("qkvo", K * P, d, d, 4 * arch.n_layers)
        add("w1", K * P, d, arch.d_ff, arch.n_layers)
        add("w2", K * P, arch.d_ff, d, arch.n_layers)
        add("head", K, d, arch.n_classes)
    return [(name, T, di, do, n) for (name, T, di, do), n in calls.items()]


def norm_bound_ms(BG, T, di, do, dtype_name):
    """The norm launch, ‖x_bᵀ gy_b‖² per row: 2·BG·T·di·do FLOPs; x and gy
    read, one float32 a row written."""
    item = 2 if dtype_name == "bfloat16" else 4
    return bound_ms(2.0 * BG * T * di * do, item * BG * T * (di + do) + 4 * BG,
                    dtype_name)


def dgrad_bound_ms(BG, T, di, do, E, dtype_name):
    """gx = gy · wᵀ: 2·BG·T·di·do FLOPs; gy and w read, gx written."""
    item = 2 if dtype_name == "bfloat16" else 4
    return bound_ms(2.0 * BG * T * di * do,
                    item * (BG * T * (do + di) + E * di * do), dtype_name)


def first_wave_t(prompts):
    """The first prefill wave's padded length (the engine rounds the
    longest prompt of a wave up to 16)."""
    return -(-max(len(p) for p in prompts[:MAX_BATCH]) // 16) * 16


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def _randn(g, shape, dtype):
    import torch
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def check_flash(name, B, H, KV, T, hd, causal, dtype, seed=0):
    """One shape: kernel vs plain version on the card, and timings."""
    import torch
    from repro_torch.kernels import flash_attn, ref
    rep = H // KV
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (_randn(g, (rows, T, hd), dtype) for rows in (B * H, B * KV, B * KV))
    path = flash_attn.fwd_path(q, k, v)
    o, lse = flash_attn.flash_attn_fwd(q, k, v, causal=causal, rep=rep)
    torch.cuda.synchronize()
    o_ref, lse_ref = ref.flash_attn_fwd_ref(q.float(), k.float(), v.float(),
                                            causal, rep)
    err = max((o.float() - o_ref).abs().max().item(),
              (lse - lse_ref).abs().max().item())
    if dtype == torch.float32:
        torch.testing.assert_close(o, o_ref, **F32_TOL)
        torch.testing.assert_close(lse, lse_ref, **F32_TOL)
    else:
        torch.testing.assert_close(o.float(), o_ref, rtol=0.0, atol=BF16_ATOL)
        torch.testing.assert_close(lse, lse_ref, rtol=0.0, atol=BF16_ATOL)
    ms = time_ms(lambda: flash_attn.flash_attn_fwd(q, k, v, causal=causal, rep=rep))
    plain_ms = time_ms(lambda: ref.flash_attn_fwd_ref(q, k, v, causal, rep))
    # timing only: the port never calls it
    q4, k4, v4 = q[None], k[None], v[None]
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal, enable_gqa=rep > 1))
    dt = str(dtype).split(".")[-1]
    bound_ms, bound_by = flash_bound_ms(B * H, T, T, hd, rep, causal, dt)
    tflops = 4.0 * B * H * T * T * hd * (0.5 if causal else 1.0) / ms / 1e9
    rec = dict(shape=name, dtype=dt, BH=B * H, T=T, S=T, hd=hd, rep=rep,
               causal=causal, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               path=path, tflops=tflops, bound_share=bound_ms / ms)
    print(f"[kernel] flash_attn_fwd {name} {dt}: max_abs_err {err:.3e}  "
          f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {library_ms:.4f} ms  "
          f"bound {bound_ms:.4f} ms ({bound_by})  {tflops:.1f} TFLOP/s, "
          f"{100 * bound_ms / ms:.1f}% of bound, path {path}", flush=True)
    return rec


def dense_inputs(BG, T, di, do, E, dtype, seed=0):
    """x (BG,T,di), gy (BG,T,do), w (E,di,do) in ``dtype`` on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = _randn(g, (BG, T, di), dtype)
    gy = _randn(g, (BG, T, do), dtype)
    w = _randn(g, (E, di, do), dtype) * di ** -0.5
    return x, gy, w


def check_dense_bwd_norm(name, BG, T, di, do, E, dtype, seed=0, iters=10):
    """dense_bwd_norm at one shape: kernel vs plain version (gx within 1e-4
    of its largest entry in f32, 1e-2 in bf16 — one bf16 rounding of the
    output; nsq within rtol 1e-4, since bf16 inputs convert to f32
    exactly and only the summation order differs), with timings."""
    import torch
    from repro_torch.kernels import fused_bwd, pegrad_norm, ref
    x, gy, w = dense_inputs(BG, T, di, do, E, dtype, seed)
    path = fused_bwd.dgrad_path(gy, w)
    norm_path = pegrad_norm.norm_path(x, gy)
    gx, nsq = fused_bwd.dense_bwd_norm(x, gy, w)
    torch.cuda.synchronize()
    nsq_ref = ref.dense_bwd_norm_ref(x, gy, w)[1]
    gx_f32 = ref.dense_bwd_norm_ref(x.float(), gy.float(), w.float())[0]
    abs_err = (gx.float() - gx_f32).abs().max().item()
    gx_err = abs_err / gx_f32.abs().max().item()
    nsq_err = ((nsq - nsq_ref).abs() / nsq_ref.abs()).max().item()
    assert gx_err <= (1e-4 if dtype == torch.float32 else 1e-2), (name, gx_err)
    assert nsq_err <= 1e-4, (name, nsq_err)
    del gx, gx_f32
    ms = time_ms(lambda: fused_bwd.dense_bwd_norm(x, gy, w), iters)
    plain_ms = time_ms(lambda: ref.dense_bwd_norm_ref(x, gy, w), iters)
    wt = w[0].t() if E == 1 else w[torch.arange(BG, device="cuda") % E].mT

    def library():      # timing only: the port never calls these
        torch.matmul(gy, wt)
        gb = torch.bmm(x.mT, gy)
        return (gb.float() ** 2).sum(dim=(1, 2))
    library_ms = time_ms(library, iters)
    dt = _dtype_name(dtype)
    item = x.element_size()
    b_ms, b_by = bound_ms(4.0 * BG * T * di * do,
                          item * (2 * BG * T * di + BG * T * do + E * di * do)
                          + 4 * BG, dt)
    tflops = 4.0 * BG * T * di * do / ms / 1e9
    rec = dict(shape=name, dtype=dt, BG=BG, T=T, di=di, do=do, E=E,
               max_abs_err=abs_err, gx_rel_err=gx_err, nsq_rel_err=nsq_err,
               ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
               bound_by=b_by, path=path, norm_path=norm_path, tflops=tflops,
               bound_share=b_ms / ms)
    print(f"[kernel] dense_bwd_norm {name} {dt}: gx err {abs_err:.2e} "
          f"({gx_err:.1e} of max), nsq rel err {nsq_err:.1e}  kernel {ms:.3f} "
          f"ms  plain {plain_ms:.3f} ms  library {library_ms:.3f} ms  bound "
          f"{b_ms:.4f} ms ({b_by})  {tflops:.1f} TFLOP/s, "
          f"{100 * b_ms / ms:.1f}% of bound, gx path {path}, norm path "
          f"{norm_path}", flush=True)
    return rec


def check_pegrad_norm(name, x, gy, iters=10):
    """pegrad_norm (the norm launch alone) on x (BG, T, di), gy (BG, T, do):
    within rtol 1e-4 of its plain version (bf16 inputs convert to float32
    exactly, only the summation order differs); gy with row 1 zeroed gives
    an exact 0.0 there, the other rows' bits as before, and the same bits
    again; with timings, TFLOP/s, share of the bound and the path taken.
    Returns (record, norms²)."""
    import torch
    from repro_torch.kernels import pegrad_norm, ref
    BG, T, di = x.shape
    do = gy.shape[2]
    path = pegrad_norm.norm_path(x, gy)
    nsq = pegrad_norm.pegrad_norm(x, gy)
    gz = gy.clone()
    gz[1] = 0
    za, zb = pegrad_norm.pegrad_norm(x, gz), pegrad_norm.pegrad_norm(x, gz)
    torch.cuda.synchronize()
    keep = torch.arange(BG, device="cuda") != 1
    assert za[1].item() == 0.0 and torch.equal(za[keep], nsq[keep]), name
    assert torch.equal(za, zb), name
    del gz, za, zb
    nsq_ref = ref.pegrad_norm_ref(x, gy)
    nsq_abs = (nsq - nsq_ref).abs().max().item()
    nsq_err = ((nsq - nsq_ref).abs() / nsq_ref.abs()).max().item()
    assert nsq_err <= 1e-4, (name, nsq_err)
    dt = _dtype_name(x.dtype)
    ms = time_ms(lambda: pegrad_norm.pegrad_norm(x, gy), iters)
    plain_ms = time_ms(lambda: ref.pegrad_norm_ref(x, gy), iters)
    # timing only: the port never calls it
    library_ms = time_ms(lambda: (torch.bmm(x.mT, gy).float() ** 2).sum(dim=(1, 2)),
                         iters)
    b_ms, b_by = norm_bound_ms(BG, T, di, do, dt)
    tflops = 2.0 * BG * T * di * do / ms / 1e9
    rec = dict(shape=name, dtype=dt, BG=BG, T=T, di=di, do=do,
               max_abs_err=nsq_abs, rel_err=nsq_err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by, path=path,
               tflops=tflops, bound_share=b_ms / ms)
    print(f"[kernel] pegrad_norm {name} {dt}: max_abs_err {nsq_abs:.2e} "
          f"({nsq_err:.1e} rel), zero gy row exact, repeats bit-identical  "
          f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bmm {library_ms:.3f} ms  "
          f"bound {b_ms:.4f} ms ({b_by})  {tflops:.1f} TFLOP/s, "
          f"{100 * b_ms / ms:.1f}% of bound, path {path}", flush=True)
    return rec, nsq


def check_dense_halves(name, BG, T, di, do, E, dtype, seed=0, iters=10):
    """pegrad_norm and dense_dgrad at one shape: each against its plain
    version (``check_pegrad_norm``; gx as in ``check_dense_bwd_norm``) and
    both equal to dense_bwd_norm's outputs bit for bit, with timings; then
    the fusion A/B, the separate pair (two wrapper calls) against
    dense_bwd_norm (one call), timed in turns (pair, fused, fused, pair).
    Returns {"pegrad_norm": rec, "dense_dgrad": rec, "ab": rec}."""
    import torch
    from repro_torch.kernels import fused_bwd, pegrad_norm, ref
    x, gy, w = dense_inputs(BG, T, di, do, E, dtype, seed)
    path = fused_bwd.dgrad_path(gy, w)
    pegrad, nsq = check_pegrad_norm(name, x, gy, iters)
    pegrad["E"] = E
    gx = fused_bwd.dense_dgrad(gy, w)
    fgx, fnsq = fused_bwd.dense_bwd_norm(x, gy, w)
    torch.cuda.synchronize()
    assert torch.equal(nsq, fnsq) and torch.equal(gx, fgx), name
    del fgx, fnsq
    gx_f32 = ref.dense_dgrad_ref(gy.float(), w.float())
    gx_abs = (gx.float() - gx_f32).abs().max().item()
    gx_err = gx_abs / gx_f32.abs().max().item()
    assert gx_err <= (1e-4 if dtype == torch.float32 else 1e-2), (name, gx_err)
    del gx, gx_f32
    dt = _dtype_name(dtype)
    flops = 2.0 * BG * T * di * do
    base = dict(shape=name, dtype=dt, BG=BG, T=T, di=di, do=do, E=E)
    wt = w.mT if E == 1 else w[torch.arange(BG, device="cuda") % E].mT
    b_ms, b_by = dgrad_bound_ms(BG, T, di, do, E, dt)
    dgrad = dict(base, max_abs_err=gx_abs, rel_err=gx_err,
                 ms=time_ms(lambda: fused_bwd.dense_dgrad(gy, w), iters),
                 plain_ms=time_ms(lambda: ref.dense_dgrad_ref(gy, w), iters),
                 library_ms=time_ms(lambda: torch.matmul(gy, wt), iters),
                 bound_ms=b_ms, bound_by=b_by, path=path)
    dgrad.update(tflops=flops / dgrad["ms"] / 1e9, bound_share=b_ms / dgrad["ms"])
    sep = lambda: (fused_bwd.dense_dgrad(gy, w), pegrad_norm.pegrad_norm(x, gy))
    fused = lambda: fused_bwd.dense_bwd_norm(x, gy, w)
    before = fused_bwd.DGRAD_LAUNCHES
    runs = [time_ms(sep, iters), time_ms(fused, iters), time_ms(fused, iters),
            time_ms(sep, iters)]
    sep_ms, fused_ms = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
    ab = dict(base, separate_ms=sep_ms, fused_ms=fused_ms,
              separate_over_fused=sep_ms / fused_ms, runs_ms=runs,
              dgrad_launches=fused_bwd.DGRAD_LAUNCHES - before)
    r = dgrad
    print(f"[kernel] dense_dgrad {name} {dt}: max_abs_err {r['max_abs_err']:.2e} "
          f"({r['rel_err']:.1e} rel)  kernel {r['ms']:.3f} ms  plain "
          f"{r['plain_ms']:.3f} ms  library {r['library_ms']:.3f} ms  bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']})  {r['tflops']:.1f} TFLOP/s, "
          f"{100 * r['bound_share']:.1f}% of bound, path {r['path']}", flush=True)
    print(f"[fusion] {name} {dt}: pegrad_norm and dense_dgrad = dense_bwd_norm's "
          f"outputs bit for bit; dense_dgrad + pegrad_norm {sep_ms:.3f} ms, "
          f"dense_bwd_norm {fused_ms:.3f} ms, separate / fused "
          f"{sep_ms / fused_ms:.4f} (runs {', '.join(f'{v:.3f}' for v in runs)})",
          flush=True)
    return {"pegrad_norm": pegrad, "dense_dgrad": dgrad, "ab": ab}


def check_clip_reduce(name, B, N, dtype, seed=0, iters=10):
    """clip_reduce at one shape against its plain version (float32 sums in
    another order: within 1e-5 of max|g|·Σ|c|), with timings.  Two rows get
    c_b = 0: the result must equal the reduction of the other rows, and a
    repeat, bit for bit."""
    import torch
    from repro_torch.kernels import clip_reduce, ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    grads = _randn(g, (B, N), dtype)
    c = torch.rand((B,), generator=g, device="cuda")
    c[1::4] = 0.0
    keep = c != 0
    out = clip_reduce.clip_reduce(grads, c)
    again = clip_reduce.clip_reduce(grads, c)
    compact = clip_reduce.clip_reduce(grads[keep].contiguous(), c[keep].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(out, compact), name
    del compact
    want = ref.clip_reduce_ref(grads, c)
    abs_err = (out - want).abs().max().item()
    rel = abs_err / (grads.float().abs().max().item() * c.abs().sum().item())
    assert rel <= 1e-5, (name, rel)
    del out, again, want
    before = clip_reduce.LAUNCHES
    ms = time_ms(lambda: clip_reduce.clip_reduce(grads, c), iters)
    launches = clip_reduce.LAUNCHES - before
    plain_ms = time_ms(lambda: ref.clip_reduce_ref(grads, c), iters)
    cg = c.to(dtype)
    library_ms = time_ms(lambda: torch.matmul(cg, grads), iters)   # timing only
    dt = _dtype_name(dtype)
    b_ms, b_by = bound_ms(2.0 * B * N, grads.element_size() * B * N + 4 * (B + N), dt)
    rec = dict(shape=name, dtype=dt, B=B, N=N, max_abs_err=abs_err, rel_err=rel,
               ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
               bound_by=b_by, launches=launches)
    print(f"[kernel] clip_reduce {name} {dt}: max_abs_err {abs_err:.2e} ({rel:.1e} "
          f"of max|g|·Σ|c|), zeroed rows = compacted bit for bit  kernel {ms:.3f} "
          f"ms  plain {plain_ms:.3f} ms  library {library_ms:.3f} ms  bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    return rec


def check_norm_contracts(dtype):
    """dense_bwd_norm and gram_norm at a ragged shape: all-zero gy rows give
    exact zeros (gx rows and norms²), and two launches give bit-identical
    results (no atomics)."""
    import torch
    from repro_torch.kernels import fused_bwd, gram_norm, pegrad_norm
    g = torch.Generator(device="cuda").manual_seed(7)
    x = _randn(g, (6, 333, 700), dtype)
    gy = _randn(g, (6, 333, 517), dtype)
    w = _randn(g, (3, 700, 517), dtype)
    gy[[1, 4]] = 0
    ids = torch.randint(0, 50, (6, 333), generator=g, device="cuda")
    # rows of 700 and 517 elements: TMA cannot address them
    want = "cuda-cores" if dtype == torch.float32 else "wgmma+loads"
    assert pegrad_norm.norm_path(x, gy) == want, pegrad_norm.norm_path(x, gy)
    a = fused_bwd.dense_bwd_norm(x, gy, w)
    b = fused_bwd.dense_bwd_norm(x, gy, w)
    halves = [(fused_bwd.dense_dgrad(gy, w), pegrad_norm.pegrad_norm(x, gy))
              for _ in range(2)]
    ga = gram_norm.gram_norm(gy, gy, ids, square=False)
    gb = gram_norm.gram_norm(gy, gy, ids, square=False)
    gsa = gram_norm.gram_norm(x, gy, None, square=True)
    # rows of 512: in bf16 the cp.async-fed path, where 517 and 700 take
    # element loads
    xa, gya = x[..., :512].contiguous(), gy[..., :512].contiguous()
    gaa = [gram_norm.gram_norm(xa, gya, ids, square=True) for _ in range(2)]
    torch.cuda.synchronize()
    for name, (gx, nsq) in (("dense_bwd_norm", a), ("dense_dgrad+pegrad_norm",
                                                    halves[0])):
        assert torch.all(gx[[1, 4]] == 0) and torch.all(nsq[[1, 4]] == 0), name
        assert torch.all(nsq[[0, 2, 3, 5]] > 0), name
    for p, q in ((a, b), (halves[0], halves[1]), (a, halves[0])):
        assert torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])
    assert torch.all(ga[[1, 4]] == 0) and torch.all(gsa[[1, 4]] == 0)
    assert torch.all(gaa[0][[1, 4]] == 0) and torch.all(gaa[0][[0, 2, 3, 5]] > 0)
    assert torch.equal(ga, gb) and torch.equal(gaa[0], gaa[1])
    print(f"[kernel] {_dtype_name(dtype)}: zero gy rows give exact zeros and "
          f"repeats are bit-identical (dense_bwd_norm, dense_dgrad and "
          f"pegrad_norm E=3 ragged, norm path {want}, the halves equal to the "
          f"fused kernel; "
          f"gram_norm masked and square, rows of 517/700 and of 512)", flush=True)


def flash_bwd_inputs(g, BH, KV, T, hd, causal, dtype):
    """q, k, v, do in ``dtype``, and o, lse from the plain forward."""
    from repro_torch.kernels import ref
    q, do = _randn(g, (BH, T, hd), dtype), _randn(g, (BH, T, hd), dtype)
    k, v = _randn(g, (KV, T, hd), dtype), _randn(g, (KV, T, hd), dtype)
    o, lse = ref.flash_attn_fwd_ref(q, k, v, causal, BH // KV)
    return q, k, v, o, lse, do


def check_flash_bwd(name, BH, KV, T, hd, causal, dtype, seed=0, iters=10):
    """flash_attn_bwd at one shape against its plain version: float32 grads
    within 1e-3 of each output's largest entry from float32 inputs (the
    CUDA cores, float32 throughout; p goes through exp), within
    ``BWD_BF16_TOL`` from bf16 inputs (the tensor cores take p and ds
    rounded to bf16), with SDPA's bf16 backward error against the same
    plain version beside it as the yardstick; zero do rows give exact
    zeros, repeats are bit-identical; with timings."""
    import torch
    from repro_torch.kernels import flash_attn, ref
    rep = BH // KV
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, o, lse, do = flash_bwd_inputs(g, BH, KV, T, hd, causal, dtype)
    do[:rep] = 0                   # every query head of kv head 0
    path = flash_attn.bwd_path(q, k, v, do)
    got = flash_attn.flash_attn_bwd(q, k, v, o, lse, do, causal=causal, rep=rep)
    again = flash_attn.flash_attn_bwd(q, k, v, o, lse, do, causal=causal, rep=rep)
    torch.cuda.synchronize()
    want = ref.flash_attn_bwd_ref(q, k, v, o, lse, do, causal, rep)
    abs_err = max((a - b).abs().max().item() for a, b in zip(got, want))
    rel = max(_rel_err(a, b) for a, b in zip(got, want))
    assert rel <= (1e-3 if dtype == torch.float32 else BWD_BF16_TOL), (name, rel)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), name
    assert torch.all(got[0][:rep] == 0) and torch.all(got[1][0] == 0) \
        and torch.all(got[2][0] == 0), name
    del got, again
    # timing and the yardstick only: the port never calls SDPA
    q4, k4, v4 = (t[None].detach().requires_grad_() for t in (q, k, v))
    do4 = do[None]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal, enable_gqa=rep > 1)
    sdpa_rel = None
    if dtype == torch.bfloat16:
        sg = torch.autograd.grad(sdpa(), (q4, k4, v4), do4)
        sdpa_rel = max(_rel_err(a[0], b) for a, b in zip(sg, want))
        del sg
    del want
    ms = time_ms(lambda: flash_attn.flash_attn_bwd(q, k, v, o, lse, do,
                                                   causal=causal, rep=rep), iters)
    plain_ms = time_ms(lambda: ref.flash_attn_bwd_ref(q, k, v, o, lse, do,
                                                      causal, rep), iters)
    # SDPA's backward = (forward + backward) - forward
    both_ms = time_ms(lambda: torch.autograd.grad(sdpa(), (q4, k4, v4), do4), iters)
    with torch.no_grad():
        fwd_ms = time_ms(sdpa, iters)
    library_ms = both_ms - fwd_ms
    dt = _dtype_name(dtype)
    b_ms, b_by = flash_bwd_bound_ms(BH, KV, T, hd, causal, dt)
    tflops = flash_bwd_flops(BH, T, hd, causal) / ms / 1e9
    rec = dict(shape=name, dtype=dt, BH=BH, KV=KV, T=T, hd=hd, causal=causal,
               max_abs_err=abs_err, rel_err=rel, sdpa_rel_err=sdpa_rel, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
               bound_by=b_by, tflops=tflops, bound_share=b_ms / ms, path=path)
    yard = "" if sdpa_rel is None else f", sdpa bf16 {sdpa_rel:.1e} of max"
    print(f"[kernel] flash_attn_bwd {name} {dt}: max_abs_err {abs_err:.2e} "
          f"({rel:.1e} of max{yard})  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
          f"sdpa bwd {library_ms:.3f} ms  bound {b_ms:.4f} ms ({b_by})  "
          f"{tflops:.1f} TFLOP/s, {100 * b_ms / ms:.1f}% of bound, path {path}",
          flush=True)
    return rec


def check_gram(name, BG, T, di, do, masked, square, dtype, seed=0, iters=10):
    """gram_norm at one shape, x (BG, T, di) and gy (BG, T, do) (x is gy
    when not ``square``), against its plain version (rtol 1e-4: bf16
    products are exact in float32, only the summation order differs), with
    timings."""
    import torch
    from repro_torch.kernels import gram_norm, ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    gy = _randn(g, (BG, T, do), dtype)
    x = _randn(g, (BG, T, di), dtype) if square else gy
    # a small vocab, so tokens repeat within an example
    ids = torch.randint(0, 64, (BG, T), generator=g, device="cuda") if masked else None
    path = gram_norm.gram_path(x, gy, square)
    out = gram_norm.gram_norm(x, gy, ids, square=square)
    torch.cuda.synchronize()
    want = ref.gram_norm_ref(x, gy, ids, square)
    abs_err = (out - want).abs().max().item()
    rel = (abs_err / want.abs().max()).item()
    assert rel <= 1e-4, (name, rel)
    ms = time_ms(lambda: gram_norm.gram_norm(x, gy, ids, square=square), iters)
    plain_ms = time_ms(lambda: ref.gram_norm_ref(x, gy, ids, square), iters)
    mask = None if ids is None else (ids[:, :, None] == ids[:, None, :])

    def library():      # timing only
        c = torch.bmm(gy, gy.mT).float()
        if square:
            c = c * torch.bmm(x, x.mT).float()
        if mask is not None:
            c = c * mask
        return c.sum(dim=(1, 2))
    library_ms = time_ms(library, iters)
    dt = _dtype_name(dtype)
    b_ms, b_by = gram_bound_ms(BG, T, di, do, masked, square, dt)
    tflops = gram_flops(BG, T, di, do, square) / ms / 1e9
    rec = dict(shape=name, dtype=dt, BG=BG, T=T, di=di, do=do, masked=masked,
               square=square, max_abs_err=abs_err, rel_err=rel, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
               bound_by=b_by, tflops=tflops, bound_share=b_ms / ms, path=path)
    print(f"[kernel] gram_norm {name} {dt}: max_abs_err {abs_err:.2e} "
          f"({rel:.1e} of max)  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
          f"library {library_ms:.3f} ms  bound {b_ms:.4f} ms ({b_by})  "
          f"{tflops:.1f} TFLOP/s, {100 * b_ms / ms:.1f}% of bound, path {path}",
          flush=True)
    return rec


# the bf16 tensor-core kernels (mangled-name pieces) and which of them the
# main paths run: the dgrad kernel (dense_dgrad and dense_bwd_norm's gx
# launch), the norm kernel (pegrad_norm and dense_bwd_norm's norm launch),
# the flash forward and backward at phi3's, chatglm3's and the ViT's head
# widths, gram_norm
TENSOR_CORE_KERNELS = {"dense_dgrad": ["tc12dgrad_kernel"],
                       "dense_bwd_norm": ["tc12dgrad_kernel", "tc11norm_kernel"],
                       "pegrad_norm": ["tc11norm_kernel"],
                       "flash_attn_fwd": ["mma16flash_fwd_kernel"],
                       "flash_attn_bwd": ["mma13bwd_kv_kernel", "mma12bwd_q_kernel"],
                       "gram_norm": ["mma11gram_kernel"]}
MAIN_PATH_KERNELS = ("tc12dgrad_kernel", "tc11norm_kernel", "mma16flash_fwd_kernelILi96E",
                     "mma13bwd_kv_kernelILi96E", "mma12bwd_q_kernelILi96E",
                     "mma16flash_fwd_kernelILi128E", "mma13bwd_kv_kernelILi128E",
                     "mma12bwd_q_kernelILi128E", "mma11gram_kernel",
                     # the ViT's head width (phase 11)
                     "mma16flash_fwd_kernelILi32E", "mma13bwd_kv_kernelILi32E",
                     "mma12bwd_q_kernelILi32E")


def ptxas_report(log: str):
    """Per kernel function in a ``-Xptxas -v`` log: its mangled name,
    registers, and spill stores and loads in bytes."""
    import re
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            if cur is None or cur["function"] != m.group(1):
                cur = {"function": m.group(1), "registers": None,
                       "spill_stores": None, "spill_loads": None}
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def tensor_core_ptxas():
    """Print ``-Xptxas -v``'s registers and spills of every bf16
    tensor-core instantiation; fail if a main-path one spills."""
    from repro_torch.kernels import build
    seen = set()
    for src, pieces in TENSOR_CORE_KERNELS.items():
        for r in ptxas_report(build.ptxas_log(src)):
            if not any(p in r["function"] for p in pieces):
                continue
            main = any(p in r["function"] for p in MAIN_PATH_KERNELS)
            print(f"[ptxas] {src}: {r['function']}: {r['registers']} registers, "
                  f"spill stores {r['spill_stores']} B, spill loads "
                  f"{r['spill_loads']} B{' (main path)' if main else ''}", flush=True)
            if main:
                assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (src, r)
                seen.update(p for p in MAIN_PATH_KERNELS if p in r["function"])
    assert seen == set(MAIN_PATH_KERNELS), ("no ptxas report for", seen)


def small_reference(device_b: str = "cuda"):
    """Reduced phi3 in float32: logits on ``device_b`` (the kernel path on
    the card) against the CPU (plain path), same weights."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.transformer import Model
    arch = reduced(get_arch("phi3-mini-3.8b"))
    a = Model(arch, dtype=torch.float32, device="cpu", seed=0)
    b = Model(arch, a.params, dtype=torch.float32, device=device_b)
    toks = torch.randint(0, arch.vocab, (3, 70), generator=torch.Generator().manual_seed(0))
    lengths = torch.tensor([70, 41, 9])
    la, ca = a.prefill(toks, 80, lengths)
    lb, cb = b.prefill(toks.to(device_b), 80, lengths.to(device_b))
    worst = (lb.cpu() - la).abs().max().item()
    torch.testing.assert_close(lb.cpu(), la, rtol=1e-4, atol=1e-4)
    pos = lengths.clone()
    for _ in range(3):
        nxt = la[:, 0, :arch.vocab].argmax(-1)[:, None]
        la, ca = a.decode_step(ca, nxt, pos)
        lb, cb = b.decode_step(cb, nxt.to(device_b), pos.to(device_b))
        worst = max(worst, (lb.cpu() - la).abs().max().item())
        torch.testing.assert_close(lb.cpu(), la, rtol=1e-4, atol=1e-4)
        pos = pos + 1
    print(f"[reference] reduced phi3 f32 prefill + 3 decode steps, {device_b} "
          f"vs cpu: max |dlogits| {worst:.3e} (rtol/atol 1e-4)", flush=True)


def kernel_counts():
    """Launch counts of every kernel wrapper: name -> (module, attribute)."""
    from repro_torch.kernels import (clip_reduce, flash_attn, fused_bwd,
                                     gram_norm, pegrad_norm)
    return {"flash_attn_fwd": (flash_attn, "LAUNCHES"),
            "flash_attn_bwd": (flash_attn, "BWD_LAUNCHES"),
            "dense_bwd_norm": (fused_bwd, "LAUNCHES"),
            "gram_norm": (gram_norm, "LAUNCHES"),
            "pegrad_norm": (pegrad_norm, "LAUNCHES"),
            "dense_dgrad": (fused_bwd, "DGRAD_LAUNCHES"),
            "clip_reduce": (clip_reduce, "LAUNCHES")}


def launch_shape(arch):
    """``path_launches``'s keywords for ``arch``'s family: the dense
    decoder's layer count, or the image family and, for the CNN, its
    conv2d sites."""
    if arch.family == "cnn":
        from repro_torch.models.cnn import iter_conv_sites
        return dict(L=0, family="cnn", convs=len(list(iter_conv_sites(arch))))
    return dict(L=arch.n_layers, family=arch.family)


def path_launches(route: str, L: int, chunks: int = 1, algo: str = "dpsgd_r",
                  remat: str = "none", examples: int = 0, microbatch: int = 0,
                  leaves: int = 0, family: str = "dense", convs: int = 0):
    """Launches of every kernel in one step of ``algo``, as the code makes
    them.  The dense decoder with ``L`` layers: each layer has 7 dense
    sites (q, k, v, o, w1, w3, w2) and one attention, the model one head
    and one embedding.  The ViT (``family="vit"``, ``L`` layers): 6 dense
    sites a layer (q, k, v, o, w1, w2) and one non-causal attention, the
    patch embedding (a conv2d site) and the head.  The CNN
    (``family="cnn"``): ``convs`` conv2d sites (the stem first) and the
    head, no attention.  A norm site is a dense or conv2d site; the
    embedding's norm is one ``gram_norm``.

    ``dpsgd_r`` runs two forwards and two backwards, ``dpsgd_r1f`` one
    forward and two backwards (pullbacks), each with the flash forward and
    backward at every attention.  A norm-mode backward under ``fused`` runs
    the attention site's forward once more (once in ``dpsgd_r``'s pass 1,
    in both of ``dpsgd_r1f``'s pullbacks); its norm sites take
    ``dense_bwd_norm``, and ``dpsgd_r1f``'s second pullback takes
    ``dense_dgrad`` at each of them whose input needs a gradient (not the
    image models' first site, whose input is the images).
    ``materialize`` takes ``pegrad_norm`` at every norm site, ``gram``
    ``gram_norm``; ``auto`` is the decoder at T 2048, where the FLOP
    formulas send q, k, v, o to ``pegrad_norm`` and w1, w3, w2 and the
    head to ``gram_norm``.  ``sgd`` is one forward and one backward;
    ``dpsgd`` one of each per example (``examples`` of them), and one
    ``clip_reduce`` per parameter leaf (``leaves``) per chunk of
    ``microbatch`` examples (0 = all).  Under ``block`` and ``sites`` every
    backward recomputes every block's forward once more, so its flash
    forwards.  ``chunks``: grad_accum, every chunk a full step's worth."""
    n = dict.fromkeys(kernel_counts(), 0)
    if family == "dense":
        sites, dgrads, attn, embeds = 7 * L + 1, 7 * L + 1, L, 1
    elif family == "vit":
        sites, dgrads, attn, embeds = 6 * L + 2, 6 * L + 1, L, 0
    elif family == "cnn":
        sites, dgrads, attn, embeds = convs + 1, convs, 0, 0
    else:
        raise ValueError(family)
    again = 0 if remat == "none" else attn    # the recompute, per backward
    if algo == "sgd":
        n.update(flash_attn_fwd=attn + again, flash_attn_bwd=attn)
    elif algo == "dpsgd":
        n.update(flash_attn_fwd=examples * (attn + again),
                 flash_attn_bwd=examples * attn,
                 clip_reduce=leaves * (examples // (microbatch or examples)))
    elif algo in ("dpsgd_r", "dpsgd_r1f"):
        forwards, norm_pulls = (2, 1) if algo == "dpsgd_r" else (1, 2)
        n.update(flash_attn_fwd=forwards * attn + 2 * again,
                 flash_attn_bwd=2 * attn, gram_norm=embeds)
        if route == "fused":
            n["flash_attn_fwd"] += norm_pulls * attn
            n["dense_bwd_norm"] = sites
            if algo == "dpsgd_r1f":
                n["dense_dgrad"] = dgrads
        elif route == "materialize":
            n.update(pegrad_norm=sites)
        elif route == "gram":
            n["gram_norm"] += sites
        elif route == "auto-2048" and family == "dense":
            n.update(pegrad_norm=4 * L, gram_norm=3 * L + 2)
        else:
            raise ValueError(route)
    else:
        raise ValueError(algo)
    return {k: v * chunks for k, v in n.items()}


def zero_counts():
    for mod, attr in kernel_counts().values():
        setattr(mod, attr, 0)


def read_counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in kernel_counts().items()}


def train_reference(name: str = "phi3-mini-3.8b", augmult: int = 1):
    """A reduced model in float32: one dpsgd_r fused clipped sum (the step
    before its noise) on the card through the kernels against the CPU
    through the plain versions, same weights and batch (tokens for the
    decoder; for an image model seeded images, ``augmult`` views each).
    Losses and norms² at rtol 1e-4, gradients within 1e-4 of each leaf's
    largest entry (float32, other summation order)."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import DPConfig
    from repro_torch.core import algo
    from repro_torch.data.pipeline import augment_expand
    from repro_torch.models import build_model_for
    arch = reduced(get_arch(name))
    a = build_model_for(arch, dtype=torch.float32, device="cpu", seed=0,
                        remat="none")
    b = build_model_for(arch, a.params, dtype=torch.float32, device="cuda",
                        remat="none")
    if arch.family in ("cnn", "vit"):
        rng = np.random.default_rng(1)
        batch = augment_expand(
            {"images": rng.standard_normal((4,) + arch.image_shape(),
                                           dtype=np.float32),
             "labels": rng.integers(0, arch.n_classes, 4).astype(np.int32)},
            augmult, seed=0, step=0)
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    else:
        batch = {"tokens": torch.randint(0, arch.vocab, (4, 65),
                                         generator=torch.Generator().manual_seed(1))}
    dp = DPConfig(algo="dpsgd_r", norm_strategy="fused", use_kernels=True,
                  augmult=augmult)
    out = {}
    zero_counts()
    for m, dev in ((a, "cpu"), (b, "cuda")):
        m.requires_grad_(True)
        fn = algo.make_clipped_sum_fn(m.loss_fn, dp)
        out[dev] = fn(m.params, {k: v.to(dev) for k, v in batch.items()})
    counts = read_counts()
    assert counts == path_launches("fused", **launch_shape(arch)), counts
    (ga, (la, na)), (gb, (lb, nb)) = out["cpu"], out["cuda"]
    torch.testing.assert_close(lb.cpu(), la, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(nb.cpu(), na, rtol=1e-4, atol=0.0)
    worst = 0.0
    for x, y in zip(gb, ga):
        err = _rel_err(x.cpu(), y)
        worst = max(worst, err)
        assert err <= 1e-4, err
    assert len(ga) == len(tree.leaves(a.params))
    print(f"[reference] reduced {name} f32 dpsgd_r fused step (augmult "
          f"{augmult}), cuda (kernels) vs cpu (plain): losses and norms² within "
          f"rtol 1e-4, grads within {worst:.1e} of max (limit 1e-4); launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)


def serve(model, prompts, max_new, paged):
    """Serve ``prompts`` greedily; returns (outputs, engine, seconds,
    {"prefill": s, "decode": s}): time inside prefill waves and decode
    chunks, each synchronised at its ends (one sync per wave or chunk)."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import Request
    eng = Engine(model, max_batch=MAX_BATCH, cache_len=CACHE_LEN, paged=paged,
                 block_size=BLOCK, record_ttft=True)
    spent = {"prefill": 0.0, "decode": 0.0}

    def timed(key, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(*args, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
        return run

    eng._prefill_wave = timed("prefill", eng._prefill_wave)
    eng._decode_chunk = timed("decode", eng._decode_chunk)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p.astype(np.int32), max_new=max_new))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    return out, eng, time.perf_counter() - t0, spent


def decode_breakdown(model, B=MAX_BATCH, S=CACHE_LEN, block_size=BLOCK):
    """Device time of one layer's decode pieces at the main path's cache
    shape (B slots, S positions, half full): attention against the
    contiguous cache, attention through block tables, the MLP; and the LM
    head once."""
    import torch
    from repro_torch.core.context import DPContext
    from repro_torch.models import layers as L
    arch = model.arch
    p = {k: ({n: w[0] for n, w in v.items()} if isinstance(v, dict) else v[0])
         for k, v in model.params["blocks"][0].items()}      # layer 0
    h = torch.randn((B, 1, arch.d_model), device="cuda").to(model.dtype)
    pos = torch.full((B,), S // 2, dtype=torch.int64, device="cuda")
    kv = tuple(torch.randn((B, S, arch.n_kv_heads, arch.hd), device="cuda")
               .to(model.dtype) for _ in range(2))
    nb = B * S // block_size
    pool = tuple(a.reshape(nb, block_size, arch.n_kv_heads, arch.hd) for a in kv)
    tables = torch.arange(nb, device="cuda").reshape(B, S // block_size)
    ms = {
        "attn_contiguous": time_ms(lambda: L.attn_decode(p["attn"], h, kv, pos, arch)),
        "attn_paged": time_ms(lambda: L.attn_decode_paged(p["attn"], h, pool,
                                                          tables, pos, arch)),
        "mlp": time_ms(lambda: L.mlp_apply(p["mlp"], h, DPContext.off(), arch)),
        "head": time_ms(lambda: h @ model.params["head"]),
    }
    n = arch.n_layers
    print(f"[main] one layer's decode at B={B}, S={S}: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f"; x{n} layers: attention {n * ms['attn_contiguous']:.1f} ms "
          f"(contiguous) / {n * ms['attn_paged']:.1f} ms (paged), mlp "
          f"{n * ms['mlp']:.1f} ms per step", flush=True)
    return ms


def main_path(arch, prompts):
    """Serve ``prompts`` on ``arch`` at full size, bf16, seeded weights,
    through the contiguous and then the paged engine."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attn
    from repro_torch.models.transformer import Model
    t = time.perf_counter()
    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    print(f"[main] {arch.name}: {arch.n_layers} layers, d_model {arch.d_model}, "
          f"{arch.n_heads} heads x hd {arch.hd}, d_ff {arch.d_ff}, vocab "
          f"{arch.vocab}; {n_par / 1e9:.3f}B params bf16, init "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    # warm-up (cuBLAS handles, allocator), outside the counted runs
    serve(model, prompts[:2], 2, paged=False)
    gc.collect()                      # the warm-up engine's reference cycle
    n_attn = arch.n_layers
    runs, launches = {}, 0
    for paged in (False, True):
        flash_attn.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        out, eng, dt, spent = serve(model, prompts, MAX_NEW, paged)
        n_launch = flash_attn.LAUNCHES
        launches += n_launch
        waves = eng.stats["prefill_waves"]
        kind = "paged" if paged else "contiguous"
        assert sorted(out) == list(range(len(prompts))), kind
        for uid, toks in out.items():
            assert len(toks) == MAX_NEW, (kind, uid, len(toks))
            assert all(0 <= x < arch.vocab for x in toks), (kind, uid)
        assert n_launch >= n_attn * waves, (kind, n_launch, waves)
        n_tok = sum(len(v) for v in out.values())
        steps = eng.stats["decode_steps"]
        rec = dict(engine=kind, requests=len(prompts), tokens=n_tok,
                   seconds=dt, tok_per_s=n_tok / dt,
                   mean_ttft_ms=1e3 * float(np.mean(list(eng.ttft.values()))),
                   decode_ms_per_step=1e3 * spent["decode"] / max(steps, 1),
                   prefill_ms_per_wave=1e3 * spent["prefill"] / max(waves, 1),
                   decode_steps=steps, prefill_waves=waves,
                   flash_launches=n_launch,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   prompt_tokens=sum(len(p) for p in prompts))
        runs[kind] = (out, rec)
        print(f"[main] {kind}: {n_tok} tokens in {dt:.2f} s ({rec['tok_per_s']:.1f} "
              f"tok/s), mean TTFT {rec['mean_ttft_ms']:.1f} ms, decode "
              f"{rec['decode_ms_per_step']:.2f} ms/step over {steps} steps, "
              f"{waves} prefill waves of {rec['prefill_ms_per_wave']:.1f} ms, "
              f"flash launches {n_launch}, peak "
              f"{rec['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
        # serve() wraps the engine's methods in closures that refer back to
        # it: a reference cycle, freed only by the cyclic collector
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    assert runs["paged"][0] == runs["contiguous"][0], \
        "paged greedy outputs differ from the contiguous engine's"
    print("[main] paged greedy outputs equal the contiguous engine's", flush=True)
    breakdown = decode_breakdown(model)
    return [rec for _, rec in runs.values()], launches, breakdown


# the port's kernels as the profiler names them (substrings of the device
# function names), for each one's share of a profiled step
PROFILE_KERNELS = {"flash_attn_fwd": ("flash_fwd_kernel",),
                   "flash_attn_bwd": ("bwd_kv_kernel", "bwd_q_kernel"),
                   "gram_norm": ("gram_kernel",),
                   "norm launch": ("norm_kernel",),
                   "gx launch": ("dgrad_kernel",)}


def profile_step(run, label):
    """One more training step under ``torch.profiler``: the device time of
    every kernel by name, each of the port's kernels' share of the step's
    wall time (``PROFILE_KERNELS``), and the device's busy share (busy =
    the union of kernel intervals on the timeline)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rec = run()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.end > e.time_range.start]
    if not kernels:
        print("[profile] the profiler recorded no device activity: device "
              "time and idle share not measured", flush=True)
        return dict(step_ms=rec["step_ms"], device_busy_ms=None)
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy = (busy + hi - lo) / 1e3                         # us -> ms
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                      - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ours = {k: sum(ms for nm, ms in by_name.items() if any(p in nm for p in pieces))
            for k, pieces in PROFILE_KERNELS.items()}
    print(f"[profile] one dpsgd_r {label} step under torch.profiler: "
          f"{rec['step_ms']:.1f} ms wall, device busy {busy:.1f} ms "
          f"({100 * busy / rec['step_ms']:.1f}%), {len(kernels)} kernel "
          f"launches", flush=True)
    for nm, ms in top:
        print(f"[profile]   {ms:9.2f} ms  {nm[:100]}", flush=True)
    print("[profile]   the port's kernels: " + ", ".join(
        f"{k} {ms:.2f} ms ({100 * ms / rec['step_ms']:.1f}%)" for k, ms in ours.items()),
        flush=True)
    return dict(step_ms=rec["step_ms"], device_busy_ms=busy,
                n_kernels=len(kernels), top_ms=top, kernels_ms=ours)


def timed_step(trainer, state):
    """One Trainer step on ``state`` (``Trainer.train_step`` on its batch
    and the metrics read back), synced at both ends, with the record
    ``Trainer.run`` keeps; the batch is made before the clock starts, as
    ``Trainer.run`` makes it; not through ``run``, which checkpoints at its
    last step."""
    import torch
    step = state.step
    batch = trainer.make_batch(step)          # on the host, as Trainer.run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = {k: float(v) for k, v in trainer.train_step(state, batch).items()}
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    rec.update(step=step, sec=ms / 1e3,
               epsilon=trainer.accountant.epsilon_at(step + 1))
    trainer.history.append(rec)
    out = dict(step_ms=ms, loss=rec["loss"], realized_batch=rec["realized_batch"])
    for k in ("clip_norm", "clip_norm_next", "clip_frac_below"):
        if k in rec:
            out[k] = rec[k]
    return out


def split_passes(model, state, dp, batch, clip=None):
    """The two passes of one dpsgd_r step on ``batch`` (masked or not, K
    views an example), called directly and synced at each end: (norms²,
    per-row losses, pass 1 ms, pass 2 ms).  ``clip``: the step's clip norm
    (default ``dp.clip_norm``)."""
    import torch
    from repro_torch.core import algo, clipping
    data, mask = algo.split_mask(batch)
    K = max(1, dp.augmult)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nsq, losses = algo.norm_pass(model.loss_fn, state.params, data, dp, mask)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    c = clipping.clip_factors(nsq, dp.clip_norm if clip is None else clip)
    if mask is not None:
        c = c * algo._example_mask(mask, K)
    grads = algo.reweighted_grads(model.loss_fn, state.params, data,
                                  algo._expand_rows(c, K))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads
    return nsq, losses, 1e3 * (t1 - t0), 1e3 * (t2 - t1)


def counted_step(trainer, model, state, route, chunks=1):
    """One timed Trainer step with every kernel count from zero, checked
    against ``path_launches`` (at the trainer's algorithm, the model's
    family and remat policy); then its two passes again on its batch, at
    the clip norm the step used, outside the counted step, for the split.
    Returns the step's record and the split's norms² and losses."""
    batch = trainer.make_batch(state.step)
    clip = trainer.clip_norm(state)
    clip = None if clip is None else clip.clone()
    import torch
    zero_counts()
    rec = timed_step(trainer, state)
    # the peak since the caller's last reset, up to the end of the step
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    counts = read_counts()
    want = path_launches(route, chunks=chunks, algo=trainer.cfg.dp.algo,
                         remat=model.remat, **launch_shape(model.arch))
    assert counts == want, (route, model.remat, counts, want)
    nsq, losses, rec["pass1_ms"], rec["pass2_ms"] = split_passes(
        model, state, trainer.cfg.dp, batch, clip)
    rec["noise_opt_ms"] = rec["step_ms"] - rec["pass1_ms"] - rec["pass2_ms"]
    rec["launches"] = counts
    return rec, batch, nsq, losses


def train_shape_and_config(arch, remat):
    """The training paths' shape (B 8 x T 512) and config: ``dpsgd_r``
    with the fused route through the kernels, C 1, σ 1, δ 1e-5, AdamW at
    lr 1e-4, under ``remat``; checkpoints under the checkout's ``build/``
    (no phase writes one: ``timed_step`` does not go through
    ``Trainer.run``)."""
    from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                          TrainConfig)
    shape = ShapeConfig("chip_smoke", TRAIN_T, TRAIN_B, "train")
    cfg = TrainConfig(arch=arch.name, steps=1 + TRAIN_STEPS, log_every=1,
                      remat=remat, ckpt_dir=str(ROOT / "build" / "chip_smoke_ckpt"),
                      dp=DPConfig(algo="dpsgd_r", norm_strategy="fused",
                                  use_kernels=True, clip_norm=1.0,
                                  noise_multiplier=1.0, delta=1e-5),
                      optim=OptimConfig(name="adamw", lr=1e-4,
                                        schedule="constant"))
    return shape, cfg


def train_main_path():
    """The training path (see the module docstring, phase 6).  Returns its
    record, the model and the state, which phase 7 goes on with."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    arch = dataclasses.replace(get_arch("phi3-mini-3.8b"), n_layers=TRAIN_LAYERS)
    shape, cfg = train_shape_and_config(arch, "none")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0,
                  remat="none")
    trainer = Trainer(model, cfg, shape)
    state = trainer.init_state()
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    print(f"[train] {arch.name} at full width, {arch.n_layers} layers: "
          f"{n_par / 1e9:.3f}B params bf16 + AdamW f32 state, init "
          f"{time.perf_counter() - t:.1f} s; batch {TRAIN_B} x {TRAIN_T}",
          flush=True)

    timed_step(trainer, state)                 # warm-up (allocator, cuBLAS)
    steps = []
    for _ in range(TRAIN_STEPS):
        rec, *_ = counted_step(trainer, model, state, "fused")
        steps.append(rec)
        print(f"[train] dpsgd_r fused+kernels step {state.step - 1}: loss "
              f"{rec['loss']:.4f}; {rec['step_ms']:.1f} ms = pass 1 "
              f"{rec['pass1_ms']:.1f} + pass 2 {rec['pass2_ms']:.1f} + noise "
              f"and optimizer {rec['noise_opt_ms']:.1f}; launches "
              f"{rec['launches']}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    eps = trainer.accountant.epsilon_at(state.step)
    losses = [r["loss"] for r in steps]
    assert all(math.isfinite(x) for x in losses), losses
    print(f"[train] peak memory {peak / 2**30:.2f} GiB; after {state.step} "
          f"steps eps = {eps:.4f} (delta {cfg.dp.delta}, q "
          f"{trainer.sample_rate:.1e}, sigma {cfg.dp.noise_multiplier})",
          flush=True)

    prof = profile_step(lambda: timed_step(trainer, state), "fused+kernels")

    # the next step's norms² through the kernels and through the plain norm
    # rules on the card, same params and batch; then that step, plain
    batch = trainer.make_batch(state.step)
    plain_dp = dataclasses.replace(cfg.dp, use_kernels=False)
    nsq_k, *_ = split_passes(model, state, cfg.dp, batch)
    nsq_p, _, p1, p2 = split_passes(model, state, plain_dp, batch)
    plain = Trainer(model, dataclasses.replace(cfg, dp=plain_dp), shape)
    plain_rec = dict(timed_step(plain, state), pass1_ms=p1, pass2_ms=p2)
    nsq_err = ((nsq_k - nsq_p).abs() / nsq_p.abs()).max().item()
    assert nsq_err <= NSQ_RTOL, nsq_err
    print(f"[train] plain norm rules on the card: step {plain_rec['step_ms']:.1f}"
          f" ms (pass 1 {p1:.1f}); per-example norms² vs the kernel route: max "
          f"rel err {nsq_err:.2e} (limit {NSQ_RTOL}); kernel-route norms "
          f"{nsq_k.sqrt().tolist()}", flush=True)

    sgd = Trainer(model, dataclasses.replace(
        cfg, dp=dataclasses.replace(cfg.dp, algo="sgd")), shape)
    sgd_rec = timed_step(sgd, state)
    assert math.isfinite(sgd_rec["loss"]), sgd_rec
    dp_ms = float(np.mean([r["step_ms"] for r in steps]))
    ratio = dp_ms / sgd_rec["step_ms"]
    print(f"[train] sgd step {sgd_rec['step_ms']:.1f} ms; DP-SGD(R) / SGD "
          f"step time {ratio:.2f}x", flush=True)
    launches = {k: sum(r["launches"][k] for r in steps) for k in steps[0]["launches"]}
    rec = dict(arch=arch.name, n_layers=arch.n_layers, params=n_par,
               batch=TRAIN_B, seq=TRAIN_T, steps=steps, peak_bytes=peak,
               epsilon=eps, plain=plain_rec, nsq_rel_err=nsq_err, sgd=sgd_rec,
               dp_over_sgd=ratio, launches=launches, profile=prof)
    return rec, model, trainer, state


def train_norm_routes(model, fused_trainer, state):
    """Phase 7 (see the module docstring) on phase 6's model and state."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.accountant import PrivacyAccountant
    from repro_torch.train import Trainer
    base = fused_trainer.cfg
    shape = fused_trainer.shape

    def trainer_for(shape_, **dp):
        return Trainer(model, dataclasses.replace(
            base, dp=dataclasses.replace(base.dp, **dp)), shape_)

    out, launches = {}, dict.fromkeys(kernel_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # 1. materialize beside fused, in turns (mat, fused, fused, mat)
    mat = trainer_for(shape, norm_strategy="materialize")
    torch.cuda.reset_peak_memory_stats()
    timed_step(mat, state)                     # warm-up: new cuBLAS shapes
    recs = {"materialize": [], "fused": []}
    for route in ("materialize", "fused", "fused", "materialize"):
        tr = mat if route == "materialize" else fused_trainer
        rec, *_ = counted_step(tr, model, state, route)
        recs[route].append(rec)
        add(rec["launches"])
        print(f"[route] dpsgd_r {route}+kernels step {state.step - 1}: loss "
              f"{rec['loss']:.4f}; {rec['step_ms']:.1f} ms = pass 1 "
              f"{rec['pass1_ms']:.1f} + pass 2 {rec['pass2_ms']:.1f} + noise "
              f"and optimizer {rec['noise_opt_ms']:.1f}; launches "
              f"{ {k: v for k, v in rec['launches'].items() if v} }", flush=True)
    peak = torch.cuda.max_memory_allocated()
    batch = mat.make_batch(state.step)
    plain_dp = dataclasses.replace(mat.cfg.dp, use_kernels=False)
    nsq_k, *_ = split_passes(model, state, mat.cfg.dp, batch)
    nsq_p, _, p1, _ = split_passes(model, state, plain_dp, batch)
    nsq_err = ((nsq_k - nsq_p).abs() / nsq_p.abs()).max().item()
    assert nsq_err <= NSQ_RTOL, nsq_err
    mean = {r: float(np.mean([x["step_ms"] for x in v])) for r, v in recs.items()}
    print(f"[route] materialize {mean['materialize']:.1f} ms vs fused "
          f"{mean['fused']:.1f} ms a step (means of 2, in turns; "
          f"materialize / fused {mean['materialize'] / mean['fused']:.3f}); "
          f"norms² vs the plain materialize rules: max rel err {nsq_err:.2e} "
          f"(limit {NSQ_RTOL}); plain pass 1 {p1:.1f} ms; peak "
          f"{peak / 2**30:.2f} GiB", flush=True)
    prof = profile_step(lambda: timed_step(mat, state), "materialize+kernels")
    out["materialize"] = dict(steps=recs, mean_step_ms=mean, nsq_rel_err=nsq_err,
                              plain_pass1_ms=p1, peak_bytes=peak, profile=prof)

    # 2. Poisson-sampled batches through materialize
    poisson = Trainer(model, dataclasses.replace(
        base, grad_accum=POISSON_ACCUM, dp=dataclasses.replace(
            base.dp, norm_strategy="materialize", sampling="poisson")), shape)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timed_step(poisson, state)                 # warm-up at the capacity
    precs = []
    for _ in range(2):
        rec, batch, nsq, losses = counted_step(poisson, model, state,
                                               "materialize", POISSON_ACCUM)
        add(rec["launches"])
        mask = batch["mask"]
        real = int(mask.sum())
        assert rec["realized_batch"] == real, (rec["realized_batch"], real)
        assert bool(torch.all(nsq[~mask] == 0.0)), nsq
        assert bool(torch.all(nsq[mask] > 0.0)), nsq
        assert bool(torch.all(torch.isfinite(losses))) and math.isfinite(rec["loss"])
        rec["nsq_real"] = nsq[mask].tolist()
        precs.append(rec)
        print(f"[poisson] step {state.step - 1}: realized batch {real} of "
              f"capacity {poisson.capacity}; padded rows' norms² all exactly "
              f"0.0; loss {rec['loss']:.4f}; {rec['step_ms']:.1f} ms = pass 1 "
              f"{rec['pass1_ms']:.1f} + pass 2 {rec['pass2_ms']:.1f} + noise "
              f"and optimizer {rec['noise_opt_ms']:.1f}", flush=True)
    ppeak = torch.cuda.max_memory_allocated()
    # the run's epsilon at its step count, priced at q = B/N by the
    # accountant (the Poisson steps continue phase 6's step count)
    last = poisson.history[-1]
    eps = last["epsilon"]
    assert math.isfinite(eps) and eps > 0 and eps == PrivacyAccountant(
        batch_size=shape.global_batch, dataset_size=poisson.source.dataset_size,
        noise_multiplier=base.dp.noise_multiplier,
        delta=base.dp.delta).epsilon_at(last["step"] + 1), eps
    print(f"[poisson] q {poisson.sample_rate:.1e}, capacity {poisson.capacity}, "
          f"grad_accum {POISSON_ACCUM}; eps after {last['step'] + 1} steps "
          f"{eps:.6f} (delta {base.dp.delta}, sigma {base.dp.noise_multiplier}); "
          f"peak {ppeak / 2**30:.2f} GiB", flush=True)
    out["poisson"] = dict(steps=precs, capacity=poisson.capacity,
                          grad_accum=POISSON_ACCUM, epsilon=eps, peak_bytes=ppeak)

    # 3. auto at T 2048: q/k/v/o through pegrad_norm, MLP and head through
    # gram_norm
    ashape = ShapeConfig("chip_smoke_2k", AUTO_T, AUTO_B, "train")
    auto = trainer_for(ashape, norm_strategy="auto")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timed_step(auto, state)                    # warm-up
    rec, batch, _, _ = counted_step(auto, model, state, "auto-2048")
    add(rec["launches"])
    apeak = torch.cuda.max_memory_allocated()
    batch = auto.make_batch(state.step)
    nsq_k, *_ = split_passes(model, state, auto.cfg.dp, batch)
    nsq_p, _, p1, _ = split_passes(model, state, dataclasses.replace(
        auto.cfg.dp, use_kernels=False), batch)
    aerr = ((nsq_k - nsq_p).abs() / nsq_p.abs()).max().item()
    assert aerr <= NSQ_RTOL, aerr
    print(f"[route] dpsgd_r auto+kernels at B {AUTO_B} x T {AUTO_T}: "
          f"{rec['step_ms']:.1f} ms = pass 1 {rec['pass1_ms']:.1f} + pass 2 "
          f"{rec['pass2_ms']:.1f} + noise and optimizer "
          f"{rec['noise_opt_ms']:.1f}; launches "
          f"{ {k: v for k, v in rec['launches'].items() if v} }; norms² vs the "
          f"plain auto rules: max rel err {aerr:.2e} (limit {NSQ_RTOL}); peak "
          f"{apeak / 2**30:.2f} GiB", flush=True)
    prof = profile_step(lambda: timed_step(auto, state), "auto+kernels")
    out["auto"] = dict(step=rec, nsq_rel_err=aerr, plain_pass1_ms=p1,
                       peak_bytes=apeak, profile=prof)
    out["launches"] = launches
    return out


def staged_step(trainer, state):
    """One dpsgd_r step by hand, stage by stage as ``Trainer.train_step``
    makes it (without its update-norm metric and the adaptive clip
    update, so the clip norm stays): pass 1, pass 2, the noise and the
    optimizer, each synced at its ends with the peak memory reset before
    it, so each stage's peak says what sets the step's.  Returns {stage:
    {"ms", "peak_bytes"}}."""
    import torch
    from repro_torch import tree
    from repro_torch.core import algo, clipping, noise
    model, dp = trainer.model, trainer.cfg.dp
    K = max(1, dp.augmult)
    data, mask = algo.split_mask(trainer.make_batch(state.step))
    C = trainer.clip_norm(state)
    C = dp.clip_norm if C is None else float(C)
    out = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = dict(ms=1e3 * (time.perf_counter() - t0),
                         peak_bytes=torch.cuda.max_memory_allocated())
        return res

    nsq, _ = stage("pass 1", lambda: algo.norm_pass(
        model.loss_fn, state.params, data, dp, mask))
    c = clipping.clip_factors(nsq, C)
    if mask is not None:
        c = c * algo._example_mask(mask, K)
    grads = stage("pass 2", lambda: algo.reweighted_grads(
        model.loss_fn, state.params, data, algo._expand_rows(c, K)))
    stage("noise", lambda: noise.add_noise_(
        grads, trainer.noise_generator(state.step), dp.noise_multiplier, C,
        trainer.shape.global_batch))
    stage("optimizer", lambda: trainer.opt.apply(
        grads, trainer.optimizer_state(state), tree.leaves(state.params),
        state.step))
    state.step += 1
    return out


def _stages_line(staged):
    return ", ".join(f"{k} {v['ms']:.1f} ms peak {v['peak_bytes'] / 2**30:.2f} GiB"
                     for k, v in staged.items())


def train_remat():
    """Phase 8 (see the module docstring).  Returns its record."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import algo
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    out, launches = {}, dict.fromkeys(kernel_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # 1. 16 layers: the norms² of one batch under each policy, then one step
    # under each, on one model and one AdamW state
    arch = dataclasses.replace(get_arch("phi3-mini-3.8b"), n_layers=TRAIN_LAYERS)
    shape, cfg = train_shape_and_config(arch, "none")
    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0,
                  remat="none")
    trainer = Trainer(model, cfg, shape)
    state = trainer.init_state()
    timed_step(trainer, state)                 # warm-up
    batch = trainer.make_batch(state.step)
    nsq = {}
    for remat in REMATS:
        model.remat = remat
        nsq[remat], _ = algo.norm_pass(model.loss_fn, state.params, batch,
                                       cfg.dp)
    errs = {r: ((nsq[r] - nsq["none"]).abs() / nsq["none"].abs()).max().item()
            for r in REMATS[1:]}
    assert all(e <= NSQ_RTOL for e in errs.values()), errs
    recs = {}
    for remat in REMATS:
        tr = Trainer(model, dataclasses.replace(cfg, remat=remat), shape)
        gc.collect()
        torch.cuda.empty_cache()
        timed_step(tr, state)                  # warm-up under the policy
        torch.cuda.reset_peak_memory_stats()
        rec, *_ = counted_step(tr, model, state, "fused")
        assert math.isfinite(rec["loss"]), rec
        add(rec["launches"])
        rec["staged"] = staged_step(tr, state)
        recs[remat] = rec
        print(f"[remat] {TRAIN_LAYERS} layers, dpsgd_r fused+kernels, remat "
              f"{remat}: step {rec['step_ms']:.1f} ms = pass 1 "
              f"{rec['pass1_ms']:.1f} + pass 2 {rec['pass2_ms']:.1f} + noise "
              f"and optimizer {rec['noise_opt_ms']:.1f}; peak "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB; loss {rec['loss']:.4f}; "
              f"launches { {k: v for k, v in rec['launches'].items() if v} }; "
              f"stage by stage: {_stages_line(rec['staged'])}", flush=True)
    print(f"[remat] norms² of one batch, block and sites against none: max "
          f"rel err {errs['block']:.2e} and {errs['sites']:.2e} (limit "
          f"{NSQ_RTOL})", flush=True)
    out["16"] = dict(steps=recs, nsq_rel_err=errs)
    del model, trainer, tr, state, batch, nsq
    gc.collect()
    torch.cuda.empty_cache()

    # 2. phi3-mini at full depth under block, then one step under sites
    arch = get_arch("phi3-mini-3.8b")
    shape, cfg = train_shape_and_config(arch, "block")
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0,
                  remat="block")
    torch.cuda.synchronize()
    params_bytes = torch.cuda.memory_allocated() - before
    trainer = Trainer(model, cfg, shape)
    state = trainer.init_state()
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    print(f"[remat] {arch.name} at full width and depth, {arch.n_layers} "
          f"layers: {n_par / 1e9:.3f}B params bf16 + AdamW f32 state: "
          f"{before / 2**30:.2f} GiB allocated before, params "
          f"{params_bytes / 2**30:.2f} GiB, params and state "
          f"{(torch.cuda.memory_allocated() - before) / 2**30:.2f} GiB; init "
          f"{time.perf_counter() - t:.1f} s; batch {TRAIN_B} x {TRAIN_T}",
          flush=True)
    timed_step(trainer, state)                 # warm-up
    steps = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        rec, *_ = counted_step(trainer, model, state, "fused")
        add(rec["launches"])
        steps.append(rec)
        print(f"[remat] {arch.n_layers} layers, remat block, dpsgd_r "
              f"fused+kernels step {state.step - 1}: loss {rec['loss']:.4f}; "
              f"{rec['step_ms']:.1f} ms = pass 1 {rec['pass1_ms']:.1f} + pass 2 "
              f"{rec['pass2_ms']:.1f} + noise and optimizer "
              f"{rec['noise_opt_ms']:.1f}; peak {rec['peak_bytes'] / 2**30:.2f} "
              f"GiB; launches {rec['launches']}", flush=True)
    staged = staged_step(trainer, state)
    print(f"[remat] {arch.n_layers} layers, remat block, one step stage by "
          f"stage: {_stages_line(staged)}", flush=True)
    prof = profile_step(lambda: timed_step(trainer, state),
                        f"fused+kernels, {arch.n_layers} layers, remat block,")
    sites = Trainer(model, dataclasses.replace(cfg, remat="sites"), shape)
    timed_step(sites, state)                   # warm-up under sites
    torch.cuda.reset_peak_memory_stats()
    srec, *_ = counted_step(sites, model, state, "fused")
    add(srec["launches"])
    sstaged = staged_step(sites, state)
    losses = [r["loss"] for r in steps] + [srec["loss"]]
    assert all(math.isfinite(x) for x in losses), losses
    print(f"[remat] {arch.n_layers} layers, remat sites: step "
          f"{srec['step_ms']:.1f} ms = pass 1 {srec['pass1_ms']:.1f} + pass 2 "
          f"{srec['pass2_ms']:.1f} + noise and optimizer "
          f"{srec['noise_opt_ms']:.1f}; peak {srec['peak_bytes'] / 2**30:.2f} "
          f"GiB; loss {srec['loss']:.4f}; stage by stage: "
          f"{_stages_line(sstaged)}", flush=True)
    mean = sum(r["step_ms"] for r in steps) / len(steps)
    print(f"[remat] {arch.n_layers} layers, remat block: mean step {mean:.1f} "
          f"ms, {TRAIN_B * TRAIN_T / mean * 1e3:.0f} tokens/s", flush=True)
    out["32"] = dict(params=n_par, steps=steps, staged=staged, profile=prof,
                     sites=srec, sites_staged=sstaged, mean_step_ms=mean)
    out["launches"] = launches
    return out


def train_algorithms():
    """Phase 9 (see the module docstring).  Returns its record."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.core import algo
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    arch = dataclasses.replace(get_arch("phi3-mini-3.8b"), n_layers=TRAIN_LAYERS)
    shape, cfg = train_shape_and_config(arch, "none")
    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0,
                  remat="none")
    trainer = Trainer(model, cfg, shape)
    n_leaves = len(tree.leaves(model.params))

    # 1. σ = 0: the clipped sums of one batch from the same parameters, in
    # bf16 through each algorithm and in float32 through dpsgd_r
    batch = trainer.make_batch(0)

    def clipped_sum(model_, **dp):
        fn = algo.make_clipped_sum_fn(model_.loss_fn,
                                      dataclasses.replace(cfg.dp, **dp))
        return fn(model_.params, batch)

    def leaf_errs(got, want):
        return [((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(got, want)]

    f32 = Model(arch, tree.tree_map(lambda p: p.float(), model.params),
                dtype=torch.float32, device="cuda", remat="block")
    f32.requires_grad_(True)
    truth, _ = clipped_sum(f32)
    del f32
    errs = {}
    for name, dp in (("dpsgd_r", {}), ("dpsgd_r1f", dict(algo="dpsgd_r1f")),
                     ("dpsgd", dict(algo="dpsgd", microbatch=TRAIN_B))):
        got, (_, nsq) = clipped_sum(model, **dp)
        errs[name] = dict(f32=max(leaf_errs(got, truth)))
        if name == "dpsgd_r":
            want, want_nsq = got, nsq
        else:
            pair = leaf_errs(got, want)
            errs[name].update(
                sum=max(pair), worst_leaf=tuple(want[pair.index(max(pair))].shape),
                median_leaf=sorted(pair)[len(pair) // 2],
                nsq=((nsq - want_nsq).abs() / want_nsq).max().item())
            del got
        gc.collect()
        torch.cuda.empty_cache()
    del truth, want, want_nsq
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[algo] σ = 0, one batch, same params: each bf16 clipped sum "
          f"against dpsgd_r's in float32, max over leaves of the error over "
          f"the leaf's largest entry: " + ", ".join(
              f"{k} {v['f32']:.2e}" for k, v in errs.items())
          + f" (limit {CLIP_SUM_TOL})", flush=True)
    for name in ("dpsgd_r1f", "dpsgd"):
        e = errs[name]
        print(f"[algo] σ = 0: {name}'s clipped sum against dpsgd_r's, both "
              f"bf16: within {e['sum']:.2e} of each leaf's largest entry "
              f"(limit {CLIP_SUM_TOL}; worst leaf {e['worst_leaf']}, median "
              f"leaf {e['median_leaf']:.2e}); norms² max rel err "
              f"{e['nsq']:.2e}", flush=True)
    assert all(e["f32"] <= CLIP_SUM_TOL for e in errs.values()), errs
    assert all(errs[n]["sum"] <= CLIP_SUM_TOL for n in ("dpsgd_r1f", "dpsgd")), errs

    # 2. one timed step of each algorithm on one AdamW state
    state = trainer.init_state()
    runs = [("sgd", dict(algo="sgd")), ("dpsgd_r", {}),
            ("dpsgd_r1f", dict(algo="dpsgd_r1f"))]
    runs += [(f"dpsgd mb{mb}", dict(algo="dpsgd", microbatch=mb))
             for mb in DPSGD_MICROBATCHES]
    recs, launches = {}, dict.fromkeys(kernel_counts(), 0)
    for name, dp in runs:
        tr = Trainer(model, dataclasses.replace(
            cfg, dp=dataclasses.replace(cfg.dp, **dp)), shape)
        gc.collect()
        torch.cuda.empty_cache()
        timed_step(tr, state)                  # warm-up
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        rec = timed_step(tr, state)
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        counts = read_counts()
        want_n = path_launches("fused", arch.n_layers, algo=tr.cfg.dp.algo,
                               examples=TRAIN_B,
                               microbatch=tr.cfg.dp.microbatch,
                               leaves=n_leaves)
        assert counts == want_n, (name, counts, want_n)
        assert math.isfinite(rec["loss"]), rec
        for k, v in counts.items():
            launches[k] += v
        rec["launches"] = counts
        recs[name] = rec
    sgd_ms = recs["sgd"]["step_ms"]
    for name, rec in recs.items():
        rec["over_sgd"] = rec["step_ms"] / sgd_ms
        print(f"[algo] {TRAIN_LAYERS} layers, {name}: step {rec['step_ms']:.1f} "
              f"ms ({rec['over_sgd']:.2f}x sgd), peak "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB, loss {rec['loss']:.4f}; "
              f"launches { {k: v for k, v in rec['launches'].items() if v} }",
              flush=True)
    return dict(steps=recs, sigma0=errs, launches=launches)


# ---------------------------------------------------------------------------
# the image families: their kernels at phase 11's shapes (phase 3), and
# phase 11 itself
# ---------------------------------------------------------------------------

def _tc_paths(di, do):
    """The bf16 paths a (di, do) problem takes: the gx launch, the norm
    launch, the Gram kernel (element loads where a row is not a multiple
    of 8 elements)."""
    return ("wgmma+tma" if do % 8 == 0 else "wgmma+loads",
            "wgmma+tma" if di % 8 == 0 and do % 8 == 0 else "wgmma+loads",
            "mma+cp.async" if di % 8 == 0 and do % 8 == 0 else "mma+loads")


def _step_sums(recs, mix, keys=("ms", "plain_ms", "bound_ms", "library_ms")):
    """Sums over one step's calls (``mix``, in ``recs``' order) of each
    key; the roof that holds most of the summed bound names it."""
    out = {k: sum(n * r[k] for (*_, n), r in zip(mix, recs)) for k in keys}
    by = {}
    for (*_, n), r in zip(mix, recs):
        by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + n * r["bound_ms"]
    out.update(bound_by=max(by, key=by.get), bound_ms_by_roof=by,
               max_abs_err=max(r["max_abs_err"] for r in recs))
    return out


def largest_leaf(arch):
    """(path, elements) of ``arch``'s largest parameter."""
    from repro_torch.models import cnn, vit
    from repro_torch.models.transformer import _map_spec
    spec = (cnn if arch.family == "cnn" else vit).model_spec(arch)
    sizes = []
    _map_spec(spec, lambda p, path: sizes.append((math.prod(p.shape),
                                                  "/".join(path))))
    n, path = max(sizes)
    return path, n


def check_image_kernels():
    """The kernels of phase 11's paths at its shapes (K 16 views of each of
    256 examples folded into T), float32 and bf16, each against its plain
    version, timed beside its library call and bound: the flash pair
    non-causal at (4096 x 8 heads, T 64, hd 32); at every distinct norm
    site of each model (``image_mix``) ``dense_bwd_norm``, ``pegrad_norm``
    and ``dense_dgrad`` (and the fusion A/B) on all 256 examples and
    ``gram_norm`` on 4 of them (its plain version and library call form
    each example's T x T Grams: 4.3 GB a matrix at T 16384); and
    ``clip_reduce`` at each model's largest leaf over 256 examples.  The
    bf16 paths must be the ones the shapes call for (element loads only
    where a row is not a multiple of 8 elements).  Returns the records and
    the bf16 sums over one step's calls of each model."""
    import torch
    from repro_torch.configs import get_arch
    bf16 = torch.bfloat16
    vit_arch = get_arch("vit-cifar10")
    H, hd, T = vit_arch.n_heads, vit_arch.hd, vit_arch.vit.n_patches
    out = {"flash_fwd": [], "flash_bwd": [], "mix": {}, "dense": {},
           "pegrad_norm": {}, "dense_dgrad": {}, "ab": {}, "gram": {},
           "clip_reduce": {}, "step": {}}
    for dtype in (torch.float32, bf16):
        out["flash_fwd"].append(check_flash("vit", IMAGE_B * IMAGE_K, H, H, T, hd,
                                            False, dtype))
        out["flash_bwd"].append(check_flash_bwd("vit", IMAGE_B * IMAGE_K * H,
                                                IMAGE_B * IMAGE_K * H, T, hd,
                                                False, dtype, iters=5))
    for r in out["flash_fwd"][1:] + out["flash_bwd"][1:]:
        assert r["path"] == "mma+cp.async", r
    for name in IMAGE_ARCHS:
        arch = get_arch(name)
        mix = image_mix(arch)
        out["mix"][name] = mix
        out["clip_reduce"][name] = []
        for key in ("dense", "pegrad_norm", "dense_dgrad", "ab", "gram"):
            out[key][name] = {"float32": [], "bfloat16": []}
        for dtype in (torch.float32, bf16):
            dt = _dtype_name(dtype)
            for nm, t, di, do, _ in mix:
                label = f"{name}-{nm}"
                out["dense"][name][dt].append(check_dense_bwd_norm(
                    label, IMAGE_B, t, di, do, 1, dtype))
                for k, r in check_dense_halves(label, IMAGE_B, t, di, do, 1,
                                               dtype).items():
                    out[k][name][dt].append(r)
                out["gram"][name][dt].append(check_gram(
                    f"{label} x4", 4, t, di, do, False, True, dtype, iters=5))
                gc.collect()
                torch.cuda.empty_cache()
            path, n = largest_leaf(arch)
            out["clip_reduce"][name].append(
                check_clip_reduce(f"{name}-{path}", IMAGE_B, n, dtype))
        for (nm, t, di, do, _), d, pg, dg, gr in zip(
                mix, out["dense"][name]["bfloat16"],
                out["pegrad_norm"][name]["bfloat16"],
                out["dense_dgrad"][name]["bfloat16"], out["gram"][name]["bfloat16"]):
            gx_path, norm_path, gram_path = _tc_paths(di, do)
            assert (d["path"], d["norm_path"], pg["path"], dg["path"], gr["path"]) \
                == (gx_path, norm_path, norm_path, gx_path, gram_path), (name, nm)
        out["step"][name] = {
            k: _step_sums(out[k][name]["bfloat16"], mix)
            for k in ("dense", "pegrad_norm", "dense_dgrad", "gram")}
        out["step"][name]["ab"] = {k: sum(n * r[k] for (*_, n), r in zip(
            mix, out["ab"][name]["bfloat16"])) for k in ("separate_ms", "fused_ms")}
        st = out["step"][name]
        print(f"[image] {name}: over one step's {sum(n for *_, n in mix)} norm-site "
              f"calls at K {IMAGE_K}, bf16: dense_bwd_norm {st['dense']['ms']:.2f} ms "
              f"(bound {st['dense']['bound_ms']:.3f} ms, {st['dense']['bound_by']}; "
              f"matmul + bmm {st['dense']['library_ms']:.2f} ms; plain "
              f"{st['dense']['plain_ms']:.2f} ms), pegrad_norm "
              f"{st['pegrad_norm']['ms']:.2f} ms (bmm {st['pegrad_norm']['library_ms']:.2f}"
              f" ms), dense_dgrad {st['dense_dgrad']['ms']:.2f} ms (matmul "
              f"{st['dense_dgrad']['library_ms']:.2f} ms), separate / fused "
              f"{st['ab']['separate_ms'] / st['ab']['fused_ms']:.3f}; gram_norm on 4 "
              f"examples {st['gram']['ms']:.2f} ms (library "
              f"{st['gram']['library_ms']:.2f} ms)", flush=True)
    return out


def image_shape_and_config(arch, **dp):
    """Phase 11's shape (256 examples a step) and config: ``dpsgd_r`` with
    the fused route through the kernels, K 16, adaptive clipping from C 1
    (its defaults: quantile 0.5, rate 0.2, count noise 10), σ 1, δ 1e-5,
    remat ``block``, AdamW at lr 1e-4; ``dp`` overrides."""
    from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                          TrainConfig)
    shape = ShapeConfig("cifar10", 1, IMAGE_B, "train")
    base = dict(algo="dpsgd_r", norm_strategy="fused", use_kernels=True,
                clip_norm=1.0, noise_multiplier=1.0, delta=1e-5,
                augmult=IMAGE_K, adaptive_clip=True)
    base.update(dp)
    cfg = TrainConfig(arch=arch.name, log_every=1, remat="block",
                      ckpt_dir=str(ROOT / "build" / "chip_smoke_ckpt"),
                      dp=DPConfig(**base),
                      optim=OptimConfig(name="adamw", lr=1e-4, schedule="constant"))
    return shape, cfg


def image_trainer(model, shape, cfg):
    """A Trainer on synthetic CIFAR-shaped images from a dataset of
    ``IMAGE_N`` examples (q = 256 / 50,000)."""
    from repro_torch.data.pipeline import SyntheticSource
    from repro_torch.train import Trainer
    return Trainer(model, cfg, shape, source=SyntheticSource(
        model.arch.vocab, cfg.seed, dataset_size=IMAGE_N))


def _nsq_against_plain(trainer, state, batch):
    """The norms² of ``batch`` through the trainer's route with kernels and
    through its plain rules on the card: (max rel err, kernel norms²)."""
    from repro_torch.core import algo
    data, mask = algo.split_mask(batch)
    dp = trainer.cfg.dp
    got, _ = algo.norm_pass(trainer.model.loss_fn, state.params, data, dp, mask)
    want, _ = algo.norm_pass(trainer.model.loss_fn, state.params, data,
                             dataclasses.replace(dp, use_kernels=False), mask)
    err = ((got - want).abs() / want.abs()).max().item()
    assert err <= NSQ_RTOL, (dp.norm_strategy, err)
    return err, got


def train_image(name):
    """Phase 11 for one image model (see the module docstring).  Returns its
    record."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model_for
    arch = get_arch(name)
    shape, cfg = image_shape_and_config(arch)
    rows = IMAGE_B * IMAGE_K
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = build_model_for(arch, dtype=torch.bfloat16, device="cuda", seed=0,
                            remat="block")
    trainer = image_trainer(model, shape, cfg)
    state = trainer.init_state()
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    print(f"[image] {name} at full width and depth: {n_par} params bf16 + AdamW "
          f"f32 state, init {time.perf_counter() - t:.1f} s; batch {IMAGE_B} "
          f"examples x {IMAGE_K} views = {rows} rows of {arch.image_shape()}; "
          f"q = {IMAGE_B} / {IMAGE_N}; remat block; dpsgd_r fused+kernels, "
          f"adaptive clip from C {cfg.dp.clip_norm}", flush=True)
    timed_step(trainer, state)                 # warm-up (allocator, cuDNN)
    launches = dict.fromkeys(kernel_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    steps = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        rec, *_ = counted_step(trainer, model, state, "fused")
        add(rec["launches"])
        rec["rows_per_s"] = rows / rec["step_ms"] * 1e3
        steps.append(rec)
        print(f"[image] {name} step {state.step - 1}: loss {rec['loss']:.4f}; "
              f"clip_norm {rec['clip_norm']:.4f} -> {rec['clip_norm_next']:.4f} "
              f"(fraction below {rec['clip_frac_below']:.3f}); {rec['step_ms']:.1f} ms "
              f"= pass 1 {rec['pass1_ms']:.1f} + pass 2 {rec['pass2_ms']:.1f} + noise "
              f"and optimizer {rec['noise_opt_ms']:.1f}; {rec['rows_per_s']:.0f} rows/s; "
              f"peak {rec['peak_bytes'] / 2**30:.2f} GiB; launches "
              f"{ {k: v for k, v in rec['launches'].items() if v} }", flush=True)
    losses = [r["loss"] for r in steps]
    assert all(math.isfinite(x) for x in losses), losses
    assert steps[-1]["clip_norm_next"] != steps[0]["clip_norm"], steps
    t = time.perf_counter()
    trainer.make_batch(state.step)
    batch_ms = 1e3 * (time.perf_counter() - t)
    print(f"[image] {name} one batch made on the host ({IMAGE_B} images, {IMAGE_K} "
          f"views each, to the card): {batch_ms:.1f} ms, outside the step times",
          flush=True)
    staged = staged_step(trainer, state)
    print(f"[image] {name} one step stage by stage: {_stages_line(staged)}",
          flush=True)
    prof = profile_step(lambda: timed_step(trainer, state),
                        f"fused+kernels, {name}, K {IMAGE_K}, adaptive clip,")
    nsq_err, nsq = _nsq_against_plain(trainer, state, trainer.make_batch(state.step))
    print(f"[image] {name} norms² of one batch, fused+kernels vs the plain rules: "
          f"max rel err {nsq_err:.2e} (limit {NSQ_RTOL}); norms "
          f"{np.round(nsq.sqrt().cpu().numpy()[:8], 4).tolist()}...", flush=True)
    out = dict(params=n_par, rows=rows, steps=steps, staged=staged, profile=prof,
               nsq_rel_err=nsq_err, batch_ms=batch_ms)

    def variant(label, route, **dp):
        tr = image_trainer(model, shape, dataclasses.replace(
            cfg, dp=dataclasses.replace(cfg.dp, **dp)))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec, batch, nsq_, losses_ = counted_step(tr, model, state, route)
        add(rec["launches"])
        assert math.isfinite(rec["loss"]), (label, rec)
        print(f"[image] {name} {label} step {state.step - 1}: loss {rec['loss']:.4f}; "
              f"clip_norm {rec['clip_norm']:.4f} -> {rec['clip_norm_next']:.4f}; "
              f"{rec['step_ms']:.1f} ms = pass 1 {rec['pass1_ms']:.1f} + pass 2 "
              f"{rec['pass2_ms']:.1f} + noise and optimizer {rec['noise_opt_ms']:.1f}; "
              f"peak {rec['peak_bytes'] / 2**30:.2f} GiB; launches "
              f"{ {k: v for k, v in rec['launches'].items() if v} }", flush=True)
        return tr, rec, batch, nsq_, losses_

    if arch.family == "cnn":
        for route in ("materialize", "gram"):
            tr, rec, batch, *_ = variant(f"{route}+kernels", route,
                                         norm_strategy=route)
            rec["nsq_rel_err"], _ = _nsq_against_plain(tr, state, batch)
            print(f"[image] {name} {route}+kernels norms² vs the plain {route} "
                  f"rules: max rel err {rec['nsq_rel_err']:.2e} (limit {NSQ_RTOL})",
                  flush=True)
            out[route] = rec
            if route == "materialize":
                # fused against materialize in turns (mat, fused, fused, mat)
                turns = {"materialize": [], "fused": []}
                for r in ("materialize", "fused", "fused", "materialize"):
                    turns[r].append(timed_step(tr if r == "materialize" else trainer,
                                               state)["step_ms"])
                means = {r: float(np.mean(v)) for r, v in turns.items()}
                print(f"[image] {name} in turns: materialize "
                      f"{means['materialize']:.1f} ms vs fused {means['fused']:.1f} ms a "
                      f"step (materialize / fused "
                      f"{means['materialize'] / means['fused']:.3f}; runs {turns})",
                      flush=True)
                out["turns"] = dict(steps_ms=turns, mean_ms=means)

    # one Poisson step: the padded examples' norms² exactly 0
    tr, rec, batch, nsq, losses = variant("poisson", "fused", sampling="poisson")
    mask = batch["mask"].reshape(-1, IMAGE_K)[:, 0]
    real = int(mask.sum())
    assert rec["realized_batch"] == real and nsq.shape == mask.shape
    assert bool(torch.all(nsq[~mask] == 0.0)) and bool(torch.all(nsq[mask] > 0.0))
    assert bool(torch.all(torch.isfinite(losses)))
    rec.update(capacity=tr.capacity, realized=real)
    print(f"[poisson] {name}: realized batch {real} examples of capacity "
          f"{tr.capacity} (x {IMAGE_K} views = {tr.capacity * IMAGE_K} rows), q "
          f"{tr.sample_rate:.4e}; padded examples' norms² all exactly 0.0", flush=True)
    out["poisson"] = rec

    # one dpsgd step: clip_reduce on every leaf's 256 per-example gradients
    dtr = image_trainer(model, shape, dataclasses.replace(
        cfg, dp=dataclasses.replace(cfg.dp, algo="dpsgd", microbatch=0)))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    rec = timed_step(dtr, state)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    counts = read_counts()
    want = path_launches("fused", algo="dpsgd", remat=model.remat,
                         examples=IMAGE_B, leaves=len(tree.leaves(model.params)),
                         **launch_shape(arch))
    assert counts == want, (counts, want)
    assert math.isfinite(rec["loss"]), rec
    add(counts)
    rec["launches"] = counts
    print(f"[image] {name} dpsgd (all {IMAGE_B} examples at once) step {state.step - 1}: "
          f"loss {rec['loss']:.4f}; clip_norm {rec['clip_norm']:.4f} -> "
          f"{rec['clip_norm_next']:.4f}; {rec['step_ms']:.1f} ms, peak "
          f"{rec['peak_bytes'] / 2**30:.2f} GiB; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    out["dpsgd"] = rec

    mean = float(np.mean([r["step_ms"] for r in steps]))
    bd = trainer.accountant.epsilon_breakdown(state.step)
    print(f"[image] {name}: mean step {mean:.1f} ms, {rows / mean * 1e3:.0f} rows/s "
          f"({IMAGE_B / mean * 1e3:.0f} examples/s); after {state.step} steps eps "
          f"{bd['eps_total']:.6f} composed (grad {bd['eps_grad']:.6f}, clip "
          f"{bd['eps_clip']:.6f}; q {trainer.sample_rate:.4e}, sigma "
          f"{cfg.dp.noise_multiplier}, count noise {cfg.dp.clip_count_noise}, delta "
          f"{cfg.dp.delta}); clip_norm now {float(trainer.clip_norm(state)):.4f}",
          flush=True)
    out.update(mean_step_ms=mean, rows_per_s=rows / mean * 1e3, epsilon=bd,
               launches=launches)
    return out


def train_images():
    """Phase 11: both image models (see the module docstring)."""
    import torch
    out = {}
    for name in IMAGE_ARCHS:
        out[name] = train_image(name)
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = {k: sum(out[n]["launches"][k] for n in IMAGE_ARCHS)
                       for k in kernel_counts()}
    return out


# phase 10: chatglm3-6b at full width and depth, batches from a memmap
# corpus of 2^24 int32 tokens, adam8bit; the checkpoint drill at 4 layers
GLM_ARCH, GLM_DRILL_LAYERS, CORPUS_TOKENS = "chatglm3-6b", 4, 1 << 24


def write_corpus(path, vocab, seed=0):
    """A flat int32 token file of ``CORPUS_TOKENS`` tokens, from ``seed``."""
    import numpy as np
    np.random.default_rng(seed).integers(0, vocab, CORPUS_TOKENS,
                                         dtype=np.int32).tofile(path)


def glm_shape_and_config(arch, corpus, ckpt_dir):
    """Phase 10's shape (B 8 x T 512) and config: ``dpsgd_r`` fused through
    the kernels, C 1, σ 1, δ 1e-5, remat ``block``, adam8bit at lr 1e-4,
    batches from the memmap ``corpus``, asynchronous checkpoints to
    ``ckpt_dir`` (the steps here never reach ``Trainer.run``'s saves)."""
    from repro_torch.configs.base import OptimConfig
    shape, cfg = train_shape_and_config(arch, "block")
    return shape, dataclasses.replace(
        cfg, data_source=f"memmap:{corpus}", ckpt_dir=str(ckpt_dir),
        ckpt_async=True, optim=OptimConfig(name="adam8bit", lr=1e-4,
                                           schedule="constant"))


def check_glm_kernels(arch):
    """The kernels of phase 10's path at its shapes, bf16, each against its
    plain version: the flash pair at 8 x 32 heads on 2 kv heads, T 512, hd
    128; dense_bwd_norm at every dense shape of the layer and the head;
    gram_norm at the masked embedding."""
    import torch
    bf16 = torch.bfloat16
    B, T, H, KV, hd = TRAIN_B, TRAIN_T, arch.n_heads, arch.n_kv_heads, arch.hd
    fwd = check_flash("glm-train", B, H, KV, T, hd, True, bf16)
    bwd = check_flash_bwd("glm-train", B * H, B * KV, T, hd, True, bf16)
    mix = dense_mix(arch, arch.n_layers)
    dense = [check_dense_bwd_norm(nm, B, T, di, do, 1, bf16,
                                  iters=5 if nm == "head" else 10)
             for nm, di, do, _ in mix]
    gram = check_gram("glm-embed", B, T, arch.d_model, arch.d_model, True, False, bf16)
    for r in (fwd, bwd, gram):
        assert r["path"] == "mma+cp.async", r
    for r in dense:
        assert r["path"] == r["norm_path"] == "wgmma+tma", r
    # k and v (4096 -> 256) are bound by bytes, the rest by operations: the
    # step's bound is the sum, named by the roof that holds most of it
    step = _step_sums(dense, mix)
    print(f"[glm] dense_bwd_norm over one step's {sum(n for *_, n in mix)} calls, "
          f"bf16: kernel {step['ms']:.2f} ms, plain {step['plain_ms']:.1f} ms, "
          f"matmul + bmm {step['library_ms']:.2f} ms, bound {step['bound_ms']:.2f} "
          f"ms ({step['bound_by']}), {100 * step['bound_ms'] / step['ms']:.1f}% of "
          f"bound", flush=True)
    return dict(flash_fwd=fwd, flash_bwd=bwd, dense=dense, dense_step=step,
                gram=gram, mix=mix)


def train_glm(corpus, ckpt_dir):
    """Phase 10's full-depth run: chatglm3-6b, 28 layers, from the memmap
    corpus, under adam8bit: a warm-up step, three counted steps, one by
    hand stage by stage, one profiled.  Saves nothing."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    arch = get_arch(GLM_ARCH)
    shape, cfg = glm_shape_and_config(arch, corpus, ckpt_dir)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0, remat="block")
    torch.cuda.synchronize()
    params_bytes = torch.cuda.memory_allocated() - before
    trainer = Trainer(model, cfg, shape)
    state = trainer.init_state()
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated() - before - params_bytes
    n_par = sum(p.numel() for p in model.parameters())
    print(f"[glm] {arch.name} at full width and depth, {arch.n_layers} layers: "
          f"{n_par / 1e9:.3f}B params bf16 {params_bytes / 2**30:.2f} GiB + adam8bit "
          f"state {state_bytes / 2**30:.2f} GiB; init {time.perf_counter() - t:.1f} s; "
          f"batch {TRAIN_B} x {TRAIN_T} from {trainer.source.dataset_size} memmap "
          f"tokens, remat block", flush=True)
    timed_step(trainer, state)                 # warm-up
    steps = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        rec, *_ = counted_step(trainer, model, state, "fused")
        steps.append(rec)
        print(f"[glm] {arch.n_layers} layers, dpsgd_r fused+kernels, adam8bit, step "
              f"{state.step - 1}: loss {rec['loss']:.4f}; {rec['step_ms']:.1f} ms = "
              f"pass 1 {rec['pass1_ms']:.1f} + pass 2 {rec['pass2_ms']:.1f} + noise "
              f"and optimizer {rec['noise_opt_ms']:.1f}; peak "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB; launches {rec['launches']}",
              flush=True)
    staged = staged_step(trainer, state)
    print(f"[glm] one step stage by stage: {_stages_line(staged)}", flush=True)
    prof = profile_step(lambda: timed_step(trainer, state),
                        f"fused+kernels, {arch.name}, {arch.n_layers} layers, "
                        f"adam8bit,")
    losses = [r["loss"] for r in steps]
    assert all(math.isfinite(x) for x in losses), losses
    mean = float(np.mean([r["step_ms"] for r in steps]))
    eps = trainer.accountant.epsilon_at(state.step)
    print(f"[glm] mean step {mean:.1f} ms, {TRAIN_B * TRAIN_T / mean * 1e3:.0f} "
          f"tokens/s; eps after {state.step} steps {eps:.6f} (q "
          f"{trainer.sample_rate:.3e}, N = {trainer.source.dataset_size} tokens)",
          flush=True)
    launches = {k: sum(r["launches"][k] for r in steps) for k in steps[0]["launches"]}
    return dict(params=n_par, params_bytes=params_bytes, state_bytes=state_bytes,
                steps=steps, staged=staged, profile=prof, mean_step_ms=mean,
                tokens_per_s=TRAIN_B * TRAIN_T / mean * 1e3, epsilon=eps,
                launches=launches)


def checkpoint_drill(corpus, ckpt_dir):
    """Phase 10's checkpoint drill at full width and 4 layers: two steps,
    an asynchronous save at step 2, step 3 at once (its update mutates the
    state while the write runs); then a fresh Model and Trainer restore
    step 2 and run step 3 again: its loss, norms² and every leaf after it
    must equal the first run's bit for bit."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import algo
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    from repro_torch.train.checkpoint import flatten
    arch = dataclasses.replace(get_arch(GLM_ARCH), n_layers=GLM_DRILL_LAYERS)
    shape, cfg = glm_shape_and_config(arch, corpus, ckpt_dir)

    def step3(trainer, state):
        """Step 3's norms² (pass 1 on its batch) and the step itself."""
        data, mask = algo.split_mask(trainer.make_batch(state.step))
        nsq, _ = algo.norm_pass(trainer.model.loss_fn, state.params, data,
                                trainer.cfg.dp, mask)
        return nsq, timed_step(trainer, state)

    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0, remat="block")
    trainer = Trainer(model, cfg, shape)
    state = trainer.init_state()
    for _ in range(2):
        timed_step(trainer, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.ckpt.save(state, state.step)
    blocked = time.perf_counter() - t0
    nsq, rec = step3(trainer, state)
    overlapped = trainer.ckpt._thread is not None and trainer.ckpt._thread.is_alive()
    trainer.ckpt.wait()
    write_s = trainer.ckpt.write_seconds
    after = [t.clone() if isinstance(t, torch.Tensor) else t for t in flatten(state)]
    step_dir = Path(ckpt_dir) / "step_2"
    nbytes = sum(f.stat().st_size for f in step_dir.iterdir())
    n_par = sum(p.numel() for p in model.parameters())
    del model, trainer, state
    gc.collect()
    torch.cuda.empty_cache()

    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=1, remat="block")
    trainer = Trainer(model, cfg, shape)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = trainer.restore_or_init()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    assert state.step == 2, state.step
    nsq_b, rec_b = step3(trainer, state)
    leaves = flatten(state)
    same = [torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            for a, b in zip(after, leaves)]
    assert rec_b["loss"] == rec["loss"], (rec_b, rec)
    assert torch.equal(nsq_b, nsq), (nsq_b, nsq)
    assert len(same) == len(leaves) and all(same), same.count(False)
    print(f"[ckpt] {arch.name} at full width, {arch.n_layers} layers ({n_par / 1e9:.3f}B "
          f"params, adam8bit): step 2 saved, {nbytes / 1e9:.3f} GB in "
          f"{len(list(step_dir.iterdir())) - 1} files; save blocked {blocked:.3f} s, "
          f"the write took {write_s:.3f} s (still running when step 3 ended: "
          f"{overlapped}); restore into a fresh Model and Trainer {restore_s:.3f} s; "
          f"step 3 after the restore: loss {rec_b['loss']:.6f}, norms² and all "
          f"{len(leaves)} leaves bit-identical to the uninterrupted run's", flush=True)
    del model, trainer, state, after, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return dict(params=n_par, bytes=nbytes, save_blocked_s=blocked, write_s=write_s,
                write_outlasted_step=overlapped, restore_s=restore_s,
                loss=rec["loss"], step3_ms=rec["step_ms"], leaves=len(same))


def train_glm_path():
    """Phase 10 (see the module docstring), in a temporary directory under
    the checkout's ``build/`` that is removed at the end."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_arch
    arch = get_arch(GLM_ARCH)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_glm_", dir=ROOT / "build"))
    try:
        corpus = tmp / "tokens.bin"
        write_corpus(corpus, arch.vocab)
        kernels = check_glm_kernels(arch)
        gc.collect()
        torch.cuda.empty_cache()
        full = train_glm(corpus, tmp / "ckpt_full")
        assert not any((tmp / "ckpt_full").iterdir())    # the full depth saved nothing
        gc.collect()
        torch.cuda.empty_cache()
        drill = checkpoint_drill(corpus, tmp / "ckpt_drill")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(kernels=kernels, full=full, drill=drill, launches=full["launches"])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the "
              "card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models.transformer import padded_vocab
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 references
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] torch: {name}, {torch.cuda.device_count()} device(s); "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(f"[device] nvidia-smi: {smi}", flush=True)

    # 2. build
    t = time.perf_counter()
    logs = build.build()
    print(f"[build] {', '.join(build.sources())}: {len(logs)} compiled in "
          f"{time.perf_counter() - t:.1f} s (the others were built from the "
          f"same source already)", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}")
    tensor_core_ptxas()

    # 3. kernels vs plain, at the shapes of both paths and a few others
    arch = get_arch("phi3-mini-3.8b")
    prompts = request_stream(arch.vocab)
    wave_t = first_wave_t(prompts)
    shapes = [("phi3-wave", 8, 32, 32, wave_t, 96, True),
              ("phi3-train", TRAIN_B, arch.n_heads, arch.n_kv_heads, TRAIN_T, arch.hd,
               True),
              ("phi3", 4, 32, 32, 1024, 96, True),
              ("starcoder2-gqa", 1, 36, 4, 777, 128, True),
              ("starcoder2-gqa-full", 1, 36, 4, 333, 128, False)]
    kernel_recs = []
    for shp in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            kernel_recs.append(check_flash(*shp, dtype))
    d, f = arch.d_model, arch.d_ff
    L = TRAIN_LAYERS
    train_mix = dense_mix(arch, L)
    dense_recs, bwd_recs, gram_recs, clip_recs = [], [], [], []
    halves = {"pegrad_norm": [], "dense_dgrad": [], "ab": []}
    for dtype in (torch.float32, torch.bfloat16):
        for nm, di, do, _ in train_mix:
            iters = 5 if nm == "head" else 10
            dense_recs.append(check_dense_bwd_norm(nm, TRAIN_B, TRAIN_T, di, do, 1,
                                                   dtype, iters=iters))
            for k, r in check_dense_halves(nm, TRAIN_B, TRAIN_T, di, do, 1, dtype,
                                           iters=iters).items():
                halves[k].append(r)
        for shp in (("grouped-E4", 8, 300, 1024, 768, 4), ("ragged", 3, 333, 1000, 517, 1)):
            dense_recs.append(check_dense_bwd_norm(*shp, dtype))
            for k, r in check_dense_halves(*shp, dtype).items():
                halves[k].append(r)
        check_norm_contracts(dtype)
        for shp in (("phi3-train", TRAIN_B * arch.n_heads, TRAIN_B * arch.n_kv_heads,
                     TRAIN_T, arch.hd, True),
                    ("starcoder2-gqa", 36, 4, 777, 128, True),
                    ("starcoder2-gqa-full", 36, 4, 333, 128, False)):
            bwd_recs.append(check_flash_bwd(*shp, dtype))
        gram_recs.append(check_gram("embed", TRAIN_B, TRAIN_T, d, d, True, False, dtype))
        gram_recs.append(check_gram("square", TRAIN_B, TRAIN_T, d, d, False, True, dtype))
        # the largest leaf's per-example gradients as vanilla DP-SGD stacks
        # them (phase 9: the stacked w1 of 16 layers, a whole batch at once);
        # and a ragged width (the one-column-per-thread path)
        clip_recs.append(check_clip_reduce("phi3-w1-stack", TRAIN_B, L * d * f,
                                           dtype))
        clip_recs.append(check_clip_reduce("ragged", 3, 1_000_003, dtype))

    # the image families' shapes (phase 11's path)
    image_kernels = check_image_kernels()

    # the auto route's shapes (B 2 x T 2048), bf16: its attention backward
    # and its three square Gram widths (w1 and w3, w2, the head)
    bwd_recs.append(check_flash_bwd("auto-2048", AUTO_B * arch.n_heads,
                                    AUTO_B * arch.n_kv_heads, AUTO_T, arch.hd, True,
                                    torch.bfloat16, iters=5))
    for nm, di, do in (("auto-w1w3", d, f), ("auto-w2", f, d),
                       ("auto-head", d, padded_vocab(arch.vocab))):
        gram_recs.append(check_gram(nm, AUTO_B, AUTO_T, di, do, False, True,
                                    torch.bfloat16, iters=5))
    # and its pegrad_norm calls (q, k, v, o at B 2 x T 2048)
    x, gy, _ = dense_inputs(AUTO_B, AUTO_T, d, d, 1, torch.bfloat16)
    auto_norm, _ = check_pegrad_norm("auto-qkvo", x, gy, iters=5)
    halves["pegrad_norm"].append(dict(auto_norm, E=1))
    del x, gy

    def pick(recs, shape):
        return next(r for r in recs if r["shape"] == shape and r["dtype"] == "bfloat16")

    def step_sum(recs, keys=("ms", "plain_ms", "bound_ms", "library_ms")):
        """Sums over one training step's dense calls (dense_mix), bf16."""
        per_call = {nm: pick(recs, nm) for nm, *_ in train_mix}
        out = {k: sum(n * per_call[nm][k] for nm, _, _, n in train_mix) for k in keys}
        if "bound_by" in per_call["qkvo"]:
            # a sum of bounds is the bound of the sum when every call has one roof
            (out["bound_by"],) = {r["bound_by"] for r in per_call.values()}
            out["max_abs_err"] = max(r["max_abs_err"] for r in per_call.values())
        return out

    # every training shape's bf16 gx and norm launch take the TMA-fed
    # tensor-core path; the ragged shapes the path norm_path reports
    for recs, key in ((dense_recs, "path"), (halves["dense_dgrad"], "path"),
                      (dense_recs, "norm_path"), (halves["pegrad_norm"], "path")):
        for nm in [nm for nm, *_ in train_mix] + ["grouped-E4"]:
            assert pick(recs, nm)[key] == "wgmma+tma", (nm, key, pick(recs, nm)[key])
    for recs, key in ((dense_recs, "norm_path"), (halves["pegrad_norm"], "path")):
        assert pick(recs, "ragged")[key] == "wgmma+loads", (key, pick(recs, "ragged"))
    assert auto_norm["path"] == "wgmma+tma", auto_norm["path"]
    # every training shape's bf16 attention backward and Gram take the
    # cp.async-fed tensor-core path
    for recs, names in ((bwd_recs, ("phi3-train", "auto-2048")),
                        (gram_recs, ("embed", "square", "auto-w1w3", "auto-w2",
                                     "auto-head"))):
        for nm in names:
            assert pick(recs, nm)["path"] == "mma+cp.async", (nm, pick(recs, nm)["path"])
    dgrad_step = step_sum(halves["dense_dgrad"])
    dgrad_flops = sum(2.0 * TRAIN_B * TRAIN_T * di * do * n for _, di, do, n in train_mix)
    print(f"[kernel] dense_dgrad over one training step's {7 * L + 1} calls, bf16: "
          f"kernel {dgrad_step['ms']:.2f} ms, matmul {dgrad_step['library_ms']:.2f} ms "
          f"(kernel / matmul {dgrad_step['ms'] / dgrad_step['library_ms']:.2f}), bound "
          f"{dgrad_step['bound_ms']:.2f} ms; {dgrad_flops / dgrad_step['ms'] / 1e9:.1f} "
          f"TFLOP/s, {100 * dgrad_step['bound_ms'] / dgrad_step['ms']:.1f}% of bound; "
          f"path wgmma+tma at every shape", flush=True)
    norm_step = step_sum(halves["pegrad_norm"])
    print(f"[kernel] pegrad_norm (the norm launch) over one training step's "
          f"{7 * L + 1} calls, bf16: kernel {norm_step['ms']:.2f} ms, bmm "
          f"{norm_step['library_ms']:.2f} ms (kernel / bmm "
          f"{norm_step['ms'] / norm_step['library_ms']:.2f}), bound "
          f"{norm_step['bound_ms']:.2f} ms; {dgrad_flops / norm_step['ms'] / 1e9:.1f} "
          f"TFLOP/s, {100 * norm_step['bound_ms'] / norm_step['ms']:.1f}% of bound; "
          f"path wgmma+tma at every shape", flush=True)
    ab_step = step_sum(halves["ab"], ("separate_ms", "fused_ms"))
    print(f"[fusion] one training step's {7 * L + 1} dense calls, bf16: "
          f"dense_dgrad + pegrad_norm {ab_step['separate_ms']:.1f} ms, "
          f"dense_bwd_norm {ab_step['fused_ms']:.1f} ms, separate / fused "
          f"{ab_step['separate_ms'] / ab_step['fused_ms']:.4f}", flush=True)

    # 4. small references
    small_reference("cuda")
    train_reference()
    for image_arch in IMAGE_ARCHS:
        train_reference(image_arch, augmult=2)

    # 5. the serving path
    print(f"[main] allocated before the serving path: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    runs, serve_launches, breakdown = main_path(arch, prompts)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] allocated before the training path: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)

    # 6. the training path
    train, model, fused_trainer, state = train_main_path()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[route] allocated before the norm-route path (phase 6's model and "
          f"AdamW state): {torch.cuda.memory_allocated() / 2**30:.3f} GiB",
          flush=True)

    # 7. the per-site norm rules and Poisson batches, on phase 6's state
    routes = train_norm_routes(model, fused_trainer, state)
    del model, fused_trainer, state
    gc.collect()
    torch.cuda.empty_cache()

    # 8. remat at 16 layers and phi3-mini at full depth
    remat = train_remat()
    gc.collect()
    torch.cuda.empty_cache()

    # 9. the paper's comparison: sgd, dpsgd_r, dpsgd_r1f, dpsgd
    algos = train_algorithms()
    gc.collect()
    torch.cuda.empty_cache()

    # 10. chatglm3-6b at full width and depth from a memmap corpus, adam8bit;
    # the checkpoint drill
    glm = train_glm_path()
    gc.collect()
    torch.cuda.empty_cache()

    # 11. the image families at full width and depth: augmult 16, adaptive clip
    images = train_images()
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in (train, routes, remat, algos, glm,
                                                  images))
                for k in train["launches"]}
    launches["flash_attn_fwd"] += serve_launches

    flash_rec = pick(kernel_recs, "phi3-wave")
    bwd_rec, gram_rec = pick(bwd_recs, "phi3-train"), pick(gram_recs, "embed")
    clip_rec = pick(clip_recs, "phi3-w1-stack")
    mix = " + ".join(f"{n} x ({di},{do})" for _, di, do, n in train_mix)

    gk = glm["kernels"]

    def glm_row(rec, shape):
        """A kernel's numbers at phase 10's shape (bf16)."""
        return {"shape": shape, **{k: rec[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "path": rec.get("path", "wgmma+tma")}

    ik = image_kernels

    def image_row(kernel, model, rec=None):
        """A kernel's numbers on phase 11's path of ``model`` (bf16), with
        its launches there: the sum over one step's calls (``rec`` None) or
        one call's record."""
        mix = ik["mix"][model]
        if rec is None:
            key = {"dense_bwd_norm": "dense", "gram_norm": "gram"}.get(kernel, kernel)
            rec = ik["step"][model][key]
            ex = "4 of 256 examples" if kernel == "gram_norm" else "256 examples"
            shape = (f"sum over one step's calls ({ex}, K {IMAGE_K}): " + " + ".join(
                f"{n} x (T {t}, {di}, {do})" for _, t, di, do, n in mix))
        else:
            shape = rec["shape"]
        return {"shape": shape, "launches": images[model]["launches"][kernel],
                **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}}

    vit_shape = (f"({IMAGE_B * IMAGE_K} x 8 heads, T 64, hd 32) non-causal, bf16")
    image_rows = {
        "flash_attn_fwd": dict(cnn=None, vit=dict(image_row(
            "flash_attn_fwd", "vit-cifar10", ik["flash_fwd"][1]), shape=vit_shape)),
        "flash_attn_bwd": dict(cnn=None, vit=dict(image_row(
            "flash_attn_bwd", "vit-cifar10", ik["flash_bwd"][1]), shape=vit_shape)),
        "clip_reduce": {m.split("-")[0]: image_row("clip_reduce", m,
                                                    ik["clip_reduce"][m][1])
                        for m in IMAGE_ARCHS}}
    for kernel in ("dense_bwd_norm", "pegrad_norm", "dense_dgrad", "gram_norm"):
        image_rows[kernel] = {m.split("-")[0]: image_row(kernel, m)
                              for m in IMAGE_ARCHS}

    def entry(name, source, replaces, n, rec, **extra):
        out = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{source}",
               "replaces": replaces, "launches": n,
               "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
               "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
               "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
        out.update(extra)
        out.update(image_rows[name])
        return out

    kernels = {"kernels": [
        entry("flash_attn_fwd", "flash_attn_fwd.cu",
              "src/repro/kernels/flash_attn.py:77", launches["flash_attn_fwd"],
              flash_rec, shape="serving wave, bf16", path=flash_rec["path"],
              chatglm3=glm_row(gk["flash_fwd"], f"({TRAIN_B} x 32 heads, kv 2, "
                               f"T {TRAIN_T}, hd 128) causal")),
        entry("dense_bwd_norm", "dense_bwd_norm.cu",
              "src/repro/kernels/fused_bwd.py:114", launches["dense_bwd_norm"],
              step_sum(dense_recs),
              shape=f"sum over one training step's calls, bf16: {mix}",
              path="gx wgmma+tma, norm wgmma+tma",
              chatglm3=glm_row(gk["dense_step"], "sum over one chatglm3-6b step's "
                               "calls: " + " + ".join(f"{n} x ({di},{do})" for _, di, do, n
                                                      in gk["mix"]))),
        entry("flash_attn_bwd", "flash_attn_bwd.cu",
              "src/repro/kernels/flash_attn.py:210", launches["flash_attn_bwd"],
              bwd_rec, shape=f"({bwd_rec['BH']}, {TRAIN_T}, {arch.hd}) causal, bf16",
              path=bwd_rec["path"],
              chatglm3=glm_row(gk["flash_bwd"], f"({TRAIN_B * 32}, kv {TRAIN_B * 2}, "
                               f"{TRAIN_T}, 128) causal")),
        entry("gram_norm", "gram_norm.cu", "src/repro/kernels/gram_norm.py:66",
              launches["gram_norm"], gram_rec,
              shape=f"embedding rule ({TRAIN_B}, {TRAIN_T}, {d}) masked, bf16",
              path=gram_rec["path"],
              chatglm3=glm_row(gk["gram"], f"embedding rule ({TRAIN_B}, {TRAIN_T}, "
                               f"4096) masked")),
        entry("pegrad_norm", "pegrad_norm.cu", "src/repro/kernels/pegrad_norm.py:52",
              launches["pegrad_norm"], norm_step,
              shape=f"sum over one materialize step's calls, bf16: {mix}",
              path="wgmma+tma"),
        entry("dense_dgrad", "dense_dgrad.cu", "src/repro/kernels/fused_bwd.py:158",
              launches["dense_dgrad"], dgrad_step,
              shape=f"sum over one training step's dense calls, bf16: {mix}",
              launched_on="dpsgd_r1f's second pullback (phase 9)",
              path="wgmma+tma"),
        entry("clip_reduce", "clip_reduce.cu", "src/repro/kernels/clip_reduce.py:34",
              launches["clip_reduce"], clip_rec,
              shape=f"({TRAIN_B}, {L * d * f}) bf16, the per-example gradients "
                    f"of the stacked w1",
              launched_on="dpsgd's clipped sums (phase 9)"),
    ]}
    for k in kernels["kernels"]:
        assert k["bound_by"] in ("bytes", "operations") and k["launches"] > 0, k
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": name, "nvidia_smi": smi, "flash_fwd": kernel_recs,
         "dense_bwd_norm": dense_recs, "dense_halves": halves,
         "fusion_ab_step": ab_step, "flash_attn_bwd": bwd_recs,
         "gram_norm": gram_recs, "clip_reduce": clip_recs, "serve": runs,
         "decode_breakdown_ms": breakdown, "train": train, "routes": routes,
         "remat": remat, "algos": algos, "glm": glm, "image_kernels": image_kernels,
         "images": images, "json_line": kernels},
        indent=1, default=str))
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
