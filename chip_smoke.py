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
   the fused call; ``clip_reduce``, fresh and added into a running sum
   (``out=``), with zeroed clip factors equals the compacted reduction
   bit for bit, also at phase 9's flat buffers (32 GB at B 8), its times
   event-timed as every kernel's with ``torch.profiler``'s device times
   beside them, small shapes' loops rotated past the L2.  The dgrad kernel's, the norm
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
   ``clip_reduce`` over 256 examples at each model's largest leaf, at its
   flat buffers' widths (``dpsgd``'s launches, one a parameter dtype a
   microbatch: the bf16 weights and the float32 norm scales and biases
   end to end, padded to 16-byte rows) and at all its parameters' width
   unpadded, and at a narrow leaf (the CNN head's bias, N 10);
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
9. the paper's comparison on a fresh model of phase 6's width, batch and
   optimizer at ``ALGO_LAYERS`` layers, ``remat="none"``: at σ = 0 the bf16 clipped sums of one
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
   256 examples at once, one ``clip_reduce`` a parameter dtype into the
   flat float32 sums) under ``torch.profiler`` for ``clip_reduce``'s
   device time over the step; ε composed with the clip
   mechanism and its split.  On the CNN, each conv layer's gy in pass 1
   through the fused route against the plain backward's (``[fold]``), with
   the route's ``F.fold`` as the code has it and in the other type;
12. the memory planner and the host loop: (a) the planner's estimate of
   every training step whose peak the phases read (phase 6's, phase 8's
   32-layer ``block``, phase 9's ``dpsgd`` at microbatch 1 and 8, phase
   10's and phase 11's two), each taken inside its phase on its model and
   state, beside the measured peak: every ratio within the planner's
   ``TOLERANCE_FACTOR``; (b) at phase 6's shape on ``PLANNER_LAYERS``
   layers of phi3-mini, the planner's
   estimates at ``grad_accum`` 1 and 2 beside a measured step each, for
   ``dpsgd_r`` and for ``dpsgd`` with all 8 examples' gradients in one
   buffer; under ``mem.auto_microbatch`` with the budget at the midpoint
   of the two estimates the Trainer must split ``dpsgd``'s batch in 2,
   and that step's measured peak, printed beside the budget and the step
   at ``grad_accum`` 1's, must be below the latter (``dpsgd_r``'s split
   does not pay at this shape: its float32 gradient sum, carried across
   the chunks, outweighs the halved activations); (c) a budget below
   every split of a B 2 batch raises before any step; (d) the host-loop engine
   serving the first ``HOST_LOOP_REQUESTS`` of phase 5's request stream on
   phi3-mini at full size, its tok/s,
   TTFT and host reads beside the engine's, and each request's greedy
   stream's agreeing prefix against the engine's.  Phase 5 and (d) also
   profile a short serve of 8 requests x 8 tokens (``[decode]``): the device's busy
   share over the decode steps of the contiguous engine, the paged engine
   and the host loop;
13. the MoE family: (a) the kernels at its shapes (B 8 x T 512), float32
   and bf16, each against its plain version with exact zeros for a zeroed
   gy group and bit-identical repeats, timed beside the plain version, the
   library (``matmul`` batched over E for gx, ``bmm`` and the Frobenius
   sum for the norms) and the bound, with the path each takes:
   ``dense_bwd_norm``, ``pegrad_norm`` and ``dense_dgrad`` at
   deepseek-moe-16b's experts (512 groups of C 60, 2048 <-> 1408, E 64) and
   router, and at grok-1-314b's experts (64 groups of C 160, 6144 <->
   32768, E 8; plain versions 8 rows at a time), ``gram_norm`` square at
   deepseek's expert groups, the flash forward at deepseek's serving wave
   and grok's GQA (48 heads on 8), the backward at deepseek's training
   shape; (b) deepseek-moe-16b at full width on ``MOE_SERVE_LAYERS`` of its
   28 layers, bf16, seeded weights, serving the first ``MOE_REQUESTS`` of
   phase 5's stream through the contiguous and the paged engine (their
   outputs must agree), with tok/s,
   TTFT, decode ms a step beside the bytes bound of the experts it reads
   and the peak; (c) grok-1-314b at full width with 2 of its 64 layers,
   4 requests x 16 tokens through the contiguous engine; (d) deepseek
   trained at full width with 6 of its 28 layers (5 if the planner puts 6
   above ``MOE_PLAN_LIMIT``), B 8 x T 512, ``dpsgd_r`` fused + kernels,
   ``remat="block"``, AdamW: a warm-up and three counted steps, the
   planner's estimate beside their peak (within 4x), the norms² of one
   batch through ``materialize``, ``auto`` and the plain rules against the
   fused route's (``NSQ_RTOL``), a counted step of each, and a counted
   ``dpsgd_r1f`` step;
14. the SSM family: (a) the kernels at its shapes, bf16, each against its
   plain version with times, bounds, plain and library times and paths:
   ``dense_bwd_norm`` and ``pegrad_norm`` (a zeroed gy row exact, repeats
   bit-identical) at every distinct norm site of the training paths:
   mamba2-1.3b's in_proj (2048 -> 8512), out_proj (4096 -> 2048) and head
   (2048 -> 50432) at B 8 x T 4096; the cut of jamba-1.5-large-398b at B 8
   x T 512: q and o (8192 -> 8192), k and v (-> 1024), the dense FFN
   (8192 <-> 24576), in_proj (8192 -> 35072), out_proj (16384 -> 8192),
   the router (-> 16), the experts (8 x 16 groups of C 80, 8192 <-> 24576)
   and the head (-> 65536) (plain versions a slice of rows at a time where
   they would not fit); one example's zeroed rows or groups through
   ``dense_bwd_norm``, ``dense_dgrad`` and ``gram_norm`` at mamba2's
   in_proj and jamba's experts; ``gram_norm`` at both embeddings; the
   flash forward at jamba's serving wave (64 heads on 8, hd 128) and its
   training shape, the backward there; (b) mamba2-1.3b at full width on
   ``SSM_SERVE_LAYERS`` of its 48 layers, bf16, seeded weights, serving the
   first ``SSM_REQUESTS`` of phase 5's stream through the contiguous
   engine (equal-length waves,
   unpadded: a recurrent state would absorb pad tokens; the JAX engine's
   schedule, each wave decoding to the next completion) and the host loop,
   whose greedy streams must be equal; ``paged=True`` must raise; tok/s,
   TTFT, decode ms a step beside the bytes bound of its weights and SSM
   state, the peak; decode after a T-token prefill against the last row
   of a (T+1)-token prefill within ``CHAIN_TOL``; (c) jamba's layers 4-5
   at full width (attention with its dense FFN, Mamba with the 16-expert
   MoE; 11.93B params), 4 requests x 16 tokens through the contiguous
   engine, its decode beside the expert bytes it reads; (d) mamba2-1.3b
   trained at full width on ``SSM_TRAIN_LAYERS`` of its 48 layers, B 8 x
   T 4096 (B 4 if the planner puts
   B 8 above ``MOE_PLAN_LIMIT``), ``dpsgd_r`` fused + kernels,
   ``remat="block"`` (the SSD scan's per-chunk checkpoint inside each
   block), AdamW: a warm-up and ``SSM_STEPS`` counted steps (the last
   profiled), the planner's estimate beside their peak, the norms² of one
   batch through ``materialize``, ``auto`` and the plain rules against fused
   (``NSQ_RTOL``), the first two's pass 1 counted (``pass1_launches``);
   (e) the jamba cut's two passes of one counted fused step at B 8 x T
   512, beside the planner's estimate of the whole SGD step, which does
   not fit the card (float32 gradient sums and momentum of 11.93B
   params), and its norms² against pass 1 through the plain rules
   (``NSQ_RTOL``);
15. the embedding-input models, fed precomputed (B, T, d) embeddings (no
   embedding table, so no embedding site): (a) the kernels at their
   shapes, bf16, each against its plain version with times, bounds, plain
   and library times and paths (``embed_kernel_shapes``):
   ``dense_bwd_norm`` and ``pegrad_norm`` (a zeroed gy row exact, repeats
   bit-identical) at every distinct norm site of musicgen-medium at B 8 x
   T 1500 and of chameleon-34b at B 8 x T 512 (plain versions a slice of
   rows at a time where they would not fit), ``dense_dgrad`` at
   musicgen's, ``gram_norm`` square at every shape ``auto`` sends to it
   (chameleon's q/o, k/v, MLP and head), one example's zeroed rows through
   ``dense_bwd_norm``, ``dense_dgrad`` and ``gram_norm`` at musicgen's w1
   and at those, the flash forward at the serving prefills (musicgen's 8 x
   500 and 8 x 564, chameleon's 4 x 1008 and 4 x 1024), the flash pair at
   musicgen's 24 heads of hd 64 (T 1500) and chameleon's 64 heads on 8 at
   hd 128; (b) musicgen-medium
   at full width on ``MG_SERVE_LAYERS`` of its 48 layers, bf16, seeded
   weights: a prefill of 8 prompts of 500 embeddings, 64 decode steps each
   fed the next embedding through the contiguous cache and through the
   paged cache (their logits must agree), the last step's logits against
   one prefill over all 564 positions (``CHAIN_TOL``), a right-padded
   prefill with ``lengths`` against unpadded prefills of its rows (1e-3);
   prefill ms, TTFT, decode ms a step beside the weights' bytes bound,
   the peak; (c) chameleon-34b at full width and depth (48 layers, 33.76B
   params, qk-norm), init's peak within the params + ``INIT_SLACK``, 4
   prompts of 1008 positions and 16 decode steps with the same chaining
   check; (d) musicgen-medium trained at full width on
   ``MG_TRAIN_LAYERS`` of its 48 layers, B 8 x T 1500, ``dpsgd_r`` fused + kernels, ``remat="block"``, AdamW: the
   planner's estimate beside the peak of a warm-up and three counted
   steps, one profiled step, the norms² of one batch through
   ``materialize``, ``auto`` and the plain rules against fused
   (``NSQ_RTOL``; the first two's pass 1 counted), one counted Poisson
   step (padded rows' norms² exactly 0.0) and one counted ``dpsgd_r1f``
   step; (e) chameleon-34b trained at full width on ``CH_TRAIN_LAYERS``
   of its 48 layers (fewer while the planner puts the step above
   ``MOE_PLAN_LIMIT``), B 8 x T 512: a warm-up and two counted steps
   beside the planner's estimate, the norms² of one batch through the
   plain rules and ``auto`` (every site to ``gram_norm``, counted)
   against fused.  No phase steps through ``Trainer.run``, which
   checkpoints at its last step;
16. distribution: (a) phi3-mini at full width on ``PP_LAYERS`` of its 32
   layers, ``remat="block"``, ``dpsgd_r`` fused + kernels, B 8 x T 512,
   the blocks on the pipeline schedule (``pp_stages`` ``PP_STAGES``, M
   one a stage) against the sequential blocks on the same params and
   batch at σ = 0: norms² and losses within ``NSQ_RTOL``, clipped sums
   within ``CLIP_SUM_TOL``; then counted steps in turns on one AdamW state
   (launches against ``path_launches`` with M), their ms and peaks side by
   side; (b) the training launcher under ``torch.distributed.run`` in a
   world of 1 on NCCL: phi3-mini at full width on ``DIST_LAYERS`` layers,
   ZeRO-1, the int8 compression rider, ``pp_stages`` 2, σ 0, AdamW,
   ``DIST_STEPS`` steps, its checkpoints in a temporary directory; (c)
   the same, side by side with (b) and both beside phase 19's worlds (for
   the run's time: they start after phase 19's kernel checks and report
   after its lines), in 2 ranks sharing the card over gloo, each on half the batch: every rank's fingerprint equal to (b)'s, each step's loss and
   ``grad_norm_mean`` equal on both ranks and within ``NSQ_RTOL`` of
   (b)'s, each ZeRO-1 first moment of a shardable param in 2 shard files,
   and both checkpoints restored whole by the port's reader, a leaf at a
   time: params and first moments within ``CLIP_SUM_TOL`` of each leaf's
   max.  A world's nonzero exit or its ``DIST_TIMEOUT`` raises; the
   temporary directories are removed;
17. the launch tools (``launch/roofline.py``, ``costs.py``, ``autotune.py``):
   (a) ``[roofline]``: phase 6's step counted by one fake-tensor trace on
   the card's device, taken in phase 6 (the planner's row and the cost
   counter in one run): dot FLOPs by dtype, elementwise FLOPs, bytes, the
   trace's seconds, the ratio to 6·N·D, the H100's roofline terms and
   bottleneck, and beside phase 6's measured step the ``mfu`` and the
   compute term's share; its kernel records must equal this script's
   per-launch FLOP formulas (without the causal and symmetric-tile
   halvings) times ``path_launches`` to ``KERNEL_FLOPS_RTOL``; (b)
   ``[autotune]``: a solve on the card, phi3-mini at full width on
   ``TUNE_LAYERS`` layers, B 8 x T 512, ``dpsgd_r``, AdamW, the incumbent
   phase 6's route, a 72 GiB budget, kernel plans admitted, the seeded GA
   (``TUNE_POP`` x ``TUNE_GENS``), the ``TUNE_TOPK`` best predictions and
   the default measured: space, evals, traces, cache hits, the search's
   and the measurement's seconds, each measured plan's predicted and
   measured time and peak and its H100 terms, and the Spearman of
   predicted against measured; the winner no slower than the default,
   every measured peak within the planner's ``TOLERANCE_FACTOR`` of its
   estimate, no more traces than evaluations, and the kernels launched
   exactly as often as the measured plans' steps make them
   (``autotune_launches``); (c) the training launcher
   with ``--autotune`` at ``LAUNCH_TUNE_LAYERS`` layers for two steps,
   beside phase 18's worlds on the card (its output in
   ``chiprun_out/chip_smoke_autotune.log``): its autotune line, two step
   lines and the ``privacy spent`` line;
18. FSDP: chameleon-34b at full width on ``FSDP_LAYERS`` of its 48 layers
   through the launcher, B 8 x T 512 embeddings, ``dpsgd_r`` fused +
   kernels, ``remat="none"``, σ 0, ``FSDP_OPTIM``, ZeRO-1, ``FSDP_STEPS``
   steps: a world of 1 on NCCL and, side by side with it, 2 ranks sharing
   the card over gloo, each holding its half of every param
   ``param_shardings`` puts on ``data``; the checks of 16 (b)-(c) (``compare_worlds``,
   the losses to the 6 digits the launcher prints, the 2-rank
   checkpoint's params and momenta in 2 shard files), each rank's
   resident param and optimizer-state bytes half of world 1's within
   ``BYTES_RTOL``, and each rank's launches ``path_launches`` of its half
   batch;
19. the model and stage axes: ``dense_bwd_norm`` at every dense site's
   local shape on a model rank and the flash pair at its 16 heads of hd 96
   (``[kernel]`` lines, gated to the tensor-core paths as phase 3's), then
   phi3-mini-3.8b at full width on ``TP_LAYERS`` of its 32 layers through
   the launcher, B 8 x T 512, ``dpsgd_r`` fused + kernels,
   ``remat="none"``, σ 0, ``TP_OPTIM``, ``TP_STEPS`` steps, three worlds
   side by side: a world of 1 on NCCL, 2 ranks sharing the card over gloo
   on a (1, 2) data,model mesh, each holding half of the heads, FFN and
   vocabulary and taking the whole batch (``[tp]`` lines), and 2 ranks on
   a (1, 2) data,stage mesh with ``pp_stages`` 2, each holding one layer's
   blocks and the whole of the embedding, final norm and head (``[stage]``
   lines; ``chiprun_out/chip_smoke_tp{1,2,stage}.log``): the checks of 18
   with the losses and ``grad_norm_mean`` within ``NSQ_RTOL`` of world 1's,
   the resident bytes half of world 1's once the leaves each rank holds
   whole are added back, the model ranks' launches ``path_launches`` of the
   whole batch, the stage ranks' ``stage_launches`` of each (their sum the
   pipelined whole's), and the stage ranks' bytes a step by kind
   ``stage_moved``'s;
20. the dry-run and serving on model slices: (a) ``launch/dryrun.py``'s
   cells of phi3-mini (``DRYRUN_CELLS``: its three shapes on the (16, 16)
   ``data,model`` mesh, ``train_4k`` on the (2, 16, 16) ``pod,data,model``
   one), each one rank's trace on fake CUDA tensors, in subprocesses beside
   phases 17 (c), 18, 19 and 16 (b)-(c) (``chip_smoke.py --dryrun-cells``),
   whose gates read no time: every cell ``ok``,
   each train cell's rank peak under the card's memory, with its rank
   FLOPs, collective bytes, roofline terms and trace seconds printed; and
   chatglm3-6b's ``train_4k`` refused with its reason (``[dryrun]``); (b)
   ``flash_attn_fwd`` against its plain version at a model rank's prefill
   shape (4 x 16 heads, T 512, hd 96), then phi3-mini at full width on
   ``SERVE_TP_LAYERS`` of its 32 layers prefilling 4 prompts of 512 into a
   cache of 1024 and taking 32 greedy decode steps on 2 gloo ranks of a
   (1, 2) ``data,model`` mesh (``chip_smoke.py --serve-tp-rank`` under
   ``torch.distributed.run``) against a world of one on whole params of
   the same seed (``[serve-tp]``): greedy tokens equal, logits within
   ``SERVE_TP_TOL``, a rank's cache bytes half and param bytes half once
   the norm scales are added back, each rank's collectives of the prefill
   and of a decode step those of the dry-run's traced cells of the same
   configuration, ``flash_attn_fwd`` once a layer in each prefill.

A ``[disk]`` line sums the launchers' checkpoints, most of what the run
writes to the disk (each removed after its phase).

Each path counts the launches of every kernel from zero and must launch
each kernel exactly as often as the code says it does (``path_launches``,
by algorithm, norm route and remat policy): every kernel of the path at
least once, no other.  The line before the last
is the per-kernel JSON record; the last line is ``{"ok": true, "device":
{...}}``.
Imports nothing of JAX or of the JAX package.  Needs one card.  Run with
no arguments; ``--serve-tp-rank DIR`` and ``--dryrun-cells DIR GROUP``
are phase 20's subprocesses.
Measurements also go to ``chip_smoke.json`` in the output directory.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# clip_reduce's checks: the H100's L2 (50 MB), the copies of a small shape's
# operands its timed loops rotate among (enough for 4 x L2, at most this
# many), g's size above which a check keeps no second copy of g (phase 9's
# flat buffers: 8 layers of phi3-mini, 16 GB at B 8), and the elements of g
# its plain version takes at a time
L2_BYTES = 50 * 2**20
L2_COPIES = 256
WIDE_BYTES = 16 * 2**30
PLAIN_ELEMS = 2**27

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# float32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
F32_TOL = dict(rtol=2e-4, atol=2e-5)     # as tests/test_kernels.py
# time_ms: the longest a timed loop runs, ms (a slow call's iterations are
# cut to fit it, at least 1 after the warm-up call)
LOOP_MS = 150.0
BF16_ATOL = 2e-2                          # bf16 vs the plain version in f32
# the main path's traffic: 16 greedy requests, prompts of 64-1024 tokens,
# 64 new tokens each, through 8 slots of a 2048-position cache
N_REQUESTS, MAX_NEW, MAX_BATCH, CACHE_LEN, BLOCK = 16, 64, 8, 2048, 16
# the training path: 16 layers, 8 examples of 512 tokens, 3 timed steps
TRAIN_LAYERS, TRAIN_B, TRAIN_T, TRAIN_STEPS = 16, 8, 512, 3
# phase 12 (b)-(c)'s splits: phi3-mini at full width on PLANNER_LAYERS
# layers (cut for the run's time: the splits took 76.5 s at phase 6's 16
# on an H100 80GB HBM3 at 700 W)
PLANNER_LAYERS = 4
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
# phase 9 runs ALGO_LAYERS of phi3-mini's 32 layers: cut for the run's time
# (phase 9 took 52.9 s at 16 on an H100 80GB HBM3 at 700 W, 32.0 s of it
# the two dpsgd steps' memory traces)
ALGO_LAYERS = 8
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
# phase 12: the planner's estimates beside the measured peaks (filled in by
# the phases that read a peak), and the short serve the decode busy share
# is profiled on: the first 8 requests of the stream, 8 new tokens each.
# Cut for the run's time: the host loop serves the stream's first
# HOST_LOOP_REQUESTS requests (12 (d) took 36.6 s on all 16 on an H100
# 80GB HBM3 at 700 W)
MEMORY_ROWS = []
BUSY_REQUESTS, BUSY_NEW = 8, 8
HOST_LOOP_REQUESTS = 8
# phase 13: deepseek-moe-16b served and trained at full width on cuts of
# its 28 layers: trained on 6 (5 where the planner puts 6 above the limit);
# grok-1-314b at full width on 2 of its 64 layers, 4 requests x 16 tokens
MOE_ARCH, GROK_ARCH = "deepseek-moe-16b", "grok-1-314b"
# cut for the run's time: deepseek serves the stream's first
# MOE_REQUESTS requests, one wave of the 8 slots (13 (b)-(c) took 58.9 s
# on all 16 on an H100 80GB HBM3 at 700 W)
MOE_REQUESTS = 8
# and serves MOE_SERVE_LAYERS of its 28 layers (cut for the run's time: 13
# (b)-(c) took 57.5 s at 28 on an H100 80GB HBM3 at 700 W)
MOE_SERVE_LAYERS = 14
MOE_TRAIN_LAYERS, MOE_PLAN_LIMIT = 6, 72 * 2**30
GROK_LAYERS, GROK_REQUESTS, GROK_NEW = 2, 4, 16
# phase 14: mamba2-1.3b served and trained at full width on cuts of its
# depth (trained at train_4k's length, T 4096); jamba-1.5-large-398b at full width on its layers 4-5,
# served (4 requests x 16 tokens) and one step's passes at B 8 x T 512.
# CHAIN_TOL: decode after a prefill against the last row of a prefill one
# token longer, a share of the largest logit: two bf16 paths through up to
# 48 layers that round in other places
MAMBA2_ARCH, JAMBA_ARCH, SSM_T = "mamba2-1.3b", "jamba-1.5-large-398b", 4096
CHAIN_TOL = 5e-2
# the run's time: mamba2's serve takes the stream's first SSM_REQUESTS
# requests (on the JAX engine's schedule each distinct length is a wave
# decoding to its next completion: the whole stream took ~1008 steps of ~63
# ms), its training SSM_STEPS counted steps of ~13 s (the last profiled)
SSM_REQUESTS, SSM_STEPS = 4, 2
# cut for the run's time: mamba2 trains SSM_TRAIN_LAYERS of its 48
# layers (phase 14 (d) took 114.5 s at 48 on an H100 80GB HBM3 at 700 W)
SSM_TRAIN_LAYERS = 8
# and serves SSM_SERVE_LAYERS of them (cut for the run's time: 14 (b) took
# 28.0 s at 48 on an H100 80GB HBM3 at 700 W)
SSM_SERVE_LAYERS = 24
# phase 15: the embedding-input models.  musicgen-medium (arXiv:2306.05284)
# at full width, served to 8 prompts of 500 precomputed frame
# embeddings (10 s of audio at EnCodec's 50 Hz) and 64 decode steps, and
# trained at B 8 x T 1500 (30 s of audio, MusicGen's training crops);
# chameleon-34b (arXiv:2405.09818) served at full width and depth to 4
# prompts of 1008 positions and 16 decode steps, and trained at full width
# on 6 of its 48 layers (down to 4 while the planner puts the step above
# MOE_PLAN_LIMIT).  INIT_SLACK: seeded init's peak above the params' bytes
MUSICGEN_ARCH, CHAMELEON_ARCH = "musicgen-medium", "chameleon-34b"
MG_T, MG_PROMPT, MG_NEW = 1500, 500, 64
CH_REQUESTS, CH_PROMPT, CH_NEW = 4, 1008, 16
CH_TRAIN_LAYERS, CH_MIN_LAYERS = 6, 4
# musicgen trains MG_TRAIN_LAYERS of its 48 layers (cut for the run's time,
# phase 15 (d) took 44.8 s at 48 on an H100 80GB HBM3 at 700 W)
MG_TRAIN_LAYERS = 12
# and serves MG_SERVE_LAYERS of them (cut for the run's time: 15 (b) took
# 33.9 s at 48 on an H100 80GB HBM3 at 700 W)
MG_SERVE_LAYERS = 24
INIT_SLACK = 2 * 2**30
# phase 16: distribution.  (a) the pipeline schedule in one process:
# phi3-mini at full width on PP_LAYERS of its 32 layers, pp_stages
# PP_STAGES (M one a stage) against the sequential blocks on the same
# params; (b), (c) the launcher under torch.distributed.run at full width
# on DIST_LAYERS layers, DIST_STEPS steps: a world of 1 on NCCL, then 2
# ranks sharing the card over gloo; DIST_TIMEOUT bounds each world (s)
PP_LAYERS, PP_STAGES = 8, 4
DIST_LAYERS, DIST_STEPS, DIST_TIMEOUT = 2, 2, 600
# phase 18: FSDP.  chameleon-34b (arXiv:2405.09818) at full width on
# FSDP_LAYERS of its 48 layers through the launcher, FSDP_STEPS steps: a
# world of 1 on NCCL (FSDP a no-op), then 2 ranks sharing the card over
# gloo, each holding half of every sharded param; FSDP_TIMEOUT bounds each
# world (s); BYTES_RTOL: a rank's resident bytes against half of world 1's.
# Cut for the disk: the card's host takes at most 45 GiB (48.3 GB) of
# writes a run, deleted files included, and the launchers' checkpoints are
# most of them (the [disk] line).  On an H100 80GB HBM3 at 700 W, phases
# 16 and 17 (c) wrote 21.23 GB of them and phase 18's two SGD checkpoints
# 14.74 GB; two AdamW ones (14 bytes a param: bf16 params, float32 m,
# master and v) would be 34.4 GB at 1 layer, 53.2 GB at 2.  So 1 layer,
# not 2, and SGD with momentum (one float32 state a param), not AdamW
FSDP_LAYERS, FSDP_STEPS, FSDP_TIMEOUT = 1, 2, 300
FSDP_OPTIM = "sgd"
BYTES_RTOL = 1e-2
# phase 19: tensor parallelism.  phi3-mini at full width on TP_LAYERS of
# its 32 layers through the launcher, TP_STEPS steps: a world of 1 on NCCL,
# then, side by side with it, 2 ranks sharing the card over gloo on a (1, 2)
# data,model mesh, each holding half of the heads, FFN and vocabulary;
# TP_TIMEOUT bounds each world (s).  SGD with momentum for the disk, as
# phase 18; TP_SHAPES: the dense sites' local (d_in, d_out) on a rank
TP_LAYERS, TP_STEPS, TP_TIMEOUT = 2, 2, 300
TP_OPTIM = "sgd"
TP_SHAPES = (("tp-qkv", 3072, 1536), ("tp-o", 1536, 3072), ("tp-w1w3", 3072, 4096),
             ("tp-w2", 4096, 3072), ("tp-head", 3072, 16128))
# phase 20: the dry-run and serving on model slices.  (a) phi3-mini's cells
# DRYRUN_CELLS (shape, production mesh), each one rank's trace on fake CUDA
# tensors, and DRYRUN_REFUSED, a cell the port refuses; subprocesses beside
# phases 17 (c) to 19 (host-only tracing; no gate of phases 16 (b)-(c) and
# 17 (c) to 19 reads a time), DRYRUN_TIMEOUT bounding each (s).  (b) phi3-mini at full width on
# SERVE_TP_LAYERS of its 32 layers (cut for the run's time), seeded bf16
# weights: SERVE_TP_B prompts of SERVE_TP_T tokens into a cache of
# SERVE_TP_S, then SERVE_TP_STEPS greedy decode steps, on 2 gloo ranks of
# a (1, 2) data,model mesh against a world of one in this process;
# SERVE_TP_TIMEOUT bounds the ranks (s).  SERVE_TP_TOL: the logits of the
# two worlds, a share of the largest: each row-parallel sum (wo, w2, the
# embedding's rows) is two bf16 partial products rounded apart and then
# summed, where world 1 rounds one product, so the residual stream moves by
# about a bf16 ulp (2^-8 of a value) a sum, 17 sums deep; CHAIN_TOL's
# share for two bf16 paths that round in other places
DRYRUN_CELLS = (("train_4k", "single"), ("prefill_32k", "single"),
                ("decode_32k", "single"), ("train_4k", "multi"))
DRYRUN_REFUSED = ("chatglm3-6b", "train_4k", "single")
DRYRUN_TIMEOUT = 900
# (a)'s cells, one subprocess a group, side by side (a cell is one Python
# thread of fake-tensor dispatch: on an H100 80GB HBM3 host the (16, 16)
# train cell's two traces took 103.5 s, the (2, 16, 16) one's 38.2 s, the
# serving cells 5.9 s); the last group also traces (b)'s two cells
DRYRUN_GROUPS = ((0,), (3,), (1, 2))
SERVE_TP_LAYERS, SERVE_TP_B, SERVE_TP_T, SERVE_TP_S, SERVE_TP_STEPS = 8, 4, 512, 1024, 32
SERVE_TP_TIMEOUT = 300
SERVE_TP_TOL = CHAIN_TOL
# (b) runs in bf16 and again in float32 over the same bf16 weights: bf16
# logits a rank moves by an ulp take another greedy token at a near-tie of
# the top two (call 1: the streams parted after 8-22 steps), so the token
# streams are held equal in float32, where a row-parallel sum's reordering
# moves a logit by ~1e-6 of the largest; SERVE_TP_F32_TOL bounds that
# (a sum of up to 8192 float32 products reordered, ~sqrt(k) ulps, through
# 17 sums)
SERVE_TP_COMPUTE = ("bfloat16", "float32")
SERVE_TP_F32_TOL = 1e-3
# phase 17: the launch tools.  (b) a solve on the card: phi3-mini at full
# width on TUNE_LAYERS of its 32 layers (pipeline stages 1 and 2 divide
# them), B 8 x T 512, the GA's TUNE_POP x TUNE_GENS, the TUNE_TOPK best
# predictions and the default measured TUNE_ITERS steps each, the planner's
# budget TUNE_BUDGET; (c) the launcher's --autotune at LAUNCH_TUNE_LAYERS
# layers, its GA LAUNCH_TUNE_POP x LAUNCH_TUNE_GENS, the LAUNCH_TUNE_TOPK
# best and the default measured LAUNCH_TUNE_ITERS steps each,
# LAUNCH_TUNE_TIMEOUT bounding it (s).  Cut for the run's time (4 layers
# and the GA 8 x 3, then 4 x 2, took 120-190 s; the launcher's GA 4 x 2
# went to 4 x 1.  At 2 x 1, the top 1 measured 1 step, the launcher took
# as long: its time is its start and its models, not its GA).
# KERNEL_FLOPS_RTOL: the cost records' kernel FLOPs against this script's
# formulas
TUNE_LAYERS, TUNE_POP, TUNE_GENS, TUNE_TOPK, TUNE_ITERS = 2, 4, 2, 3, 3
TUNE_BUDGET = 72 * 2**30
LAUNCH_TUNE_LAYERS, LAUNCH_TUNE_POP, LAUNCH_TUNE_GENS = 2, 4, 1
LAUNCH_TUNE_TOPK, LAUNCH_TUNE_ITERS = 2, 2
LAUNCH_TUNE_TIMEOUT = 600
KERNEL_FLOPS_RTOL = 1e-9


def request_stream(vocab: int, seed: int = 0):
    """The main path's prompts, made with numpy from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = rng.integers(64, 1025, N_REQUESTS)
    return [rng.integers(0, vocab, int(n)) for n in lengths]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """``fn``'s mean ms over ``iters`` calls after ``warmup``, by CUDA
    events.  A slow call runs fewer times: from the first warm-up call's
    time, the timed calls are cut to fit ``LOOP_MS`` (at least 1), and a
    call over ``LOOP_MS`` / 4 gets no second warm-up."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    first = start.elapsed_time(end)
    iters = max(1, min(iters, int(LOOP_MS / max(first, 1e-3))))
    for _ in range(warmup - 1 if first <= LOOP_MS / 4 else 0):
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


def stopwatch(prefix):
    """``lap(label)``: prints ``[time] <prefix> <label>: <s>``, the seconds
    since the last lap (or since this call), and keeps them in
    ``lap.secs``."""
    last = [time.perf_counter()]

    def lap(label):
        now = time.perf_counter()
        lap.secs[label] = now - last[0]
        last[0] = now
        print(f"[time] {prefix} {label}: {lap.secs[label]:.1f} s", flush=True)
    lap.secs = {}
    return lap


def bound_ms(flops, nbytes, dtype_name):
    """Least time for the work: the FLOPs over the type's peak against the
    bytes (each input read once, each output written once) over HBM
    bandwidth.  Returns (ms, "operations" | "bytes")."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flash_fwd_flops(BH, T, S, hd, causal):
    """The forward's two products, QK^T and PV (halved when causal)."""
    return 4.0 * BH * T * S * hd * (0.5 if causal else 1.0)


def flash_bound_ms(BH, T, S, hd, rep, causal, dtype_name):
    """The forward: QK^T and PV (halved when causal); q, k, v read, o and
    lse written."""
    item = 2 if dtype_name == "bfloat16" else 4
    flops = flash_fwd_flops(BH, T, S, hd, causal)
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


def gram_flops(BG, T, di, do, square, tiles=True):
    """The s <= t tile pairs of C = gy·gyᵀ (and A = x·xᵀ when square);
    every pair (the plain version's products) without ``tiles``."""
    pairs = T * (T + 1) if tiles else 2 * T * T
    return 1.0 * BG * pairs * (do + (di if square else 0))


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


def dense_flops(BG, T, di, do):
    """One dense launch's product: the norm launch's x_bᵀ gy_b, or the gx
    launch's gy · wᵀ: 2·BG·T·di·do."""
    return 2.0 * BG * T * di * do


def norm_bound_ms(BG, T, di, do, dtype_name):
    """The norm launch, ‖x_bᵀ gy_b‖² per row: 2·BG·T·di·do FLOPs; x and gy
    read, one float32 a row written."""
    item = 2 if dtype_name == "bfloat16" else 4
    return bound_ms(dense_flops(BG, T, di, do), item * BG * T * (di + do) + 4 * BG,
                    dtype_name)


def dgrad_bound_ms(BG, T, di, do, E, dtype_name):
    """gx = gy · wᵀ: 2·BG·T·di·do FLOPs; gy and w read, gx written."""
    item = 2 if dtype_name == "bfloat16" else 4
    return bound_ms(dense_flops(BG, T, di, do),
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


def by_rows(fn, rows, rowwise, whole=()):
    """``fn(*rowwise, *whole)`` on slices of ``rows`` rows of each (BG, ...)
    tensor of ``rowwise`` at a time, the results (a tensor or a tuple of
    them) concatenated along dim 0; ``whole`` (an (E, ...) weight) rides
    whole, so ``rows`` must be a multiple of E (row b of a slice keeps
    group b % E).  ``rows`` None: one call.  For the plain versions and the
    library calls at shapes whose float32 transients would not fit the
    card at once."""
    import torch
    if rows is None:
        return fn(*rowwise, *whole)
    assert not whole or rows % whole[0].shape[0] == 0, (rows, whole[0].shape)
    outs = [fn(*(a[i:i + rows] for a in rowwise), *whole)
            for i in range(0, rowwise[0].shape[0], rows)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def gx_library(gy, w, E):
    """The library's gx call (timing only): ``matmul`` of gy against wᵀ,
    batched over E with each expert's B·T rows when E > 1 (gy taken
    E-major, as the port's plain ``moe_dense`` takes it), so w is never
    expanded over the examples.  Returns (call, its E-major gy)."""
    import torch
    if E == 1:
        wt = w[0].t()
        return (lambda: torch.matmul(gy, wt)), gy
    BG, T, do = gy.shape
    ge = gy.reshape(BG // E, E, T, do).transpose(0, 1).reshape(E, -1, do)
    wt = w.mT
    return (lambda: torch.matmul(ge, wt)), ge


def norm_library(x, gy, rows=None):
    """The library's norms² (timing only): ``bmm`` of xᵀ and gy per row and
    the Frobenius sum, ``rows`` rows at a time."""
    import torch
    return by_rows(lambda a, b: (torch.bmm(a.mT, b).float() ** 2).sum(dim=(1, 2)),
                   rows, (x, gy))


def check_dense_bwd_norm(name, BG, T, di, do, E, dtype, seed=0, iters=10,
                         rows=None):
    """dense_bwd_norm at one shape: kernel vs plain version (gx within 1e-4
    of its largest entry in f32, 1e-2 in bf16 — one bf16 rounding of the
    output; nsq within rtol 1e-4, since bf16 inputs convert to f32
    exactly and only the summation order differs), with timings.  ``rows``:
    the plain version and the library's norms² a slice of rows at a time
    (``by_rows``)."""
    import torch
    from repro_torch.kernels import fused_bwd, pegrad_norm, ref
    x, gy, w = dense_inputs(BG, T, di, do, E, dtype, seed)
    path = fused_bwd.dgrad_path(gy, w)
    norm_path = pegrad_norm.norm_path(x, gy)
    gx, nsq = fused_bwd.dense_bwd_norm(x, gy, w)
    torch.cuda.synchronize()
    nsq_ref = by_rows(ref.pegrad_norm_ref, rows, (x, gy))
    gx_f32 = by_rows(ref.dense_dgrad_ref, rows, (gy.float(),), (w.float(),))
    abs_err = (gx.float() - gx_f32).abs().max().item()
    gx_err = abs_err / gx_f32.abs().max().item()
    nsq_err = ((nsq - nsq_ref).abs() / nsq_ref.abs()).max().item()
    assert gx_err <= (1e-4 if dtype == torch.float32 else 1e-2), (name, gx_err)
    assert nsq_err <= 1e-4, (name, nsq_err)
    del gx, gx_f32
    ms = time_ms(lambda: fused_bwd.dense_bwd_norm(x, gy, w), iters)
    plain_ms = time_ms(lambda: by_rows(ref.dense_bwd_norm_ref, rows, (x, gy), (w,)),
                       iters)
    gx_call, ge = gx_library(gy, w, E)

    def library():      # timing only: the port never calls these
        gx_call()
        return norm_library(x, gy, rows)
    library_ms = time_ms(library, iters)
    del ge
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


def check_pegrad_norm(name, x, gy, iters=10, rows=None):
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
    nsq_ref = by_rows(ref.pegrad_norm_ref, rows, (x, gy))
    nsq_abs = (nsq - nsq_ref).abs().max().item()
    nsq_err = ((nsq - nsq_ref).abs() / nsq_ref.abs()).max().item()
    assert nsq_err <= 1e-4, (name, nsq_err)
    dt = _dtype_name(x.dtype)
    ms = time_ms(lambda: pegrad_norm.pegrad_norm(x, gy), iters)
    plain_ms = time_ms(lambda: by_rows(ref.pegrad_norm_ref, rows, (x, gy)), iters)
    # timing only: the port never calls it
    library_ms = time_ms(lambda: norm_library(x, gy, rows), iters)
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


def check_dense_halves(name, BG, T, di, do, E, dtype, seed=0, iters=10,
                       rows=None, ab=True):
    """pegrad_norm and dense_dgrad at one shape: each against its plain
    version (``check_pegrad_norm``; gx as in ``check_dense_bwd_norm``) and
    both equal to dense_bwd_norm's outputs bit for bit, with timings; then,
    with ``ab``, the fusion A/B, the separate pair (two wrapper calls)
    against dense_bwd_norm (one call), timed in turns (pair, fused, fused,
    pair).  ``rows`` as in ``check_dense_bwd_norm``.  Returns
    {"pegrad_norm": rec, "dense_dgrad": rec, "ab": rec or None}."""
    import torch
    from repro_torch.kernels import fused_bwd, pegrad_norm, ref
    x, gy, w = dense_inputs(BG, T, di, do, E, dtype, seed)
    path = fused_bwd.dgrad_path(gy, w)
    pegrad, nsq = check_pegrad_norm(name, x, gy, iters, rows)
    pegrad["E"] = E
    gx = fused_bwd.dense_dgrad(gy, w)
    fgx, fnsq = fused_bwd.dense_bwd_norm(x, gy, w)
    torch.cuda.synchronize()
    assert torch.equal(nsq, fnsq) and torch.equal(gx, fgx), name
    del fgx, fnsq
    gx_f32 = by_rows(ref.dense_dgrad_ref, rows, (gy.float(),), (w.float(),))
    gx_abs = (gx.float() - gx_f32).abs().max().item()
    gx_err = gx_abs / gx_f32.abs().max().item()
    assert gx_err <= (1e-4 if dtype == torch.float32 else 1e-2), (name, gx_err)
    del gx, gx_f32
    dt = _dtype_name(dtype)
    flops = 2.0 * BG * T * di * do
    base = dict(shape=name, dtype=dt, BG=BG, T=T, di=di, do=do, E=E)
    gx_call, ge = gx_library(gy, w, E)
    b_ms, b_by = dgrad_bound_ms(BG, T, di, do, E, dt)
    dgrad = dict(base, max_abs_err=gx_abs, rel_err=gx_err,
                 ms=time_ms(lambda: fused_bwd.dense_dgrad(gy, w), iters),
                 plain_ms=time_ms(lambda: by_rows(ref.dense_dgrad_ref, rows, (gy,),
                                                  (w,)), iters),
                 library_ms=time_ms(gx_call, iters),
                 bound_ms=b_ms, bound_by=b_by, path=path)
    del ge
    dgrad.update(tflops=flops / dgrad["ms"] / 1e9, bound_share=b_ms / dgrad["ms"])
    r = dgrad
    print(f"[kernel] dense_dgrad {name} {dt}: max_abs_err {r['max_abs_err']:.2e} "
          f"({r['rel_err']:.1e} rel)  kernel {r['ms']:.3f} ms  plain "
          f"{r['plain_ms']:.3f} ms  library {r['library_ms']:.3f} ms  bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']})  {r['tflops']:.1f} TFLOP/s, "
          f"{100 * r['bound_share']:.1f}% of bound, path {r['path']}", flush=True)
    if not ab:
        return {"pegrad_norm": pegrad, "dense_dgrad": dgrad, "ab": None}
    sep = lambda: (fused_bwd.dense_dgrad(gy, w), pegrad_norm.pegrad_norm(x, gy))
    fused = lambda: fused_bwd.dense_bwd_norm(x, gy, w)
    before = fused_bwd.DGRAD_LAUNCHES
    runs = [time_ms(sep, iters), time_ms(fused, iters), time_ms(fused, iters),
            time_ms(sep, iters)]
    sep_ms, fused_ms = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
    ab = dict(base, separate_ms=sep_ms, fused_ms=fused_ms,
              separate_over_fused=sep_ms / fused_ms, runs_ms=runs,
              dgrad_launches=fused_bwd.DGRAD_LAUNCHES - before)
    print(f"[fusion] {name} {dt}: pegrad_norm and dense_dgrad = dense_bwd_norm's "
          f"outputs bit for bit; dense_dgrad + pegrad_norm {sep_ms:.3f} ms, "
          f"dense_bwd_norm {fused_ms:.3f} ms, separate / fused "
          f"{sep_ms / fused_ms:.4f} (runs {', '.join(f'{v:.3f}' for v in runs)})",
          flush=True)
    return {"pegrad_norm": pegrad, "dense_dgrad": dgrad, "ab": ab}


def device_ms(fn, iters: int = 10, warmup: int = 2, label: str = "",
              floor_ms: float = 0.0):
    """Device time of one ``fn()`` from ``torch.profiler`` over ``iters``
    calls (``profile_ms``).  Where a call's host work outlasts its kernels
    (small shapes), ``time_ms`` times the host's launch rate and this the
    card.  A profile is kept only if it recorded a kernel and its time is
    not below ``floor_ms`` (the least time the work can take, so a shorter
    record is the profiler's and not the card's: one profile of a 3.2 ms
    launch has given 1.5 ms).  After three profiles that fail it returns
    None (not measured) and a ``[timer]`` line says why."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    why = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms, fault = profile_ms(_kernel_spans(prof), iters, floor_ms)
        if fault is None:
            return ms
        why.append(fault)
    print(f"[timer] {label}: torch.profiler's three profiles gave {'; '.join(why)}; "
          f"device time not measured", flush=True)
    return None


def profile_ms(spans, iters: int, floor_ms: float = 0.0):
    """(ms a call, None) from the (name, µs) ``spans`` of ``iters`` calls:
    for each kernel (by name) its mean duration times its launches a call,
    summed, so that a launch the profiler did not record (one in each of
    the image rows' profiles) lowers no mean.  Or (None, what is wrong):
    no kernel, or a time below ``floor_ms``."""
    by_name = {}
    for name, us in spans:
        by_name.setdefault(name, []).append(us)
    if not by_name:
        return None, "no kernel"
    ms = sum(sum(d) / len(d) * max(1, round(len(d) / iters))
             for d in by_name.values()) / 1e3
    if ms < floor_ms:
        return None, f"{ms:.4f} ms < the bound's {floor_ms:.4f} ms"
    return ms, None


def _device_events(prof):
    """(name, start µs, end µs) of every device activity a ``torch.profiler``
    run recorded, read from its raw kineto records: ``prof.events()`` first
    parses every record into a ``FunctionEvent``, which took ~50 s after an
    image ``dpsgd`` step of some 10^5 launches."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and e.duration_ns() > 0]


def _kernel_spans(prof):
    """(name, µs) of every device activity a ``torch.profiler`` run
    recorded."""
    return [(name, end - start) for name, start, end in _device_events(prof)]


def clip_bound_ms(B, N, item, accumulate=False):
    """g read, c read, out written (and read, accumulating): bytes, at any
    B (2·B·N FLOPs)."""
    return bound_ms(2.0 * B * N, item * B * N + 4 * B + (8 if accumulate else 4) * N,
                    "float32" if item == 4 else "bfloat16")


def check_clip_reduce(name, B, N, dtype, seed=0, iters=10):
    """clip_reduce at one shape against its plain version, fresh and added
    into a running float32 sum (``out=``): float32 sums in another order,
    within 1e-5 of max|g|·Σ|c| (the added one: of the running sum plus the
    plain sum, and equal to the running sum plus the fresh sum bit for
    bit).  Some rows get c_b = 0: in both modes the result must equal the
    reduction of the other rows, and a repeat, bit for bit.  The zeroed
    rows are a quarter of them, spread out, or where g is above
    ``WIDE_BYTES`` (phase 9's flat buffers) the first and the last, so that
    the compacted batch is a view of g (none at B 1); the plain
    version runs ``PLAIN_ELEMS`` elements of g at a time.  Times are
    event-timed loops (``time_ms``, as every kernel's): ``ms``, ``out_ms``,
    ``plain_ms``, ``library_ms`` (``torch.matmul``); ``device_ms``,
    ``out_device_ms`` and ``library_device_ms`` are the card's time from
    ``torch.profiler`` (``device_ms``; a profile shorter than the HBM bound
    is taken again, then not measured), which at the small shapes the host's
    launches hide from the event-timed loops.  Each loop rotates among
    enough copies of g and of the running sum to read 4 x L2 between two
    reads of one copy (at most ``L2_COPIES``); a shape whose copies still
    fit in 4 x L2 is ``l2_resident`` and its share of the HBM bound is not
    a roofline share.  Any other must not pass 105% of its bound."""
    import torch
    from repro_torch.kernels import clip_reduce, ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    item = torch.empty((), dtype=dtype).element_size()
    wide = B * N * item > WIDE_BYTES
    if wide:    # no float32 copy of g
        grads = torch.empty((B, N), dtype=dtype, device="cuda").normal_(generator=g)
    else:
        grads = _randn(g, (B, N), dtype)
    c = torch.rand((B,), generator=g, device="cuda")
    if wide:
        lo, hi = (1, B - 1) if B >= 3 else (0, B)
        c[:lo], c[hi:] = 0.0, 0.0
        compact = (grads[lo:hi], c[lo:hi].contiguous())
    else:
        c[1::4] = 0.0
        keep = c != 0
        compact = (grads[keep].contiguous(), c[keep].contiguous())
    acc0 = torch.randn((N,), generator=g, device="cuda")
    out = clip_reduce.clip_reduce(grads, c)
    assert torch.equal(out, clip_reduce.clip_reduce(grads, c)), name
    assert torch.equal(out, clip_reduce.clip_reduce(*compact)), name
    added = clip_reduce.clip_reduce(grads, c, out=acc0.clone())
    assert torch.equal(added, clip_reduce.clip_reduce(grads, c, out=acc0.clone())), name
    assert torch.equal(added, clip_reduce.clip_reduce(*compact, out=acc0.clone())), name
    del compact
    cols = max(1, PLAIN_ELEMS // B)
    g_max = abs_err = out_err = 0.0
    for s in range(0, N, cols):
        sl = slice(s, s + cols)
        want = ref.clip_reduce_ref(grads[:, sl], c)
        g_max = max(g_max, grads[:, sl].abs().max().item())
        abs_err = max(abs_err, (out[sl] - want).abs().max().item())
        out_err = max(out_err, (added[sl] - (acc0[sl] + want)).abs().max().item())
        assert torch.equal(added[sl], acc0[sl] + out[sl]), name
    del want, acc0, out
    scale = g_max * c.abs().sum().item()
    rel, rel_out = abs_err / scale, out_err / scale
    assert rel <= 1e-5 and rel_out <= 1e-5, (name, rel, rel_out)
    path = clip_reduce.clip_reduce_path(grads)

    nbytes = B * N * item + 4 * N
    copies = min(L2_COPIES, -(-4 * L2_BYTES // nbytes))
    l2_resident = copies * nbytes < 4 * L2_BYTES
    gs = [grads] + [grads.clone() for _ in range(copies - 1)]
    accs = [added] + [added.clone() for _ in range(copies - 1)]
    nxt = itertools.cycle(range(copies)).__next__   # one rotation for every loop
    n = 3 if wide else iters

    def plain(k):
        if not wide:
            return ref.clip_reduce_ref(gs[k], c)
        o = torch.zeros((N,), device="cuda")
        for s in range(0, N, cols):
            ref.clip_reduce_ref(gs[k][:, s:s + cols], c, out=o[s:s + cols])
        return o

    cg = c.to(dtype)
    label = f"clip_reduce {name} {_dtype_name(dtype)}"
    fns = {"": lambda k: clip_reduce.clip_reduce(gs[k], c),
           "out_": lambda k: clip_reduce.clip_reduce(gs[k], c, out=accs[k]),
           "library_": lambda k: torch.matmul(cg, gs[k])}     # timing only
    before = clip_reduce.LAUNCHES
    t = {f"{k}ms": time_ms(lambda: f(nxt()), n) for k, f in fns.items()}
    b_ms, b_by = clip_bound_ms(B, N, item)
    b_out_ms, _ = clip_bound_ms(B, N, item, accumulate=True)
    # the least device time each call can take from HBM (matmul writes g's
    # dtype); none where the copies fit in the L2
    floors = {"": b_ms, "out_": b_out_ms,
              "library_": bound_ms(2.0 * B * N, item * (B * N + B + N),
                                   _dtype_name(dtype))[0]}
    t.update({f"{k}device_ms": device_ms(
        lambda: f(nxt()), n, label=f"{label} {k}",
        floor_ms=0.0 if l2_resident else floors[k] / 1.05) for k, f in fns.items()})
    launches = clip_reduce.LAUNCHES - before
    t["plain_ms"] = time_ms(lambda: plain(nxt()), n)
    del gs, accs
    dt = _dtype_name(dtype)
    shares = {k: b / t[k] for k, b in (("ms", b_ms), ("out_ms", b_out_ms),
                                       ("device_ms", b_ms), ("out_device_ms", b_out_ms))
              if t[k] is not None}
    rec = dict(shape=name, dtype=dt, B=B, N=N, path=path, max_abs_err=abs_err,
               rel_err=rel, out_rel_err=rel_out, **t, bound_ms=b_ms,
               out_bound_ms=b_out_ms, bound_by=b_by, launches=launches,
               copies=copies, l2_resident=l2_resident, share_of_bound=shares)

    def ms_(k):
        return "not measured" if t[k] is None else f"{t[k]:.4f} ms"

    def share(k):
        return "L2-resident" if l2_resident else (
            f"{100 * shares[k]:.1f}% of bound" if k in shares else "-")

    zeroed = f"{int((c == 0).sum())} of {B} rows zeroed"
    print(f"[kernel] clip_reduce {name} {dt} (B {B} x N {N}, path {path}): max_abs_err "
          f"{abs_err:.2e} ({rel:.1e} of max|g|·Σ|c|; out= {rel_out:.1e}); {zeroed}, = "
          f"compacted bit for bit in both modes; event-timed over {copies} copies: "
          f"kernel {ms_('ms')} ({share('ms')}), out= {ms_('out_ms')} "
          f"({share('out_ms')}), plain {ms_('plain_ms')}, matmul {ms_('library_ms')}; "
          f"device time: kernel {ms_('device_ms')} ({share('device_ms')}), out= "
          f"{ms_('out_device_ms')} ({share('out_device_ms')}), matmul "
          f"{ms_('library_device_ms')}; bound {b_ms:.4f} ms ({b_by})", flush=True)
    assert l2_resident or max(shares.values()) <= 1.05, (name, shares)
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
# the flash forward and backward at phi3's, chatglm3's, the ViT's and musicgen's head
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
                     "mma12bwd_q_kernelILi32E",
                     # musicgen-medium's (phase 15)
                     "mma16flash_fwd_kernelILi64E", "mma13bwd_kv_kernelILi64E",
                     "mma12bwd_q_kernelILi64E")


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


# the decoder families whose launches are counted from their norm sites; the
# embedding-input ones (embed_stub) among them, which have no embedding site
EMBED_STUB_FAMILIES = ("audio", "vlm")
SITE_FAMILIES = ("moe", "ssm", "hybrid") + EMBED_STUB_FAMILIES


def norm_sites(arch, B=TRAIN_B, T=TRAIN_T):
    """Every norm site call of one decoder forward at B x T, one per weight
    matrix (the embedding apart; a Mamba layer's (K, C) conv weight is a
    tap): (kind, operand shapes, gy shape) of the ``dense`` sites (x (B, T,
    d_in)) and the ``moe_dense`` sites (x (B, E, C, d_in), C the capacity
    at T), in layer order, the head last."""
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import group_layers, model_spec
    spec = model_spec(arch)
    pre, _, reps = group_layers(arch)
    layers = list(spec["prelude"]) + list(spec.get("blocks", ())) * reps
    weights = [p for layer in layers for part, sub in layer.items()
               if isinstance(sub, dict) for name, p in sub.items()
               if (part, name) != ("mamba", "conv_w")]
    out = []
    for p in weights + [spec["head"]]:
        if len(p.shape) == 2:
            out.append(("dense", ((B, T, p.shape[0]), p.shape), (B, T, p.shape[1])))
        elif len(p.shape) == 3:
            E, di, do = p.shape
            C = capacity(arch.moe, T)
            out.append(("moe_dense", ((B, E, C, di), p.shape), (B, E, C, do)))
    return out


def launch_shape(arch, B=TRAIN_B, T=TRAIN_T):
    """``path_launches``'s keywords for ``arch``'s family: the dense
    decoder's layer count; the MoE, SSM, hybrid and embedding-input
    decoders', their norm sites and the kernels ``auto`` resolves them to
    at B x T (and, but for MoE, their attention layers; an embedding-input
    arch, no embedding); or the image family and, for the CNN, its conv2d
    sites."""
    if arch.family == "cnn":
        from repro_torch.models.cnn import iter_conv_sites
        return dict(L=0, family="cnn", convs=len(list(iter_conv_sites(arch))))
    if arch.family in SITE_FAMILIES:
        from repro_torch.configs.base import ATTN
        from repro_torch.core.sites import resolve_strategy
        picks = [resolve_strategy(k, "auto", ops, gy)
                 for k, ops, gy in norm_sites(arch, B, T)]
        out = dict(L=arch.n_layers, family=arch.family, sites=len(picks),
                   auto_norms=(picks.count("materialize"), picks.count("gram")))
        if arch.family != "moe":
            out["attn"] = arch.pattern().count(ATTN)
        if arch.embed_stub:
            out["embeds"] = 0
        return out
    return dict(L=arch.n_layers, family=arch.family)


def path_launches(route: str, L: int, chunks: int = 1, algo: str = "dpsgd_r",
                  remat: str = "none", examples: int = 0, microbatch: int = 0,
                  dtype_groups: int = 0, family: str = "dense", convs: int = 0,
                  sites: int = 0, auto_norms=(0, 0), attn=None, embeds: int = 1,
                  microbatches: int = 1, head: int = 1):
    """Launches of every kernel in one step of ``algo``, as the code makes
    them.  The dense decoder with ``L`` layers: each layer has 7 dense
    sites (q, k, v, o, w1, w3, w2) and one attention, the model one head
    and one embedding.  The MoE decoder (``family="moe"``, ``L`` layers):
    one attention a layer, the embedding, and ``sites`` norm sites
    (``norm_sites``: a dense layer's 7; an MoE layer's q, k, v, o, the
    router, the experts' w1, w3, w2 (``moe_dense``) and the shared
    experts' w1, w3, w2; the head), ``auto`` sending ``auto_norms`` =
    (materialize, gram) of them to ``pegrad_norm`` and ``gram_norm``.  The
    SSM and hybrid decoders (``family="ssm"``, ``"hybrid"``) count as the
    MoE one does, with ``attn`` attention layers (none in the SSM): a Mamba
    layer's norm sites are its in and out projections (its conv weight and
    four vectors are taps, and its SSD scan is plain PyTorch).  The
    embedding-input decoders (``family="audio"``, ``"vlm"``) count as the
    SSM one does with ``embeds=0``: their inputs are precomputed
    embeddings, so no embedding site and no embedding ``gram_norm``.  The
    ViT (``family="vit"``, ``L`` layers): 6 dense
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
    ``gram_norm``; ``auto-2048`` is the decoder at T 2048, where the FLOP
    formulas send q, k, v, o to ``pegrad_norm`` and w1, w3, w2 and the
    head to ``gram_norm``; ``auto`` takes the caller's ``auto_norms``
    (``plan_launches`` counts the dense decoder's at any T).  ``sgd`` is
    one forward and one backward; ``dpsgd`` one of each per example
    (``examples`` of them), and one ``clip_reduce`` per parameter dtype
    (``dtype_groups``: one flat buffer of per-example gradients each,
    ``clipping.flat_stacks``) per chunk of ``microbatch`` examples (0 =
    all).  Under ``block`` and ``sites`` every
    backward recomputes every block's forward once more, so its flash
    forwards.  ``chunks``: grad_accum, every chunk a full step's worth.
    ``microbatches``: the pipeline schedule's M (the dense decoder with
    ``pp_stages`` > 1): every block runs once a microbatch, so its sites
    and attention launch M times a pass; the embedding and the head, outside
    the stages, once.  ``embeds`` and ``head`` (the dense decoder): whether
    the step runs the embedding and the head (a stage rank runs the first
    on the first stage alone, the second on the last, ``stage_launches``)."""
    n = dict.fromkeys(read_counts(), 0)
    if microbatches != 1 and family != "dense":
        raise ValueError(f"microbatches are counted for the dense decoder, "
                         f"not {family!r}")
    if family == "dense":
        M = microbatches
        sites, dgrads, attn = 7 * L * M + head, 7 * L * M + head, L * M
    elif family == "vit":
        sites, dgrads, attn, embeds = 6 * L + 2, 6 * L + 1, L, 0
    elif family == "cnn":
        sites, dgrads, attn, embeds = convs + 1, convs, 0, 0
    elif family in SITE_FAMILIES:
        sites, dgrads, attn = sites, sites, L if attn is None else attn
    else:
        raise ValueError(family)
    again = 0 if remat == "none" else attn    # the recompute, per backward
    if algo == "sgd":
        n.update(flash_attn_fwd=attn + again, flash_attn_bwd=attn)
    elif algo == "dpsgd":
        n.update(flash_attn_fwd=examples * (attn + again),
                 flash_attn_bwd=examples * attn,
                 clip_reduce=dtype_groups * (examples // (microbatch or examples)))
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
        elif route == "auto" and (family in SITE_FAMILIES or family == "dense"):
            n["pegrad_norm"] = auto_norms[0]
            n["gram_norm"] += auto_norms[1]
        else:
            raise ValueError(route)
    else:
        raise ValueError(algo)
    return {k: v * chunks for k, v in n.items()}


def pass1_launches(route: str, **shape):
    """Launches of ``dpsgd_r``'s pass 1 alone (``algo.norm_pass``): the
    step's (``path_launches``) less pass 2's, which is one forward and one
    backward, as ``sgd``'s step."""
    step = path_launches(route, algo="dpsgd_r", **shape)
    two = path_launches(route, algo="sgd", **shape)
    return {k: step[k] - two[k] for k in step}


def dtype_groups(params) -> int:
    """The parameter dtypes of ``params``: ``dpsgd``'s flat buffers, one
    ``clip_reduce`` launch each a microbatch."""
    from repro_torch import tree
    return len({p.dtype for p in tree.leaves(params)})


def zero_counts():
    """Every kernel wrapper's launch count set to 0."""
    from repro_torch import kernels
    kernels.reset_launch_counts()


def read_counts():
    """Every kernel wrapper's launch count (``kernels.launch_counts``)."""
    from repro_torch import kernels
    return kernels.launch_counts()


def memory_row(label, trainer, state, measured, est=None, trace_s=None):
    """The planner's estimate of ``trainer``'s step on ``state`` at its next
    batch's shapes (``Trainer.memory_report``, a trace on fake tensors) beside
    ``measured``, the peak its phase read; a row of phase 12(a).  The trace
    launches no kernel and counts none.  ``est``: the report of a trace of
    the same step taken before (and its ``trace_s``), used as it is."""
    if est is None:
        counts = read_counts()
        t = time.perf_counter()
        est = trainer.memory_report(state, trainer.make_batch(state.step))
        trace_s = time.perf_counter() - t
        assert read_counts() == counts, ("the planner's trace counted launches",
                                         counts, read_counts())
    row = dict(label=label, estimate_bytes=est["peak_bytes"],
               measured_bytes=int(measured), ratio=est["peak_bytes"] / measured,
               arg_bytes=est["arg_bytes"], transient_bytes=est["transient_bytes"],
               per_example_grad_bytes=est["per_example_grad_bytes"],
               peak_op=est["peak_op"], trace_s=trace_s)
    MEMORY_ROWS.append(row)
    print(f"[memory] {label}: estimate {row['estimate_bytes'] / 2**30:.2f} GiB "
          f"(resident {row['arg_bytes'] / 2**30:.2f} + transient "
          f"{row['transient_bytes'] / 2**30:.2f}, peak at {row['peak_op']}) / "
          f"measured {row['measured_bytes'] / 2**30:.2f} GiB = {row['ratio']:.3f}; "
          f"trace {trace_s:.1f} s", flush=True)
    return row


def decode_busy(kind, make_engine, method, prompts, max_new, step_ms):
    """Serve ``prompts`` (``max_new`` greedy tokens each) on a fresh engine
    from ``make_engine()`` under ``torch.profiler``, each call of its decode
    ``method`` synced at both ends and marked: the device's busy share
    (the union of kernel intervals) over the marked decode windows, and
    the device's busy ms a decode step beside ``step_ms``, the unprofiled
    run's ms a step (the profiler's own host work lengthens the windows,
    not the kernels)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.serve.scheduler import Request
    eng = make_engine()
    inner = getattr(eng, method)

    def marked(*args, **kw):
        torch.cuda.synchronize()
        with record_function("decode_window"):
            inner(*args, **kw)
            torch.cuda.synchronize()

    setattr(eng, method, marked)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p.astype(np.int32), max_new=max_new))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run()
        torch.cuda.synchronize()
    steps = eng.stats["decode_steps"]
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the host's marks; the profiler also copies each mark onto the device's
    # timeline as an annotation, which is no kernel
    windows = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.name == "decode_window" and e.device_type != cuda)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == cuda and e.name != "decode_window"
                   and e.time_range.end > e.time_range.start)
    del eng
    gc.collect()
    if not windows or not spans:
        print(f"[decode] {kind}: the profiler recorded no decode window or no "
              f"device activity; busy share not measured", flush=True)
        return dict(engine=kind, busy_share=None)
    total = sum(b - a for a, b in windows)
    busy = 0.0
    for lo, hi in windows:
        cur_lo = cur_hi = None
        for a, b in spans:
            a, b = max(a, lo), min(b, hi)
            if a >= b:
                continue
            if cur_hi is None or a > cur_hi:
                if cur_hi is not None:
                    busy += cur_hi - cur_lo
                cur_lo, cur_hi = a, b
            else:
                cur_hi = max(cur_hi, b)
        if cur_hi is not None:
            busy += cur_hi - cur_lo
    rec = dict(engine=kind, windows=len(windows), steps=steps,
               decode_ms=total / 1e3, busy_ms=busy / 1e3, busy_share=busy / total,
               busy_ms_per_step=busy / 1e3 / steps, step_ms=step_ms,
               busy_share_unprofiled=busy / 1e3 / steps / step_ms)
    print(f"[decode] {kind}: {len(prompts)} requests x {max_new} new tokens under "
          f"torch.profiler: {len(windows)} decode calls over {steps} steps, "
          f"{rec['decode_ms']:.1f} ms inside them, device busy {rec['busy_ms']:.1f} "
          f"ms = {100 * rec['busy_share']:.1f}% (idle "
          f"{100 * (1 - rec['busy_share']):.1f}%); {rec['busy_ms_per_step']:.2f} ms of "
          f"device time a step against the unprofiled run's {step_ms:.2f} ms a step: "
          f"{100 * rec['busy_share_unprofiled']:.1f}% busy", flush=True)
    return rec


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
                   host_syncs=eng.stats["host_syncs"], flash_launches=n_launch,
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
    from repro_torch.serve.engine import Engine
    busy = [decode_busy(kind, lambda paged=paged: Engine(
                model, max_batch=MAX_BATCH, cache_len=CACHE_LEN, paged=paged,
                block_size=BLOCK), "_decode_chunk", prompts[:BUSY_REQUESTS],
                BUSY_NEW, runs[kind][1]["decode_ms_per_step"])
            for kind, paged in (("contiguous", False), ("paged", True))]
    return ([rec for _, rec in runs.values()], launches, breakdown,
            runs["contiguous"][0], busy)


# the port's kernels as the profiler names them (substrings of the device
# function names), for each one's share of a profiled step
PROFILE_KERNELS = {"flash_attn_fwd": ("flash_fwd_kernel",),
                   "flash_attn_bwd": ("bwd_kv_kernel", "bwd_q_kernel"),
                   "gram_norm": ("gram_kernel",),
                   "norm launch": ("norm_kernel",),
                   "gx launch": ("dgrad_kernel",)}


def profile_step(run, label):
    """One more training step under ``torch.profiler`` (device activity
    only: no number here reads the host's op records, and for a step of
    tens of thousands of launches they cost the profiler tens of seconds
    to gather): the device
    time of every kernel by name, each of the port's kernels' share of the
    step's wall time (``PROFILE_KERNELS``), and the device's busy share
    (busy = the union of kernel intervals on the timeline)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rec = run()
    kernels = _device_events(prof)
    if not kernels:
        print("[profile] the profiler recorded no device activity: device "
              "time and idle share not measured", flush=True)
        return dict(step_ms=rec["step_ms"], device_busy_ms=None)
    spans = sorted((start, end) for _, start, end in kernels)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy = (busy + hi - lo) / 1e3                         # us -> ms
    by_name = {}
    for name, start, end in kernels:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
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


def kernel_device_ms(run, piece):
    """``run()`` under ``torch.profiler`` (device activity only): the summed
    device time and the count of the kernels whose name holds ``piece``,
    their names, and ``run``'s step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rec = run()
        torch.cuda.synchronize()
    hits = [(name, us) for name, us in _kernel_spans(prof) if piece in name]
    return dict(ms=sum(us for _, us in hits) / 1e3, launches=len(hits),
                names=sorted({name[:60] for name, _ in hits}), step_ms=rec["step_ms"])


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


def counted_step(trainer, model, state, route, chunks=1, split=True):
    """One timed Trainer step with every kernel count from zero, checked
    against ``path_launches`` (at the trainer's algorithm, the model's
    family and remat policy); then, with ``split``, its two passes again on
    its batch, at the clip norm the step used, outside the counted step,
    for the split.  Returns the step's record and the split's norms² and
    losses (None without the split)."""
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
                         remat=model.remat,
                         **launch_shape(model.arch, trainer.shape.global_batch,
                                        trainer.shape.seq_len))
    assert counts == want, (route, model.remat, counts, want)
    rec["launches"] = counts
    if not split:
        return rec, batch, None, None
    nsq, losses, rec["pass1_ms"], rec["pass2_ms"] = split_passes(
        model, state, trainer.cfg.dp, batch, clip)
    rec["noise_opt_ms"] = rec["step_ms"] - rec["pass1_ms"] - rec["pass2_ms"]
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
    # one fake-tensor trace of the step feeds the planner's row and phase
    # 17 (a)'s costs (launch/costs.py's counter beside the live bytes)
    from repro_torch.launch.memory import abstract_like, estimate_train_memory
    counts = read_counts()
    t = time.perf_counter()
    est = estimate_train_memory(model, cfg, abstract_like(trainer.make_batch(state.step)),
                                costs=True)
    trace_s = time.perf_counter() - t
    assert read_counts() == counts, ("the trace counted launches", counts, read_counts())
    memory_row(f"phase 6: {TRAIN_LAYERS} layers, remat none, dpsgd_r fused",
               trainer, state, peak, est=est, trace_s=trace_s)

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
               dp_over_sgd=ratio, launches=launches, profile=prof,
               costs=est["costs"], costs_trace_s=trace_s)
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

    out, launches = {}, dict.fromkeys(read_counts(), 0)

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
    out, launches = {}, dict.fromkeys(read_counts(), 0)

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
    memory_row(f"phase 8: {arch.n_layers} layers, remat block, dpsgd_r fused",
               trainer, state, steps[-1]["peak_bytes"])
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
    arch = dataclasses.replace(get_arch("phi3-mini-3.8b"), n_layers=ALGO_LAYERS)
    shape, cfg = train_shape_and_config(arch, "none")
    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0,
                  remat="none")
    trainer = Trainer(model, cfg, shape)
    n_groups = dtype_groups(model.params)

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
    recs, launches = {}, dict.fromkeys(read_counts(), 0)
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
                               dtype_groups=n_groups)
        assert counts == want_n, (name, counts, want_n)
        assert math.isfinite(rec["loss"]), rec
        for k, v in counts.items():
            launches[k] += v
        rec["launches"] = counts
        recs[name] = rec
        if name.startswith("dpsgd mb"):
            rec["memory"] = memory_row(f"phase 9: {ALGO_LAYERS} layers, remat "
                                       f"none, {name}", tr, state,
                                       rec["peak_bytes"])
    sgd_ms = recs["sgd"]["step_ms"]
    for name, rec in recs.items():
        rec["over_sgd"] = rec["step_ms"] / sgd_ms
        print(f"[algo] {ALGO_LAYERS} layers, {name}: step {rec['step_ms']:.1f} "
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


def _leaf_sizes(arch):
    """(elements, path) of every parameter of the image model ``arch``."""
    from repro_torch.models import cnn, vit
    from repro_torch.models.transformer import _map_spec
    spec = (cnn if arch.family == "cnn" else vit).model_spec(arch)
    sizes = []
    _map_spec(spec, lambda p, path: sizes.append((math.prod(p.shape),
                                                  "/".join(path))))
    return sizes


def largest_leaf(arch):
    """(path, elements) of ``arch``'s largest parameter."""
    n, path = max(_leaf_sizes(arch))
    return path, n


def _meta_leaves(arch):
    """``arch``'s parameters as meta tensors (no memory), in the model's
    leaf order, with ``init_spec``'s types: the weights bf16, the ones and
    zeros (norm scales, biases) float32; the decoder's blocks stacked."""
    import torch
    from repro_torch import tree
    from repro_torch.models import cnn, transformer, vit
    if arch.family in ("cnn", "vit"):
        spec, reps = (cnn if arch.family == "cnn" else vit).model_spec(arch), None
    else:
        spec, (_, _, reps) = transformer.model_spec(arch), transformer.group_layers(arch)

    def mk(p, path):
        lead = (reps,) if reps is not None and path[0] == "blocks" else ()
        return torch.empty(lead + p.shape, device="meta", dtype=(
            torch.float32 if p.init in ("ones", "zeros") else torch.bfloat16))
    return tree.leaves(transformer._map_spec(spec, mk))


def flat_groups(arch):
    """``dpsgd``'s flat buffers of the model ``arch`` in bf16
    (``clipping.flat_stacks``): (dtype, parameters, padded row width) for
    each parameter dtype, in launch order.  Also the parameters of all
    dtypes end to end."""
    from repro_torch.core import clipping
    leaves = _meta_leaves(arch)
    bufs, *_ = clipping.flat_stacks(leaves, 1)
    groups = [(b.dtype, sum(p.numel() for p in leaves if p.dtype == b.dtype),
               b.shape[1]) for b in bufs]
    return groups, sum(p.numel() for p in leaves)


def check_image_kernels():
    """The kernels of phase 11's paths at its shapes (K 16 views of each of
    256 examples folded into T), float32 and bf16, each against its plain
    version, timed beside its library call and bound: the flash pair
    non-causal at (4096 x 8 heads, T 64, hd 32); at every distinct norm
    site of each model (``image_mix``) ``dense_bwd_norm``, ``pegrad_norm``
    and ``dense_dgrad`` (and the fusion A/B) on all 256 examples and
    ``gram_norm`` on 4 of them (its plain version and library call form
    each example's T x T Grams: 4.3 GB a matrix at T 16384); and
    ``clip_reduce`` over 256 examples at each model's largest leaf, at its
    flat buffers' widths (``dpsgd``'s launches, one a parameter dtype:
    each dtype's parameters end to end, padded; ``flat_groups``) and at the
    width of all its parameters end to end, unpadded.  The
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
        out["clip_reduce"][name] = {"leaf": {}, "flat": {}, "flat-f32": {}, "all": {}}
        groups, n_all = flat_groups(arch)
        widths = {dt_: n_pad for dt_, _, n_pad in groups}
        assert sorted(widths, key=str) == [torch.bfloat16, torch.float32], groups
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
            cr = out["clip_reduce"][name]
            cr["leaf"][dt] = check_clip_reduce(f"{name}-{path}", IMAGE_B, n, dtype)
            # the main path's launches: the bf16 weights' buffer in bf16, the
            # float32 norm scales' and biases' buffer in float32
            if dtype == bf16:
                cr["flat"][dt] = check_clip_reduce(f"{name}-flat", IMAGE_B,
                                                   widths[bf16], dtype, iters=5)
            else:
                cr["flat-f32"][dt] = check_clip_reduce(f"{name}-flat-f32", IMAGE_B,
                                                       widths[dtype], dtype)
            cr["all"][dt] = check_clip_reduce(f"{name}-all-unpadded", IMAGE_B, n_all,
                                              dtype, iters=5)
            gc.collect()
            torch.cuda.empty_cache()
        # dpsgd's bf16 launch takes the ring
        assert out["clip_reduce"][name]["flat"]["bfloat16"]["path"] == "cp.async", name
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


def conv_gy_gaps(trainer, state):
    """On the CNN, pass 1's gy at every conv layer (in backward order, the
    head's side first) through the fused route with kernels against the
    plain backward's (the same route without kernels: cuDNN's input
    gradient), both bf16: ||gy - gy_plain|| / ||gy_plain|| a layer, and the
    norms²' max rel err against the plain route's; once with the route's
    col2im (``F.fold``) in bf16 and once in float32."""
    import torch
    from repro_torch.core import algo, sites
    site = sites.get_site("conv2d")
    fused, col2im = site.fused_bwd["fused"], sites._col2im
    data, mask = algo.split_mask(trainer.make_batch(state.step))
    dp = trainer.cfg.dp

    folds = [0]

    def run(dp_, fold_dtype, on_gy):
        def recording(spec, operands, gy, needs, want_nsq=True):
            on_gy(gy)
            return fused(spec, operands, gy, needs, want_nsq)

        def fold(spec, gpat, x, w):
            folds[0] += 1
            return col2im(spec, gpat.to(fold_dtype), x, w)
        site.fused_bwd["fused"], sites._col2im = recording, fold
        try:
            nsq, _ = algo.norm_pass(trainer.model.loss_fn, state.params, data,
                                    dp_, mask)
        finally:
            site.fused_bwd["fused"], sites._col2im = fused, col2im
        return nsq

    plain = []
    want = run(dataclasses.replace(dp, use_kernels=False), torch.bfloat16,
               lambda gy: plain.append(gy.detach().clone()))
    out = {}
    for label, dt in (("bf16", torch.bfloat16), ("float32", torch.float32)):
        gaps, folds[0] = [], 0
        got = run(dp, dt, lambda gy: gaps.append(
            ((gy.float() - plain[len(gaps)].float()).norm()
             / plain[len(gaps)].float().norm()).item()))
        nsq_err = ((got - want).abs() / want.abs()).max().item()
        out[label] = dict(gy_rel_err=gaps, nsq_rel_err=nsq_err, folds=folds[0])
        print(f"[fold] {trainer.model.arch.name} pass 1, fused+kernels vs the "
              f"plain backward, col2im in {label} ({folds[0]} folds): norms² max "
              f"rel err {nsq_err:.3e}; gy rel err by conv layer, head side first: "
              + " ".join(f"{e:.2e}" for e in gaps), flush=True)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_image(name):
    """Phase 11 for one image model (see the module docstring).  Returns its
    record."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model_for
    arch = get_arch(name)
    shape, cfg = image_shape_and_config(arch)
    rows = IMAGE_B * IMAGE_K
    lap = stopwatch(f"phase 11 {name}")
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
    launches = dict.fromkeys(read_counts(), 0)

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
    memory_row(f"phase 11: {name}, {rows} rows, remat block, adaptive clip",
               trainer, state, steps[-1]["peak_bytes"])
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
    lap("steps, planner, stages, profile, plain norms²")
    if arch.family == "cnn":
        out["fold"] = conv_gy_gaps(trainer, state)
        lap("fold")

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

    if arch.family == "cnn":
        lap("materialize and gram")
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
    lap("poisson")

    # one dpsgd step under torch.profiler: clip_reduce on each dtype's flat
    # buffer of the 256 per-example gradients, its device time over the step
    dtr = image_trainer(model, shape, dataclasses.replace(
        cfg, dp=dataclasses.replace(cfg.dp, algo="dpsgd", microbatch=0)))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    box = []
    cp = kernel_device_ms(lambda: box.append(timed_step(dtr, state)) or box[0],
                          "clip_reduce")
    rec = box[0]
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    counts = read_counts()
    want = path_launches("fused", algo="dpsgd", remat=model.remat,
                         examples=IMAGE_B, dtype_groups=dtype_groups(model.params),
                         **launch_shape(arch))
    assert counts == want, (counts, want)
    assert math.isfinite(rec["loss"]), rec
    add(counts)
    rec["launches"] = counts
    print(f"[image] {name} dpsgd (all {IMAGE_B} examples at once) step {state.step - 1}: "
          f"loss {rec['loss']:.4f}; clip_norm {rec['clip_norm']:.4f} -> "
          f"{rec['clip_norm_next']:.4f}; {rec['step_ms']:.1f} ms under torch.profiler, "
          f"peak {rec['peak_bytes'] / 2**30:.2f} GiB; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    rec["clip_reduce_profile"] = cp
    if cp["launches"] != counts["clip_reduce"]:     # a record the profiler lost
        print(f"[timer] {name} dpsgd step: torch.profiler recorded "
              f"{cp['launches']} of {counts['clip_reduce']} clip_reduce launches; "
              f"device time not measured", flush=True)
        cp["ms"] = None
    else:
        print(f"[image] {name} dpsgd step: clip_reduce {cp['ms']:.4f} ms of device "
              f"time in {cp['launches']} launch(es) ({', '.join(cp['names'])})",
              flush=True)
    out["dpsgd"] = rec
    lap("dpsgd")

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
                       for k in read_counts()}
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
    memory_row(f"phase 10: {arch.name}, {arch.n_layers} layers, remat block, "
               f"adam8bit", trainer, state, steps[-1]["peak_bytes"])
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


def planner_split():
    """Phase 12 (b) and (c) at phase 6's shape on ``PLANNER_LAYERS`` layers
    (B 8 x T 512, remat none): the planner's estimates at grad_accum 1 and 2 of
    ``dpsgd_r`` and of ``dpsgd`` with the whole batch's per-example
    gradients in one buffer (microbatch 0), each beside a measured step;
    ``dpsgd`` under ``mem.auto_microbatch`` at the midpoint of its two
    estimates, which must pick 2 and peak below the step at 1; then a
    budget below every split of a B 2 batch, refused before any step."""
    import contextlib
    import io
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import MemConfig, ShapeConfig
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    arch = dataclasses.replace(get_arch("phi3-mini-3.8b"), n_layers=PLANNER_LAYERS)
    shape, base = train_shape_and_config(arch, "none")
    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0, remat="none")
    state = Trainer(model, base, shape).init_state()
    timed_step(Trainer(model, base, shape), state)   # warm-up (allocator, cuBLAS)
    out = {}
    for algo, dp in (("dpsgd_r", {}), ("dpsgd", dict(algo="dpsgd", microbatch=0))):
        cfg = dataclasses.replace(base, dp=dataclasses.replace(base.dp, **dp))
        # each split's estimate and measured step (one trace each), then the
        # Trainer that picks between them at the midpoint budget
        t = time.perf_counter()
        est, measured = {}, {}
        for g in (1, 2):
            tr = Trainer(model, dataclasses.replace(cfg, grad_accum=g), shape)
            gc.collect()
            torch.cuda.empty_cache()
            zero_counts()
            rep = tr.memory_report(state, tr.make_batch(state.step), measure=True)
            counts = read_counts()
            want = path_launches("fused", chunks=g, algo=algo, remat="none",
                                 examples=TRAIN_B // g, dtype_groups=dtype_groups(
                                     model.params), **launch_shape(arch))
            assert counts == want, (algo, g, counts, want)
            assert math.isfinite(rep["metrics"]["loss"]), rep["metrics"]
            est[g] = {k: v for k, v in rep.items() if k not in (
                "peak_op", "measured_peak_bytes", "estimate_vs_measured", "metrics")}
            measured[g] = dict(estimate_bytes=rep["peak_bytes"],
                               measured_bytes=rep["measured_peak_bytes"],
                               ratio=rep["estimate_vs_measured"],
                               loss=rep["metrics"]["loss"])
        trace_s = time.perf_counter() - t
        budget = (est[1]["peak_bytes"] + est[2]["peak_bytes"]) // 2
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            auto = Trainer(model, dataclasses.replace(
                cfg, mem=MemConfig(hbm_budget_bytes=budget, auto_microbatch=True)),
                shape)
        print(said.getvalue(), end="", flush=True)
        print(f"[planner] {algo}{' (microbatch 0)' if dp else ''}, {PLANNER_LAYERS} "
              f"layers, B {TRAIN_B} x {TRAIN_T}, remat none: estimated peak "
              f"{est[1]['peak_bytes'] / 2**30:.2f} GiB at grad_accum 1, "
              f"{est[2]['peak_bytes'] / 2**30:.2f} at 2 (traces and steps "
              f"{trace_s:.1f} s); "
              f"measured {measured[1]['measured_bytes'] / 2**30:.2f} and "
              f"{measured[2]['measured_bytes'] / 2**30:.2f} GiB (estimate / "
              f"measured {measured[1]['ratio']:.3f}, {measured[2]['ratio']:.3f}); "
              f"budget at the midpoint {budget / 2**30:.2f} GiB -> the Trainer "
              f"takes grad_accum {auto.cfg.grad_accum}", flush=True)
        out[algo] = dict(estimates=est, budget=budget, picked=auto.cfg.grad_accum,
                         steps=measured)
    # the per-example gradients set dpsgd's peak, and halving the chunk
    # halves them: the split pays there
    d = out["dpsgd"]
    assert d["picked"] == 2, d["picked"]
    assert d["steps"][2]["measured_bytes"] < d["steps"][1]["measured_bytes"], d
    print(f"[planner] dpsgd: the split the Trainer takes, grad_accum 2, measured "
          f"{d['steps'][2]['measured_bytes'] / 2**30:.2f} GiB against the budget "
          f"{d['budget'] / 2**30:.2f} GiB and the step at grad_accum 1's "
          f"{d['steps'][1]['measured_bytes'] / 2**30:.2f} GiB", flush=True)

    # (c) a budget below every split: the resident state alone
    small = ShapeConfig("chip_smoke_b2", TRAIN_T, 2, "train")
    tiny = d["estimates"][1]["arg_bytes"]
    step0 = state.step
    zero_counts()
    try:
        Trainer(model, dataclasses.replace(
            base, mem=MemConfig(hbm_budget_bytes=tiny, auto_microbatch=True)), small)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("a budget below every split built a Trainer")
    assert "no microbatch split fits" in refused, refused
    assert state.step == step0 and not any(read_counts().values())
    print(f"[planner] dpsgd_r at B 2 x {TRAIN_T}, budget {tiny / 2**30:.2f} GiB (the "
          f"resident state alone): refused before any step: {refused[:240]}...",
          flush=True)
    out["refused"] = refused
    del model, auto, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def agreeing_prefix(a, b) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def host_loop_path(prompts, engine_out, engine_recs):
    """Phase 12 (d): the host-loop engine on ``prompts``, the first of
    phase 5's stream, against the engine's streams of the same requests."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import Model
    from repro_torch.serve.host_loop import HostLoopEngine
    from repro_torch.serve.scheduler import Request
    arch = get_arch("phi3-mini-3.8b")
    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0)

    def serve_host_loop(ps, max_new):
        """(outputs, engine, seconds, seconds inside decode steps): each step
        ends in its host reads, so timing it adds no sync."""
        eng = HostLoopEngine(model, max_batch=MAX_BATCH, cache_len=CACHE_LEN)
        inner, spent = eng.step, [0.0]

        def timed():
            t = time.perf_counter()
            inner()
            spent[0] += time.perf_counter() - t
        eng.step = timed
        for uid, p in enumerate(ps):
            eng.submit(Request(uid=uid, prompt=p.astype(np.int32), max_new=max_new))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        return out, eng, time.perf_counter() - t0, spent[0]

    serve_host_loop(prompts[:2], 2)            # warm-up
    out, eng, dt, decode_s = serve_host_loop(prompts, MAX_NEW)
    n_tok = sum(len(v) for v in out.values())
    assert sorted(out) == list(range(len(prompts)))
    assert all(len(v) == MAX_NEW and all(0 <= x < arch.vocab for x in v)
               for v in out.values())
    rec = dict(engine="host-loop", requests=len(prompts), tokens=n_tok, seconds=dt,
               tok_per_s=n_tok / dt,
               mean_ttft_ms=1e3 * float(np.mean(list(eng.ttft.values()))),
               host_syncs=eng.stats["host_syncs"],
               decode_steps=eng.stats["decode_steps"],
               decode_ms_per_step=1e3 * decode_s / max(eng.stats["decode_steps"], 1))
    prefix = {uid: agreeing_prefix(out[uid], engine_out[uid]) for uid in sorted(out)}
    rec["agreeing_prefix"] = prefix
    for r in engine_recs:
        print(f"[hostloop] engine {r['engine']}: {r['tok_per_s']:.1f} tok/s, mean "
              f"TTFT {r['mean_ttft_ms']:.1f} ms, host reads {r['host_syncs']}, "
              f"decode {r['decode_ms_per_step']:.2f} ms a step (phase 5)", flush=True)
    print(f"[hostloop] host loop on the first {len(prompts)} requests: {n_tok} tokens "
          f"in {dt:.2f} s ({rec['tok_per_s']:.1f} tok/s), mean TTFT "
          f"{rec['mean_ttft_ms']:.1f} ms, host reads {rec['host_syncs']} over "
          f"{rec['decode_steps']} decode steps of {rec['decode_ms_per_step']:.2f} ms",
          flush=True)
    full = sum(n == MAX_NEW for n in prefix.values())
    print(f"[hostloop] greedy streams against the contiguous engine's (bf16; the "
          f"host loop prefills one request at a time, the engine in padded "
          f"waves): {full} of {len(prefix)} agree in all {MAX_NEW} tokens; "
          f"agreeing prefix by request {list(prefix.values())}", flush=True)
    del eng
    gc.collect()
    rec["busy"] = decode_busy("host loop", lambda: HostLoopEngine(
        model, max_batch=MAX_BATCH, cache_len=CACHE_LEN), "step",
        prompts[:BUSY_REQUESTS], BUSY_NEW, rec["decode_ms_per_step"])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def memory_planner_and_host_loop(prompts, engine_out, engine_recs):
    """Phase 12 (see the module docstring).  Returns its record."""
    from repro_torch.launch.memory import TOLERANCE_FACTOR, within_tolerance
    labels = [r["label"] for r in MEMORY_ROWS]
    assert len(labels) == 7, labels
    for r in MEMORY_ROWS:
        print(f"[planner] {r['label']}: estimate {r['estimate_bytes'] / 2**30:.2f} "
              f"GiB / measured {r['measured_bytes'] / 2**30:.2f} GiB = "
              f"{r['ratio']:.3f}", flush=True)
    bad = [(r["label"], r["ratio"]) for r in MEMORY_ROWS
           if not within_tolerance(r["ratio"])]
    assert not bad, (f"estimate / measured outside [1/{TOLERANCE_FACTOR}, "
                     f"{TOLERANCE_FACTOR}]", bad)
    lap = stopwatch("phase 12")
    split = planner_split()
    lap("(b)-(c) splits")
    host = host_loop_path(prompts[:HOST_LOOP_REQUESTS], engine_out, engine_recs)
    lap("(d) host loop")
    return dict(estimates=list(MEMORY_ROWS), split=split, host_loop=host)


# ---------------------------------------------------------------------------
# phase 13: the MoE family (deepseek-moe-16b and grok-1-314b)
# ---------------------------------------------------------------------------

def moe_kernel_shapes():
    """Phase 13 (a)'s shapes at B 8 x T 512: (name, BG, T, di, do, E, rows,
    iters).  deepseek's experts at C 60 (a ragged T): w1 and w3 (2048 ->
    1408) and w2 (1408 -> 2048) over its 8 x 64 (example, expert) groups;
    its router, a dense (8, 512, 2048 -> 64); grok's experts at C 160 over
    8 x 8 groups, 6144 <-> 32768, whose plain versions and library norms²
    go 8 rows at a time (``by_rows``: a (64, 6144, 32768) float32 product
    would not fit) and are timed over 2 calls."""
    from repro_torch.configs import get_arch
    from repro_torch.models.moe import capacity
    ds, gk = get_arch(MOE_ARCH), get_arch(GROK_ARCH)
    B, T = TRAIN_B, TRAIN_T
    cd, cg = capacity(ds.moe, T), capacity(gk.moe, T)
    Ed, Eg = ds.moe.num_experts, gk.moe.num_experts
    d, fe = ds.d_model, ds.moe.d_expert
    g, ge = gk.d_model, gk.moe.d_expert
    return [("ds-w1w3", B * Ed, cd, d, fe, Ed, None, 10),
            ("ds-w2", B * Ed, cd, fe, d, Ed, None, 10),
            ("ds-router", B, T, d, Ed, 1, None, 10),
            ("grok-w1w3", B * Eg, cg, g, ge, Eg, Eg, 2),
            ("grok-w2", B * Eg, cg, ge, g, Eg, Eg, 2)]


def check_group_contracts(name, BG, T, di, do, E, dtype):
    """At an MoE shape, gy zeroed over example 1's E (example, expert)
    groups (rows E to 2E-1): ``dense_bwd_norm``'s gx rows and norms²,
    ``dense_dgrad``'s gx and square ``gram_norm``'s norms² are exactly zero
    there and keep every other row's bits of the unzeroed call; two
    launches of each give the same bits."""
    import torch
    from repro_torch.kernels import fused_bwd, gram_norm
    x, gy, w = dense_inputs(BG, T, di, do, E, dtype)
    gz = gy.clone()
    gz[E:2 * E] = 0
    zero = torch.zeros(BG, dtype=torch.bool, device="cuda")
    zero[E:2 * E] = True
    runs = {"dense_bwd_norm": lambda g: fused_bwd.dense_bwd_norm(x, g, w),
            "dense_dgrad": lambda g: (fused_bwd.dense_dgrad(g, w),),
            "gram_norm": lambda g: (gram_norm.gram_norm(x, g, None, square=True),)}
    for kernel, run in runs.items():
        full, a, b = run(gy), run(gz), run(gz)
        torch.cuda.synchronize()
        for f, p, q in zip(full, a, b):
            assert torch.equal(p, q), (name, kernel, "repeat")
            assert torch.all(p[zero] == 0), (name, kernel, "zero groups")
            assert torch.equal(p[~zero], f[~zero]), (name, kernel, "other rows")
        del full, a, b
    print(f"[moe] {name} {_dtype_name(dtype)}: example 1's {E} zeroed gy groups "
          f"give exact zeros in dense_bwd_norm (gx, norms²), dense_dgrad and "
          f"gram_norm, the other rows' bits unchanged; repeats bit-identical",
          flush=True)


def check_moe_kernels():
    """Phase 13 (a): the kernels at the MoE paths' shapes, float32 and
    bf16, each against its plain version (``check_dense_bwd_norm``,
    ``check_dense_halves``: a zeroed gy group gives an exact 0.0 and
    repeats are bit-identical), with times, bounds, plain and library
    times and the path each shape takes; at deepseek's and grok's w1
    shapes one example's zeroed groups through every grouped kernel
    (``check_group_contracts``); ``gram_norm`` square at
    deepseek's expert groups (``auto``'s pick there, no id mask); the
    flash forward at deepseek's serving wave (16 heads of 128) and at
    grok's GQA (48 heads on 8), the backward at deepseek's training
    shape."""
    import torch
    from repro_torch.configs import get_arch
    ds, gk = get_arch(MOE_ARCH), get_arch(GROK_ARCH)
    out = {"dense_bwd_norm": [], "pegrad_norm": [], "dense_dgrad": [],
           "gram_norm": [], "flash_attn_fwd": [], "flash_attn_bwd": []}
    for dtype in (torch.float32, torch.bfloat16):
        for nm, BG, T, di, do, E, rows, iters in moe_kernel_shapes():
            gc.collect()
            torch.cuda.empty_cache()
            out["dense_bwd_norm"].append(check_dense_bwd_norm(
                nm, BG, T, di, do, E, dtype, iters=iters, rows=rows))
            halves = check_dense_halves(nm, BG, T, di, do, E, dtype, iters=iters,
                                        rows=rows, ab=False)
            out["pegrad_norm"].append(dict(halves["pegrad_norm"], E=E))
            out["dense_dgrad"].append(halves["dense_dgrad"])
        nm, BG, T, di, do, E, _, _ = moe_kernel_shapes()[0]
        out["gram_norm"].append(check_gram("ds-w1w3", BG, T, di, do, False, True,
                                           dtype))
        for nm, BG, T, di, do, E, _, _ in moe_kernel_shapes()[::3]:
            gc.collect()
            torch.cuda.empty_cache()
            check_group_contracts(nm, BG, T, di, do, E, dtype)
    gc.collect()
    torch.cuda.empty_cache()
    bf = torch.bfloat16
    out["flash_attn_fwd"] += [
        check_flash("ds-wave", MAX_BATCH, ds.n_heads, ds.n_kv_heads,
                    first_wave_t(request_stream(ds.vocab)), ds.hd, True, bf),
        check_flash("grok-gqa", GROK_REQUESTS, gk.n_heads, gk.n_kv_heads,
                    first_wave_t(request_stream(gk.vocab)[:GROK_REQUESTS]), gk.hd,
                    True, bf)]
    out["flash_attn_bwd"].append(check_flash_bwd(
        "ds-train", TRAIN_B * ds.n_heads, TRAIN_B * ds.n_kv_heads, TRAIN_T, ds.hd,
        True, bf))
    for kernel, recs in out.items():
        for r in recs:
            norm = f", norm path {r['norm_path']}" if "norm_path" in r else ""
            print(f"[moe] {kernel} {r['shape']} {r['dtype']}: path {r['path']}"
                  f"{norm}; kernel / library {r['ms'] / r['library_ms']:.2f}, "
                  f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound", flush=True)
    return out


def moe_decode_bound(arch):
    """Bytes one decode step must read of the weights: every expert of
    every MoE layer (decode computes all E at C 1), and all weights but the
    embedding; each over HBM bandwidth, in ms."""
    from repro_torch import tree
    from repro_torch.models.transformer import group_layers, model_spec
    spec = model_spec(arch)
    pre, _, reps = group_layers(arch)
    layers = list(spec["prelude"]) + list(spec.get("blocks", ())) * reps
    sizes = lambda ps: sum(math.prod(p.shape) for p in ps)
    experts = sizes(p for layer in layers if "moe" in layer
                    for k, p in layer["moe"].items() if k.startswith("we"))
    weights = sizes(tree.leaves(layers)) + sizes([spec["head"]])
    return dict(expert_bytes=2 * experts, weight_bytes=2 * weights,
                expert_bound_ms=1e3 * 2 * experts / PEAK_BYTES,
                weight_bound_ms=1e3 * 2 * weights / PEAK_BYTES)


def moe_serve(arch, prompts, max_new, engines, tag="moe"):
    """Phase 13 (b) and (c), phase 14 (c): ``arch`` (grok at
    ``GROK_LAYERS`` of its layers, jamba's two-layer cut), bf16, seeded
    weights, serving ``prompts`` greedily (``max_new`` tokens each) through
    each of ``engines`` ("contiguous", "paged"), every flash launch
    counted; their outputs must agree; deepseek's contiguous engine then
    serves a short stream under ``torch.profiler`` for the decode's device
    busy share (``decode_busy``).  Lines start with ``[tag]``.  Returns
    {engine: record}."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ATTN
    from repro_torch.models.transformer import Model
    n_attn = arch.pattern().count(ATTN)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    m = arch.moe
    print(f"[{tag}] {arch.name}: {arch.n_layers} layers, d_model {arch.d_model}, "
          f"{arch.n_heads} heads (kv {arch.n_kv_heads}) x hd {arch.hd}, {m.num_experts} "
          f"experts top {m.top_k} of d {m.d_expert}, {m.num_shared_experts} shared, "
          f"vocab {arch.vocab}; {n_par / 1e9:.3f}B params bf16, init "
          f"{time.perf_counter() - t:.1f} s, init peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    serve(model, prompts[:2], 2, paged=False)        # warm-up
    gc.collect()
    bound = moe_decode_bound(arch)
    runs = {}
    for kind in engines:
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        out, eng, dt, spent = serve(model, prompts, max_new, kind == "paged")
        counts = read_counts()
        waves = eng.stats["prefill_waves"]
        assert sorted(out) == list(range(len(prompts))), kind
        for uid, toks in out.items():
            assert len(toks) == max_new and all(0 <= x < arch.vocab for x in toks), \
                (kind, uid)
        assert counts["flash_attn_fwd"] >= n_attn * waves, (kind, counts)
        assert sum(counts.values()) == counts["flash_attn_fwd"], counts
        n_tok = sum(len(v) for v in out.values())
        steps = eng.stats["decode_steps"]
        rec = dict(arch=arch.name, n_layers=arch.n_layers, params=n_par, engine=kind,
                   requests=len(prompts), tokens=n_tok, seconds=dt,
                   tok_per_s=n_tok / dt,
                   mean_ttft_ms=1e3 * float(np.mean(list(eng.ttft.values()))),
                   decode_ms_per_step=1e3 * spent["decode"] / max(steps, 1),
                   prefill_ms_per_wave=1e3 * spent["prefill"] / max(waves, 1),
                   decode_steps=steps, prefill_waves=waves,
                   flash_launches=counts["flash_attn_fwd"],
                   max_memory_allocated=torch.cuda.max_memory_allocated(), **bound)
        runs[kind] = (out, rec)
        print(f"[{tag}] {arch.name} {kind}: {n_tok} tokens in {dt:.2f} s "
              f"({rec['tok_per_s']:.1f} tok/s), mean TTFT {rec['mean_ttft_ms']:.1f} ms, "
              f"decode {rec['decode_ms_per_step']:.2f} ms/step over {steps} steps "
              f"(bound: experts {bound['expert_bytes'] / 1e9:.1f} GB = "
              f"{bound['expert_bound_ms']:.2f} ms, all weights "
              f"{bound['weight_bytes'] / 1e9:.1f} GB = {bound['weight_bound_ms']:.2f} "
              f"ms at 3.35 TB/s), {waves} prefill waves of "
              f"{rec['prefill_ms_per_wave']:.1f} ms, flash launches "
              f"{counts['flash_attn_fwd']}, peak "
              f"{rec['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    outs = [o for o, _ in runs.values()]
    assert all(o == outs[0] for o in outs), f"{arch.name}: engines' greedy outputs differ"
    if len(runs) > 1:
        print(f"[{tag}] {arch.name}: paged greedy outputs equal the contiguous "
              f"engine's", flush=True)
    if arch.name == MOE_ARCH:
        # the device's busy share over the decode steps (the host's share
        # is the rest)
        from repro_torch.serve.engine import Engine
        runs["contiguous"][1]["decode_busy"] = decode_busy(
            f"{arch.name} contiguous", lambda: Engine(
                model, max_batch=MAX_BATCH, cache_len=CACHE_LEN, block_size=BLOCK),
            "_decode_chunk", prompts[:BUSY_REQUESTS], BUSY_NEW,
            runs["contiguous"][1]["decode_ms_per_step"])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {k: rec for k, (_, rec) in runs.items()}


def moe_train():
    """Phase 13 (d): deepseek-moe-16b at full width with ``MOE_TRAIN_LAYERS``
    layers (5 if the planner puts 6 above ``MOE_PLAN_LIMIT``), B 8 x T 512,
    ``dpsgd_r`` fused + kernels, ``remat="block"``, AdamW: a warm-up and
    ``TRAIN_STEPS`` counted steps, the planner's estimate beside their
    peak; the norms² of one batch through ``materialize``, ``auto`` and
    the plain rules against the fused route's; one counted step of each
    kernel route and one of the plain rules; one counted ``dpsgd_r1f``
    step; one fused step under ``torch.profiler`` (``profile_step``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.memory import within_tolerance
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    gc.collect()
    torch.cuda.empty_cache()
    layers, plan = MOE_TRAIN_LAYERS, []
    while True:
        arch = dataclasses.replace(get_arch(MOE_ARCH), n_layers=layers)
        shape, cfg = train_shape_and_config(arch, "block")
        model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0,
                      remat="block")
        trainer = Trainer(model, cfg, shape)
        est = trainer.memory_report(None, trainer.make_batch(0))["peak_bytes"]
        plan.append((layers, est))
        print(f"[moe-train] {arch.name} at {layers} layers: the planner estimates "
              f"{est / 2**30:.2f} GiB (limit {MOE_PLAN_LIMIT / 2**30:.0f} GiB)",
              flush=True)
        if est <= MOE_PLAN_LIMIT or layers == MOE_TRAIN_LAYERS - 1:
            break
        del model, trainer
        gc.collect()
        torch.cuda.empty_cache()
        layers -= 1
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state()
    n_par = sum(p.numel() for p in model.parameters())
    print(f"[moe-train] {arch.name} at full width, {layers} layers (layer 0 dense, "
          f"{layers - 1} MoE): {n_par / 1e9:.3f}B params bf16 + AdamW f32 state; "
          f"batch {TRAIN_B} x {TRAIN_T}; launch shape {launch_shape(arch)}", flush=True)
    timed_step(trainer, state)                    # warm-up
    steps, launches = [], dict.fromkeys(read_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    for _ in range(TRAIN_STEPS):
        rec, *_ = counted_step(trainer, model, state, "fused")
        steps.append(rec)
        add(rec["launches"])
        print(f"[moe-train] dpsgd_r fused+kernels step {state.step - 1}: loss "
              f"{rec['loss']:.4f}; {rec['step_ms']:.1f} ms = pass 1 "
              f"{rec['pass1_ms']:.1f} + pass 2 {rec['pass2_ms']:.1f} + noise and "
              f"optimizer {rec['noise_opt_ms']:.1f}; launches "
              f"{ {k: v for k, v in rec['launches'].items() if v} }", flush=True)
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(r["loss"]) for r in steps), steps
    row = memory_row(f"phase 13: {arch.name} {layers} layers, remat block, dpsgd_r "
                     f"fused", trainer, state, peak)
    assert within_tolerance(row["ratio"]), row
    prof = profile_step(lambda: timed_step(trainer, state), "MoE fused+kernels")

    # the norms² of one batch through every route, against the fused one's
    def trainer_for(**dp):
        return Trainer(model, dataclasses.replace(
            cfg, dp=dataclasses.replace(cfg.dp, **dp)), shape)
    batch = trainer.make_batch(state.step)
    nsq_f, *_ = split_passes(model, state, cfg.dp, batch)
    routes, others = {}, {"materialize": dict(norm_strategy="materialize"),
                          "auto": dict(norm_strategy="auto"),
                          "plain": dict(use_kernels=False)}
    split = {}
    for label, dp in others.items():       # all on the same params and batch
        gc.collect()
        torch.cuda.empty_cache()
        nsq, _, p1, p2 = split_passes(model, state, trainer_for(**dp).cfg.dp, batch)
        err = ((nsq - nsq_f).abs() / nsq_f.abs()).max().item()
        assert err <= NSQ_RTOL, (label, err)
        split[label] = (err, p1, p2)
    for label, dp in others.items():       # then a step of each
        tr = trainer_for(**dp)
        err, p1, p2 = split[label]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if label == "plain":
            rec = timed_step(tr, state)
        else:
            rec, *_ = counted_step(tr, model, state, label)
            add(rec["launches"])
        rec.update(nsq_rel_err=err, pass1_ms=p1, pass2_ms=p2,
                   peak_bytes=torch.cuda.max_memory_allocated())
        routes[label] = rec
        print(f"[moe-train] {label}: norms² vs fused max rel err {err:.2e} (limit "
              f"{NSQ_RTOL}); step {rec['step_ms']:.1f} ms (pass 1 {p1:.1f}, pass 2 "
              f"{p2:.1f}), peak {rec['peak_bytes'] / 2**30:.2f} GiB"
              + (f", launches { {k: v for k, v in rec['launches'].items() if v} }"
                 if "launches" in rec else ""), flush=True)
    r1f = trainer_for(algo="dpsgd_r1f")
    timed_step(r1f, state)                        # warm-up: the second pullback
    rec, *_ = counted_step(r1f, model, state, "fused")
    add(rec["launches"])
    routes["dpsgd_r1f"] = rec
    print(f"[moe-train] dpsgd_r1f fused+kernels step: {rec['step_ms']:.1f} ms, loss "
          f"{rec['loss']:.4f}; launches "
          f"{ {k: v for k, v in rec['launches'].items() if v} }", flush=True)
    out = dict(arch=arch.name, n_layers=layers, params=n_par, plan=plan, steps=steps,
               mean_step_ms=float(np.mean([r["step_ms"] for r in steps])),
               peak_bytes=peak, memory=row, routes=routes, launches=launches,
               nsq_fused=nsq_f.tolist(), profile=prof)
    del model, trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_path():
    """Phase 13 (see the module docstring).  Returns its record."""
    from repro_torch.configs import get_arch
    lap = stopwatch("phase 13")
    kernels = check_moe_kernels()
    lap("(a) kernels")
    ds_prompts = request_stream(get_arch(MOE_ARCH).vocab)
    serve_ds = moe_serve(dataclasses.replace(get_arch(MOE_ARCH),
                                             n_layers=MOE_SERVE_LAYERS),
                         ds_prompts[:MOE_REQUESTS], MAX_NEW, ("contiguous", "paged"))
    grok = dataclasses.replace(get_arch(GROK_ARCH), n_layers=GROK_LAYERS)
    serve_grok = moe_serve(grok, request_stream(grok.vocab)[:GROK_REQUESTS], GROK_NEW,
                           ("contiguous",))
    lap("(b)-(c) serving")
    train = moe_train()
    lap("(d) training")
    launches = dict(train["launches"])
    for recs in (serve_ds, serve_grok):
        for r in recs.values():
            launches["flash_attn_fwd"] += r["flash_launches"]
    return dict(kernels=kernels, serve=serve_ds, grok=serve_grok, train=train,
                launches=launches)


# ---------------------------------------------------------------------------
# phase 14: the SSM family (mamba2-1.3b and the jamba hybrid)
# ---------------------------------------------------------------------------

def jamba_cut():
    """jamba-1.5-large-398b at full width on its layers 4-5: the attention
    layer with its dense FFN, then a Mamba layer with the 16-expert MoE
    (``moe_period`` 2 and ``moe_offset`` 1 as published)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ATTN, MAMBA
    return dataclasses.replace(get_arch(JAMBA_ARCH), n_layers=2,
                               layer_pattern=(ATTN, MAMBA))


def ssm_kernel_shapes():
    """Phase 14 (a)'s dense shapes, one for each distinct norm site of its
    training paths (``norm_sites``; checked here): (name, BG, T, di, do, E,
    rows, iters).  mamba2-1.3b at B 8 x T 4096: in_proj (2048 -> 8512),
    out_proj (4096 -> 2048) and the head (2048 -> 50432).  jamba's cut at B
    8 x T 512: q and o (8192 -> 8192), k and v (8192 -> 1024), the dense
    FFN's w1 and w3 (8192 -> 24576) and w2, the Mamba layer's in_proj
    (8192 -> 35072) and out_proj (16384 -> 8192), the router (8192 -> 16),
    the experts at C 80 over 8 x 16 (example, expert) groups, 8192 <->
    24576, and the head (8192 -> 65536).  The plain versions go a slice of
    rows at a time (``by_rows``) where the float32 weight over 8 rows would
    pass 8 GB (2 rows), and over the experts one example's groups."""
    from repro_torch.configs import get_arch
    from repro_torch.models.mamba2 import mamba_dims
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import padded_vocab
    m2, cut = get_arch(MAMBA2_ARCH), jamba_cut()
    di2, H2, G2, N2, _, _ = mamba_dims(m2)
    dij, Hj, Gj, Nj, _, _ = mamba_dims(cut)
    E, C = cut.moe.num_experts, capacity(cut.moe, TRAIN_T)
    d, dj = m2.d_model, cut.d_model
    B = TRAIN_B
    m2_sites = [("in_proj", d, 2 * di2 + 2 * G2 * N2 + H2), ("out_proj", di2, d),
                ("head", d, padded_vocab(m2.vocab))]
    cut_sites = [("qo", dj, cut.n_heads * cut.hd), ("kv", dj, cut.n_kv_heads * cut.hd),
                 ("ffn-w1w3", dj, cut.d_ff), ("ffn-w2", cut.d_ff, dj),
                 ("in_proj", dj, 2 * dij + 2 * Gj * Nj + Hj), ("out_proj", dij, dj),
                 ("router", dj, E), ("head", dj, padded_vocab(cut.vocab))]
    out = []
    for tag, T, sites in (("m2", SSM_T, m2_sites), ("jamba", TRAIN_T, cut_sites)):
        for nm, di, do in sites:
            rows = 2 if 4 * B * di * do > 8 * 2**30 else None
            out.append((f"{tag}-{nm}", B, T, di, do, 1, rows, 5))
    out += [("jamba-w1w3", B * E, C, dj, cut.moe.d_expert, E, E, 2),
            ("jamba-w2", B * E, C, cut.moe.d_expert, dj, E, E, 2)]
    for tag, arch, T in (("m2", m2, SSM_T), ("jamba", cut, TRAIN_T)):
        want = {(ops[1][-2], ops[1][-1], ops[1][0] if kind == "moe_dense" else 1)
                for kind, ops, _ in norm_sites(arch, B, T)}
        got = {(di, do, e) for nm, _, _, di, do, e, _, _ in out
               if nm.startswith(tag + "-")}
        assert got == want, (tag, got ^ want)
    return out


def check_ssm_kernels():
    """Phase 14 (a): the kernels at the SSM paths' shapes, bf16, each
    against its plain version with times, bounds, plain and library times
    and the path each takes: ``dense_bwd_norm`` and ``pegrad_norm`` (a
    zeroed gy row exact, repeats bit-identical) at every
    ``ssm_kernel_shapes`` shape; one example's zeroed rows or groups
    through ``dense_bwd_norm``, ``dense_dgrad`` and ``gram_norm`` at
    mamba2's in_proj and jamba's experts (``check_group_contracts``);
    ``gram_norm`` at mamba2's embedding (B 8 x T 4096, masked) and the
    cut's (B 8 x T 512); the flash forward at jamba's serving wave (64
    heads on 8, hd 128) and at its training shape, the backward there."""
    import torch
    from repro_torch.configs import get_arch
    bf = torch.bfloat16
    m2, jb = get_arch(MAMBA2_ARCH), get_arch(JAMBA_ARCH)
    out = {"dense_bwd_norm": [], "pegrad_norm": [], "gram_norm": [],
           "flash_attn_fwd": [], "flash_attn_bwd": []}
    for nm, BG, T, di, do, E, rows, iters in ssm_kernel_shapes():
        gc.collect()
        torch.cuda.empty_cache()
        out["dense_bwd_norm"].append(check_dense_bwd_norm(
            nm, BG, T, di, do, E, bf, iters=iters, rows=rows))
        x, gy, _ = dense_inputs(BG, T, di, do, E, bf)
        rec, _ = check_pegrad_norm(nm, x, gy, iters, rows)
        out["pegrad_norm"].append(dict(rec, E=E))
        del x, gy
        if nm in ("m2-in_proj", "jamba-w1w3"):
            gc.collect()
            torch.cuda.empty_cache()
            check_group_contracts(nm, BG, T, di, do, E, bf)
    gc.collect()
    torch.cuda.empty_cache()
    out["gram_norm"].append(check_gram("m2-embed", TRAIN_B, SSM_T, m2.d_model,
                                       m2.d_model, True, False, bf, iters=5))
    out["gram_norm"].append(check_gram("jamba-embed", TRAIN_B, TRAIN_T, jb.d_model,
                                       jb.d_model, True, False, bf, iters=5))
    wave_t = len(request_stream(jb.vocab)[0])        # an equal-length wave of one
    out["flash_attn_fwd"].append(check_flash("jamba-wave", 1, jb.n_heads,
                                             jb.n_kv_heads, wave_t, jb.hd, True, bf))
    out["flash_attn_fwd"].append(check_flash("jamba-train", TRAIN_B, jb.n_heads,
                                             jb.n_kv_heads, TRAIN_T, jb.hd, True, bf))
    out["flash_attn_bwd"].append(check_flash_bwd(
        "jamba-train", TRAIN_B * jb.n_heads, TRAIN_B * jb.n_kv_heads, TRAIN_T, jb.hd,
        True, bf))
    for kernel, recs in out.items():
        for r in recs:
            norm = f", norm path {r['norm_path']}" if "norm_path" in r else ""
            print(f"[ssm] {kernel} {r['shape']} {r['dtype']}: path {r['path']}"
                  f"{norm}; kernel / library {r['ms'] / r['library_ms']:.2f}, "
                  f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound", flush=True)
    return out


def ssm_decode_bound(arch, B=MAX_BATCH):
    """Bytes one decode step must move: every weight but the embedding
    read once (bf16), and every Mamba layer's conv window (bf16) and SSM
    state (float32) of ``B`` slots read and written; over HBM bandwidth,
    in ms."""
    from repro_torch import tree
    from repro_torch.models.mamba2 import mamba_dims
    from repro_torch.models.transformer import group_layers, model_spec
    spec = model_spec(arch)
    pre, _, reps = group_layers(arch)
    layers = list(spec["prelude"]) + list(spec.get("blocks", ())) * reps
    weights = sum(math.prod(p.shape) for p in tree.leaves(layers) + [spec["head"]])
    d_in, H, G, N, K, Pd = mamba_dims(arch)
    per_layer = B * ((K - 1) * (d_in + 2 * G * N) * 2 + H * Pd * N * 4)
    state = 2 * per_layer * sum(1 for layer in layers if "mamba" in layer)
    nbytes = 2 * weights + state
    return dict(weight_bytes=2 * weights, state_bytes=state,
                bound_ms=1e3 * nbytes / PEAK_BYTES)


def ssm_serve(prompts):
    """Phase 14 (b): mamba2-1.3b at full width on ``SSM_SERVE_LAYERS`` of its
    48 layers, bf16, seeded weights, serving ``prompts`` greedily through the contiguous
    engine (equal-length waves, unpadded) and the host loop: their streams
    must be equal; ``paged=True`` must raise; decode ms a step beside its
    bytes bound; then the chaining check: decode after a T-token prefill
    against the last logits of a (T+1)-token prefill, within
    ``CHAIN_TOL`` of their largest entry.  Launches no kernel (no
    attention).  Returns its record."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.host_loop import HostLoopEngine
    from repro_torch.serve.scheduler import Request
    arch = dataclasses.replace(get_arch(MAMBA2_ARCH), n_layers=SSM_SERVE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    m = arch.mamba
    print(f"[ssm] {arch.name}: {arch.n_layers} Mamba2 layers, d_model {arch.d_model}, "
          f"d_inner {m.d_inner(arch.d_model)}, {m.n_heads(arch.d_model)} heads of "
          f"{m.head_dim}, d_state {m.d_state}, {m.n_groups} group, chunk {m.chunk}, "
          f"vocab {arch.vocab}; {n_par / 1e9:.3f}B params bf16, init "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    try:
        Engine(model, max_batch=MAX_BATCH, cache_len=CACHE_LEN, paged=True,
               block_size=BLOCK)
        raise AssertionError("paged=True did not raise on an SSM model")
    except ValueError as e:
        print(f"[ssm] paged=True raises: {e}", flush=True)
    serve(model, prompts[:2], 2, paged=False)        # warm-up
    gc.collect()
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    out, eng, dt, spent = serve(model, prompts, MAX_NEW, False)
    counts = read_counts()
    assert sum(counts.values()) == 0, counts
    assert eng.has_mamba and eng.sched.same_length_waves
    waves, steps = eng.stats["prefill_waves"], eng.stats["decode_steps"]
    assert waves == len({len(p) for p in prompts}), waves
    n_tok = sum(len(v) for v in out.values())
    assert sorted(out) == list(range(len(prompts))) and all(
        len(v) == MAX_NEW and all(0 <= x < arch.vocab for x in v) for v in out.values())
    bound = ssm_decode_bound(arch)
    rec = dict(arch=arch.name, params=n_par, requests=len(prompts), tokens=n_tok,
               seconds=dt, tok_per_s=n_tok / dt,
               mean_ttft_ms=1e3 * float(np.mean(list(eng.ttft.values()))),
               decode_ms_per_step=1e3 * spent["decode"] / max(steps, 1),
               prefill_ms_per_wave=1e3 * spent["prefill"] / max(waves, 1),
               decode_steps=steps, prefill_waves=waves,
               max_memory_allocated=torch.cuda.max_memory_allocated(), **bound)
    print(f"[ssm] {arch.name} contiguous: {n_tok} tokens in {dt:.2f} s "
          f"({rec['tok_per_s']:.1f} tok/s), mean TTFT {rec['mean_ttft_ms']:.1f} ms, "
          f"decode {rec['decode_ms_per_step']:.2f} ms/step over {steps} steps (bound: "
          f"weights {bound['weight_bytes'] / 1e9:.2f} GB + state "
          f"{bound['state_bytes'] / 1e9:.2f} GB read and written = "
          f"{bound['bound_ms']:.2f} ms at 3.35 TB/s), {waves} equal-length prefill "
          f"waves of {rec['prefill_ms_per_wave']:.1f} ms, peak "
          f"{rec['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
    del eng
    gc.collect()
    host = HostLoopEngine(model, max_batch=MAX_BATCH, cache_len=CACHE_LEN)
    for uid, p in enumerate(prompts):
        host.submit(Request(uid=uid, prompt=p.astype(np.int32), max_new=MAX_NEW))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host_out = host.run()
    host_s = time.perf_counter() - t0
    assert host_out == out, "the host loop's greedy streams differ from the engine's"
    rec.update(host_loop_tok_per_s=n_tok / host_s, host_loop_seconds=host_s,
               host_loop_host_syncs=host.stats["host_syncs"],
               host_loop_mean_ttft_ms=1e3 * float(np.mean(list(host.ttft.values()))))
    print(f"[ssm] {arch.name} host loop: {n_tok} tokens in {host_s:.2f} s "
          f"({rec['host_loop_tok_per_s']:.1f} tok/s), mean TTFT "
          f"{rec['host_loop_mean_ttft_ms']:.1f} ms, {host.stats['host_syncs']} host "
          f"reads; greedy streams equal to the engine's", flush=True)
    del host
    gc.collect()
    # chaining: decode after a T-token prefill = the last row of T+1 tokens
    toks = torch.as_tensor(prompts[0][None].astype(np.int64), device=model.device)
    T = toks.shape[1] - 1
    _, cache = model.prefill(toks[:, :T], T)
    step, _ = model.decode_step(cache, toks[:, T:], torch.tensor([T], device=model.device))
    full, _ = model.prefill(toks, T + 1)
    a, b = step.float()[..., :arch.vocab], full.float()[..., :arch.vocab]
    chain = ((a - b).abs().max() / b.abs().max()).item()
    same = bool(a.argmax() == b.argmax())
    print(f"[ssm] chaining at T {T}: decode after the prefill vs the last row of a "
          f"{T + 1}-token prefill, max |dlogits| {chain:.2e} of the largest (limit "
          f"{CHAIN_TOL}), argmax {'equal' if same else 'differs'}", flush=True)
    assert chain <= CHAIN_TOL, chain
    rec.update(chain_rel_err=chain, chain_argmax_equal=same, chain_T=T)
    del model, cache
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def nsq_only(model, state, dp, batch):
    """Pass 1 of ``dpsgd_r`` on ``batch`` (the norms² alone), synced; and
    its ms."""
    import torch
    from repro_torch.core import algo
    data, mask = algo.split_mask(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nsq, _ = algo.norm_pass(model.loss_fn, state.params, data, dp, mask)
    torch.cuda.synchronize()
    return nsq, 1e3 * (time.perf_counter() - t0)


def ssm_train():
    """Phase 14 (d): mamba2-1.3b at full width on ``SSM_TRAIN_LAYERS`` of
    its 48 layers, B 8 x T 4096 (B 4 if the planner puts B 8 above
    ``MOE_PLAN_LIMIT``),
    ``dpsgd_r`` fused + kernels, ``remat="block"``, AdamW: a warm-up and
    ``SSM_STEPS`` counted steps, the planner's estimate beside their
    peak (one trace, before the steps); the first step split into its
    passes, whose norms² the ``materialize``, ``auto`` and plain rules'
    (pass 1 on the same batch and params; the first two counted against
    ``pass1_launches``) are held to; the last step under
    ``torch.profiler``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.memory import within_tolerance
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    arch = dataclasses.replace(get_arch(MAMBA2_ARCH), n_layers=SSM_TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0, remat="block")
    _, cfg = train_shape_and_config(arch, "block")
    plan = []
    for B in (TRAIN_B, TRAIN_B // 2):
        shape = ShapeConfig("chip_smoke", SSM_T, B, "train")
        trainer = Trainer(model, cfg, shape)
        t = time.perf_counter()
        est = trainer.memory_report(None, trainer.make_batch(0))
        plan.append((B, est["peak_bytes"], time.perf_counter() - t))
        print(f"[ssm-train] {arch.name} at B {B} x T {SSM_T}: the planner estimates "
              f"{plan[-1][1] / 2**30:.2f} GiB (limit {MOE_PLAN_LIMIT / 2**30:.0f} GiB; "
              f"trace {plan[-1][2]:.1f} s)", flush=True)
        if plan[-1][1] <= MOE_PLAN_LIMIT:
            break
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state()
    n_par = sum(p.numel() for p in model.parameters())
    print(f"[ssm-train] {arch.name} at full width, {arch.n_layers} of 48 layers: "
          f"{n_par / 1e9:.3f}B params "
          f"bf16 + AdamW f32 state; batch {shape.global_batch} x {SSM_T}; launch shape "
          f"{launch_shape(arch, shape.global_batch, SSM_T)}", flush=True)
    timed_step(trainer, state)                    # warm-up
    steps, launches = [], dict.fromkeys(read_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    def trainer_for(**dp):
        return Trainer(model, dataclasses.replace(
            cfg, dp=dataclasses.replace(cfg.dp, **dp)), shape)

    routes, prof = {}, None
    for i in range(SSM_STEPS):
        if i < SSM_STEPS - 1:
            rec, batch, nsq, _ = counted_step(trainer, model, state, "fused",
                                              split=i == 0)
        else:                                     # the last one profiled
            box = []
            prof = profile_step(lambda: box.append(counted_step(
                trainer, model, state, "fused", split=False)[0]) or box[0],
                "mamba2 fused+kernels")
            rec = box[0]
        steps.append(rec)
        add(rec["launches"])
        split = (f" = pass 1 {rec['pass1_ms']:.1f} + pass 2 {rec['pass2_ms']:.1f} + "
                 f"noise and optimizer {rec['noise_opt_ms']:.1f}" if i == 0 else
                 " (under torch.profiler)" if prof is not None else "")
        print(f"[ssm-train] dpsgd_r fused+kernels step {state.step - 1}: loss "
              f"{rec['loss']:.4f}; {rec['step_ms']:.1f} ms{split}; "
              f"{shape.global_batch * SSM_T / rec['step_ms'] * 1e3:.0f} tok/s; launches "
              f"{ {k: v for k, v in rec['launches'].items() if v} }", flush=True)
        if i > 0:
            continue
        # the split's norms² (the step's batch, its updated params) against
        # every other route's on the same batch and params
        nsq_f = nsq
        for label, dp in (("materialize", dict(norm_strategy="materialize")),
                          ("auto", dict(norm_strategy="auto")),
                          ("plain", dict(use_kernels=False))):
            gc.collect()
            torch.cuda.empty_cache()
            zero_counts()
            nsq, p1 = nsq_only(model, state, trainer_for(**dp).cfg.dp, batch)
            counts = read_counts()
            if label != "plain":
                want = pass1_launches(label, remat=model.remat, **launch_shape(
                    arch, shape.global_batch, SSM_T))
                assert counts == want, (label, counts, want)
                add(counts)
            err = ((nsq - nsq_f).abs() / nsq_f.abs()).max().item()
            assert err <= NSQ_RTOL, (label, err)
            routes[label] = dict(nsq_rel_err=err, pass1_ms=p1, launches=counts)
            print(f"[ssm-train] {label}: norms² vs fused max rel err {err:.2e} (limit "
                  f"{NSQ_RTOL}); pass 1 {p1:.1f} ms (fused {rec['pass1_ms']:.1f}); "
                  f"launches { {k: v for k, v in counts.items() if v} }", flush=True)
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(r["loss"]) for r in steps), steps
    row = memory_row(f"phase 14: {arch.name} {arch.n_layers} layers, B {shape.global_batch} x T "
                     f"{SSM_T}, remat block, dpsgd_r fused", trainer, state, peak,
                     est=est, trace_s=plan[-1][2])
    assert within_tolerance(row["ratio"]), row
    out = dict(arch=arch.name, n_layers=arch.n_layers, params=n_par, plan=plan,
               batch=shape.global_batch, T=SSM_T, steps=steps,
               mean_step_ms=float(np.mean([r["step_ms"] for r in steps])),
               peak_bytes=peak, memory=row, routes=routes, launches=launches,
               nsq_fused=nsq_f.tolist(), profile=prof)
    del model, trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def expandable_segments():
    """The caching allocator's segments grow in place while inside, so a
    phase filling the card keeps its free memory in one piece; the
    default again on leaving, every cached block released."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def hybrid_train():
    """Phase 14 (e): jamba's two-layer cut at full width (11.93B params),
    B 8 x T 512, ``dpsgd_r`` fused + kernels, ``remat="block"``: one
    counted step's two passes (pass 1's norms², pass 2's clipped-sum
    gradients in float32; no warm-up: phase 14 (a) ran the kernels at these
    shapes), the planner's estimate of the whole Trainer step beside it;
    then pass 1 through the plain rules, whose norms² the fused ones are
    held to within ``NSQ_RTOL``.
    The whole step does not fit the card: pass 2's float32 sums
    (47.7 GB) beside the bf16 params (23.9 GB), and then SGD's float32
    momentum (47.7 GB; AdamW's state is three times that).  The noise and
    the optimizer launch no kernel of the port, so the passes make every
    launch ``path_launches`` counts."""
    # the cut's bf16 params (22.2 GiB) and pass 2's float32 sums (44.4 GiB,
    # a stacked expert weight's one 12 GiB block) leave ~12 GiB of the
    # card: segments that grow keep the free memory in one piece
    with expandable_segments():
        return _hybrid_passes()


def _hybrid_passes():
    import types
    import torch
    from repro_torch.configs.base import OptimConfig
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    arch = jamba_cut()
    print(f"[ssm-train] before the cut's model: allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB", flush=True)
    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0, remat="block")
    torch.cuda.empty_cache()                  # the float32 draws' pages
    shape, cfg = train_shape_and_config(arch, "block")
    cfg = dataclasses.replace(cfg, optim=OptimConfig(name="sgd", lr=1e-4,
                                                     schedule="constant"))
    trainer = Trainer(model, cfg, shape)      # makes the params trainable
    est = trainer.memory_report(None, trainer.make_batch(0))["peak_bytes"]
    n_par = sum(p.numel() for p in model.parameters())
    print(f"[ssm-train] {arch.name} layers 4-5 at full width: {n_par / 1e9:.3f}B params "
          f"bf16; the planner puts a whole SGD step at B {TRAIN_B} x {TRAIN_T} at "
          f"{est / 2**30:.2f} GiB (the card holds "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f} GiB): its "
          f"two passes run alone; launch shape {launch_shape(arch)}", flush=True)
    state = types.SimpleNamespace(params=model.params)
    batch = trainer.make_batch(0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    nsq, losses, p1, p2 = split_passes(model, state, cfg.dp, batch)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = path_launches("fused", algo="dpsgd_r", remat="block", **launch_shape(arch))
    assert counts == want, (counts, want)
    assert torch.isfinite(nsq).all() and torch.isfinite(losses).all()
    print(f"[ssm-train] {arch.name} cut, dpsgd_r fused+kernels passes: pass 1 {p1:.1f} "
          f"ms + pass 2 {p2:.1f} ms, loss {losses.mean().item():.4f}, norms² "
          f"{nsq.min().item():.3e}..{nsq.max().item():.3e}, peak {peak / 2**30:.2f} "
          f"GiB; launches { {k: v for k, v in counts.items() if v} }", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    plain, plain_ms = nsq_only(model, state, dataclasses.replace(cfg.dp, use_kernels=False),
                               batch)
    err = ((nsq - plain).abs() / plain.abs()).max().item()
    assert err <= NSQ_RTOL, err
    print(f"[ssm-train] {arch.name} cut: norms² fused+kernels vs the plain rules "
          f"(pass 1 {plain_ms:.1f} ms) max rel err {err:.2e} (limit {NSQ_RTOL})",
          flush=True)
    return dict(arch=arch.name, n_layers=2, params=n_par, batch=TRAIN_B,
                plan_whole_step_bytes=est, pass1_ms=p1, pass2_ms=p2, peak_bytes=peak,
                launches=counts, loss=losses.mean().item(), plain_pass1_ms=plain_ms,
                nsq_rel_err=err)


def ssm_path():
    """Phase 14 (see the module docstring).  Returns its record."""
    from repro_torch.configs import get_arch
    lap = stopwatch("phase 14")
    kernels = check_ssm_kernels()
    lap("(a) kernels")
    serve_m2 = ssm_serve(request_stream(get_arch(MAMBA2_ARCH).vocab)[:SSM_REQUESTS])
    lap("(b) mamba2 serving")
    cut = jamba_cut()
    serve_cut = moe_serve(cut, request_stream(cut.vocab)[:GROK_REQUESTS], GROK_NEW,
                          ("contiguous",), tag="ssm")
    lap("(c) jamba serving")
    train = ssm_train()
    lap("(d) mamba2 training")
    hybrid = hybrid_train()
    lap("(e) jamba passes")
    launches = {k: train["launches"][k] + hybrid["launches"][k] for k in train["launches"]}
    launches["flash_attn_fwd"] += serve_cut["contiguous"]["flash_launches"]
    return dict(kernels=kernels, serve=serve_m2, jamba=serve_cut, train=train,
                hybrid=hybrid, launches=launches)


# ---------------------------------------------------------------------------
# phase 15: the embedding-input models (musicgen-medium and chameleon-34b)
# ---------------------------------------------------------------------------

def embed_kernel_shapes():
    """Phase 15 (a)'s dense shapes, one for each distinct norm site of its
    training paths (``norm_sites``; checked here): (name, BG, T, di, do,
    rows, iters, gram), ``gram`` where ``auto`` sends the site to
    ``gram_norm`` (``resolve_strategy``, as ``launch_shape`` counts it;
    checked here too).  musicgen-medium at B 8 x T 1500: q, k, v and o
    (1536 -> 1536), w1 (1536 -> 6144), w2 (6144 -> 1536) and the head (1536
    -> 2048), none to ``gram_norm``; chameleon-34b at B 8 x T 512: q and o
    (8192 -> 8192), k and v (8192 -> 1024), w1 and w3 (8192 -> 22016), w2
    and the head (8192 -> 65536), every one to ``gram_norm``.  The plain
    versions go a slice of rows at a time where the float32 weight over 8
    rows would pass 8 GB (2 rows)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.sites import resolve_strategy
    from repro_torch.models.transformer import padded_vocab
    out = []
    for tag, name, T, grams in (("mg", MUSICGEN_ARCH, MG_T, 0),
                                ("ch", CHAMELEON_ARCH, TRAIN_T, 5)):
        arch = get_arch(name)
        d, q, kv = arch.d_model, arch.n_heads * arch.hd, arch.n_kv_heads * arch.hd
        sites = [("qkvo", d, q)] if kv == q else [("qo", d, q), ("kv", d, kv)]
        sites += [("w1w3" if arch.mlp_act == "swiglu" else "w1", d, arch.d_ff),
                  ("w2", arch.d_ff, d), ("head", d, padded_vocab(arch.vocab))]
        picks = {tuple(ops[1]): resolve_strategy(k, "auto", ops, gy)
                 for k, ops, gy in norm_sites(arch, TRAIN_B, T)}
        for nm, di, do in sites:
            rows = 2 if 4 * TRAIN_B * di * do > 8 * 2**30 else None
            out.append((f"{tag}-{nm}", TRAIN_B, T, di, do, rows, 5,
                        picks.get((di, do)) == "gram"))
        got = [(di, do, gram) for nm, _, _, di, do, _, _, gram in out
               if nm.startswith(tag + "-")]
        assert {(di, do) for di, do, _ in got} == set(picks), (tag, got, picks)
        assert sum(gram for *_, gram in got) == grams, (tag, got)
    return out


def check_embed_kernels():
    """Phase 15 (a): the kernels at the embedding-input models' shapes,
    bf16, each against its plain version with times, bounds, plain and
    library times and the path each takes: ``dense_bwd_norm`` and
    ``pegrad_norm`` (a zeroed gy row exact, repeats bit-identical) at every
    ``embed_kernel_shapes`` shape, and ``dense_dgrad`` at musicgen's
    (``dpsgd_r1f``'s second pullback there); ``gram_norm`` square at every
    shape ``auto`` sends to it (chameleon's q/o, k/v, MLP and head); one
    example's zeroed rows through ``dense_bwd_norm``, ``dense_dgrad`` and
    ``gram_norm`` at musicgen's w1 and at each of those
    (``check_group_contracts``); the flash forward at the serving
    prefills (musicgen's 8 x 500 and 8 x 564, chameleon's 4 x 1008 and 4 x
    1024) and the flash pair at the training shapes (musicgen's 24 heads of
    hd 64 at T 1500, chameleon's 64 heads on 8 at hd 128, T 512), causal."""
    import torch
    from repro_torch.configs import get_arch
    bf = torch.bfloat16
    out = {k: [] for k in ("dense_bwd_norm", "pegrad_norm", "dense_dgrad", "gram_norm",
                           "flash_attn_fwd", "flash_attn_bwd")}
    for nm, BG, T, di, do, rows, iters, gram in embed_kernel_shapes():
        gc.collect()
        torch.cuda.empty_cache()
        out["dense_bwd_norm"].append(check_dense_bwd_norm(
            nm, BG, T, di, do, 1, bf, iters=iters, rows=rows))
        if nm.startswith("mg-"):
            halves = check_dense_halves(nm, BG, T, di, do, 1, bf, iters=iters,
                                        rows=rows, ab=False)
            out["pegrad_norm"].append(halves["pegrad_norm"])
            out["dense_dgrad"].append(halves["dense_dgrad"])
        else:
            x, gy, _ = dense_inputs(BG, T, di, do, 1, bf)
            rec, _ = check_pegrad_norm(nm, x, gy, iters, rows)
            out["pegrad_norm"].append(dict(rec, E=1))
            del x, gy
        if gram:
            gc.collect()
            torch.cuda.empty_cache()
            out["gram_norm"].append(check_gram(nm, BG, T, di, do, False, True, bf,
                                               iters=iters))
        if gram or nm == "mg-w1":
            gc.collect()
            torch.cuda.empty_cache()
            check_group_contracts(nm, BG, T, di, do, 1, bf)
    gc.collect()
    torch.cuda.empty_cache()
    for nm, name, B, T in (("mg-prefill", MUSICGEN_ARCH, TRAIN_B, MG_PROMPT),
                           ("mg-chain", MUSICGEN_ARCH, TRAIN_B, MG_PROMPT + MG_NEW),
                           ("ch-prefill", CHAMELEON_ARCH, CH_REQUESTS, CH_PROMPT),
                           ("ch-chain", CHAMELEON_ARCH, CH_REQUESTS, CH_PROMPT + CH_NEW)):
        arch = get_arch(name)
        out["flash_attn_fwd"].append(check_flash(nm, B, arch.n_heads, arch.n_kv_heads,
                                                 T, arch.hd, True, bf))
    for nm, name, T in (("mg-train", MUSICGEN_ARCH, MG_T),
                        ("ch-train", CHAMELEON_ARCH, TRAIN_T)):
        arch = get_arch(name)
        out["flash_attn_fwd"].append(check_flash(nm, TRAIN_B, arch.n_heads,
                                                 arch.n_kv_heads, T, arch.hd, True, bf))
        out["flash_attn_bwd"].append(check_flash_bwd(
            nm, TRAIN_B * arch.n_heads, TRAIN_B * arch.n_kv_heads, T, arch.hd, True, bf,
            iters=5))
    for kernel, recs in out.items():
        for r in recs:
            norm = f", norm path {r['norm_path']}" if "norm_path" in r else ""
            print(f"[embed] {kernel} {r['shape']} {r['dtype']}: path {r['path']}"
                  f"{norm}; kernel / library {r['ms'] / r['library_ms']:.2f}, "
                  f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound", flush=True)
    # every training shape takes the TMA-fed (dense) or cp.async-fed
    # (attention backward, Gram) tensor-core path
    for kernel, recs in out.items():
        for r in recs:
            want = "mma+cp.async" if kernel in ("flash_attn_bwd", "gram_norm") else (
                "wgmma+tma" if kernel != "flash_attn_fwd" else r["path"])
            assert r["path"] == want and r.get("norm_path", want) == want, (kernel, r)
    return out


def embed_inputs(arch, B, T, seed=1):
    """(B, T, d) precomputed embeddings drawn on the card from ``seed``,
    standard normal as the synthetic source's, bf16."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((B, T, arch.d_model), generator=g, device="cuda").to(torch.bfloat16)


def paged_from(cache, block_size):
    """A paged pool holding a contiguous cache's rows: slot b's positions in
    blocks b·nb .. b·nb + nb - 1 (nb = cache_len / block_size), so the
    tables ``arange(B·nb).reshape(B, nb)`` read it back as it was."""
    def pool(leaves):
        return tuple(a.reshape(a.shape[:-4] + (-1, block_size) + a.shape[-2:]).clone()
                     for a in leaves)
    return {"prelude": [pool(c) for c in cache["prelude"]],
            "blocks": (None if cache["blocks"] is None
                       else tuple(pool(c) for c in cache["blocks"]))}


def embed_serve(name, B, prompt_t, new, paged, ragged, layers=None):
    """Phase 15 (b) and (c): ``name`` at full width, on ``layers`` of its
    layers (default all), bf16, seeded
    weights (init's peak held to the parameters' bytes + ``INIT_SLACK``),
    fed precomputed embeddings (``embed_inputs``): a prefill of B prompts
    of ``prompt_t`` positions, then ``new`` decode steps each fed the next
    embedding through the contiguous cache and, with ``paged``, through the
    paged cache (their logits must agree); the chaining check (the last
    decode step's logits against the last position of one prefill over
    all positions, within ``CHAIN_TOL``); with ``ragged``, a right-padded
    prefill of 4 rows with ``lengths`` against unpadded prefills of the
    same rows (1e-3, as the paged check: the same kernels on the same
    rows).  Prefill ms, TTFT (to the first token on the
    host), decode ms a step beside the weights' bytes bound and the peak.
    Every prefill launches the flash forward at each layer, nothing else
    a kernel.  Returns its record."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import Model
    arch = get_arch(name)
    arch = dataclasses.replace(arch, n_layers=layers or arch.n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_par = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    init_peak = torch.cuda.max_memory_allocated() - base
    print(f"[embed] {arch.name}: {arch.n_layers} layers, d_model {arch.d_model}, "
          f"{arch.n_heads} heads (kv {arch.n_kv_heads}) x hd {arch.hd}, d_ff "
          f"{arch.d_ff} {arch.mlp_act}, qk_norm {arch.qk_norm}, vocab {arch.vocab}, no "
          f"embedding table; {n_par / 1e9:.3f}B params, {w_bytes / 2**30:.2f} GiB; init "
          f"{init_s:.1f} s, its peak {init_peak / 2**30:.2f} GiB (limit: the params + "
          f"{INIT_SLACK / 2**30:.0f} GiB)", flush=True)
    assert init_peak <= w_bytes + INIT_SLACK, (init_peak, w_bytes)
    S = prompt_t + new
    cache_len = -(-S // BLOCK) * BLOCK
    emb = embed_inputs(arch, B, S)
    model.prefill(emb[:, :prompt_t], cache_len)        # warm-up at the shape
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(emb[:, :prompt_t], cache_len)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    logits[..., :arch.vocab].argmax(-1).cpu()
    ttft_ms = 1e3 * (time.perf_counter() - t0)
    prefills = 1
    pool = paged_from(cache, BLOCK) if paged else None

    def decode(step, cache, *tables):
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(new):
            pos = torch.full((B,), prompt_t + i, dtype=torch.int64, device="cuda")
            lg, cache = step(cache, emb[:, prompt_t + i:prompt_t + i + 1], pos, *tables)
            out.append(lg[..., :arch.vocab])
        torch.cuda.synchronize()
        return torch.cat(out, 1), 1e3 * (time.perf_counter() - t0) / new

    def device_work(step, cache, *tables, n=4):
        """The device ms and launches of a decode step: its first ``n``
        steps again under the profiler (they rewrite the same cache
        entries with the same values)."""
        def replay():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n):
                pos = torch.full((B,), prompt_t + i, dtype=torch.int64, device="cuda")
                step(cache, emb[:, prompt_t + i:prompt_t + i + 1], pos, *tables)
            torch.cuda.synchronize()
            return dict(step_ms=1e3 * (time.perf_counter() - t0) / n)
        got = kernel_device_ms(replay, "")
        return got["ms"] / n, got["launches"] / n

    steps, decode_ms = decode(model.decode_step, cache)
    dev_ms, dev_launches = device_work(model.decode_step, cache)
    kv_bytes = sum(a.numel() * a.element_size() for a in tree.leaves(cache))
    del cache
    rec = dict(arch=arch.name, params=n_par, weight_bytes=w_bytes, init_s=init_s,
               init_peak_bytes=init_peak, batch=B, prompt_t=prompt_t, new=new,
               prefill_ms=prefill_ms, ttft_ms=ttft_ms, decode_ms_per_step=decode_ms,
               decode_device_ms=dev_ms, decode_launches=dev_launches,
               bound_ms=1e3 * w_bytes / PEAK_BYTES, kv_cache_bytes=kv_bytes)
    if paged:
        nb = cache_len // BLOCK
        tables = torch.arange(B * nb, device="cuda").reshape(B, nb)
        psteps, rec["paged_decode_ms_per_step"] = decode(model.decode_step_paged, pool,
                                                         tables)
        rec["paged_device_ms"], rec["paged_launches"] = device_work(
            model.decode_step_paged, pool, tables)
        del pool
        gap = _rel_err(psteps, steps)
        rec.update(paged_rel_err=gap, paged_bit_equal=bool(torch.equal(psteps, steps)))
        same = "bit-identical" if rec["paged_bit_equal"] else "not bit-identical"
        print(f"[embed] {arch.name} paged decode: {rec['paged_decode_ms_per_step']:.2f} "
              f"ms/step ({rec['paged_device_ms']:.2f} ms of device work in "
              f"{rec['paged_launches']:.0f} launches); its {new} steps' logits vs "
              f"the contiguous cache's max |d| "
              f"{gap:.2e} of the largest ({same}; limit 1e-3)", flush=True)
        assert gap <= 1e-3, gap
    gc.collect()
    full, _ = model.prefill(emb, S)
    prefills += 1
    chain = _rel_err(steps[:, -1], full[:, 0, :arch.vocab])
    rec.update(chain_rel_err=chain, chain_argmax_equal=bool(torch.equal(
        steps[:, -1].argmax(-1), full[:, 0, :arch.vocab].argmax(-1))))
    print(f"[embed] {arch.name} chaining: decode step {S - 1} after a {prompt_t}-position "
          f"prefill vs the last row of a {S}-position prefill, max |dlogits| "
          f"{chain:.2e} of the largest (limit {CHAIN_TOL}), argmax "
          f"{'equal in every row' if rec['chain_argmax_equal'] else 'differs'}",
          flush=True)
    assert chain <= CHAIN_TOL, chain
    del full
    if ragged:
        lengths = torch.tensor([prompt_t, prompt_t * 7 // 8, prompt_t * 5 // 8,
                                prompt_t // 2], device="cuda")
        rows = emb[:4, :prompt_t]
        padded, _ = model.prefill(rows, prompt_t, lengths=lengths)
        alone = torch.cat([model.prefill(rows[i:i + 1, :n], n)[0]
                           for i, n in enumerate(lengths.tolist())])
        prefills += 1 + len(lengths)
        rag = _rel_err(padded[..., :arch.vocab], alone[..., :arch.vocab])
        rec.update(ragged_rel_err=rag, ragged_lengths=lengths.tolist(),
                   ragged_bit_equal=bool(torch.equal(padded[..., :arch.vocab],
                                                     alone[..., :arch.vocab])))
        same = "bit-identical" if rec["ragged_bit_equal"] else "not bit-identical"
        print(f"[embed] {arch.name} ragged prefill: lengths {lengths.tolist()} right-padded "
              f"to {prompt_t} vs each row alone, max |dlogits| {rag:.2e} of the largest "
              f"({same}; limit 1e-3)", flush=True)
        assert rag <= 1e-3, rag
    counts = read_counts()
    want = dict.fromkeys(counts, 0)
    want["flash_attn_fwd"] = prefills * arch.n_layers
    assert counts == want, (counts, want)
    rec.update(flash_launches=counts["flash_attn_fwd"],
               max_memory_allocated=torch.cuda.max_memory_allocated())
    print(f"[embed] {arch.name} serving {B} x {prompt_t} precomputed embeddings: "
          f"prefill {prefill_ms:.1f} ms, TTFT {ttft_ms:.1f} ms, decode {decode_ms:.2f} "
          f"ms/step over {new} steps ({dev_ms:.2f} ms of device work in "
          f"{dev_launches:.0f} launches; {B * 1e3 / decode_ms:.1f} positions/s; bound: "
          f"weights {w_bytes / 1e9:.2f} GB at 3.35 TB/s = {rec['bound_ms']:.2f} ms, the "
          f"KV cache {kv_bytes / 1e9:.2f} GB besides), peak "
          f"{rec['max_memory_allocated'] / 2**30:.2f} GiB; flash_attn_fwd launches "
          f"{counts['flash_attn_fwd']}", flush=True)
    del model, emb, steps
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def musicgen_train():
    """Phase 15 (d): musicgen-medium at full width on ``MG_TRAIN_LAYERS``
    of its 48 layers,
    B 8 x T 1500 precomputed embeddings, ``dpsgd_r`` fused + kernels,
    ``remat="block"``, AdamW: the planner's estimate (one trace, before
    the steps), a warm-up and ``TRAIN_STEPS`` counted steps (the first
    split into its passes) beside it, one profiled step; the norms² of the
    split's batch through ``materialize``, ``auto`` and the plain rules
    (pass 1 on the same batch and params; the first two counted against
    ``pass1_launches``) against fused's within ``NSQ_RTOL``; one counted
    Poisson step (padded rows' norms² exactly 0.0) and one counted
    ``dpsgd_r1f`` step (``dense_dgrad``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.memory import within_tolerance
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    arch = dataclasses.replace(get_arch(MUSICGEN_ARCH), n_layers=MG_TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0, remat="block")
    _, cfg = train_shape_and_config(arch, "block")
    shape = ShapeConfig("chip_smoke", MG_T, TRAIN_B, "train")
    trainer = Trainer(model, cfg, shape)
    t = time.perf_counter()
    est = trainer.memory_report(None, trainer.make_batch(0))
    trace_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state()
    n_par = sum(p.numel() for p in model.parameters())
    lshape = launch_shape(arch, TRAIN_B, MG_T)
    print(f"[embed-train] {arch.name} at full width, {arch.n_layers} of 48 layers: "
          f"{n_par / 1e9:.3f}B params "
          f"bf16 + AdamW f32 state; batch {TRAIN_B} x {MG_T} embeddings of "
          f"{arch.d_model}; the planner estimates {est['peak_bytes'] / 2**30:.2f} GiB "
          f"(trace {trace_s:.1f} s); launch shape {lshape}", flush=True)
    timed_step(trainer, state)                    # warm-up
    steps, launches = [], dict.fromkeys(read_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    def trainer_for(**dp):
        return Trainer(model, dataclasses.replace(
            cfg, dp=dataclasses.replace(cfg.dp, **dp)), shape)

    for i in range(TRAIN_STEPS):
        rec, b, _, _ = counted_step(trainer, model, state, "fused", split=i == 0)
        if i == 0:
            batch = b
        steps.append(rec)
        add(rec["launches"])
        split = (f" = pass 1 {rec['pass1_ms']:.1f} + pass 2 {rec['pass2_ms']:.1f} + "
                 f"noise and optimizer {rec['noise_opt_ms']:.1f}" if i == 0 else "")
        print(f"[embed-train] dpsgd_r fused+kernels step {state.step - 1}: loss "
              f"{rec['loss']:.4f}; {rec['step_ms']:.1f} ms{split}; "
              f"{TRAIN_B * MG_T / rec['step_ms'] * 1e3:.0f} positions/s; launches "
              f"{ {k: v for k, v in rec['launches'].items() if v} }", flush=True)
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(r["loss"]) for r in steps), steps
    row = memory_row(f"phase 15: {arch.name} {arch.n_layers} layers, B {TRAIN_B} x T "
                     f"{MG_T}, remat block, dpsgd_r fused", trainer, state, peak, est=est,
                     trace_s=trace_s)
    assert within_tolerance(row["ratio"]), row
    prof = profile_step(lambda: timed_step(trainer, state), "musicgen fused+kernels")
    # every route's pass 1 on the split's batch at the same params
    nsq_f, _ = nsq_only(model, state, cfg.dp, batch)
    routes = {}
    for label, dp in (("materialize", dict(norm_strategy="materialize")),
                      ("auto", dict(norm_strategy="auto")),
                      ("plain", dict(use_kernels=False))):
        gc.collect()
        torch.cuda.empty_cache()
        zero_counts()
        nsq, p1 = nsq_only(model, state, trainer_for(**dp).cfg.dp, batch)
        counts = read_counts()
        if label != "plain":
            want = pass1_launches(label, remat=model.remat, **lshape)
            assert counts == want, (label, counts, want)
            add(counts)
        err = ((nsq - nsq_f).abs() / nsq_f.abs()).max().item()
        assert err <= NSQ_RTOL, (label, err)
        routes[label] = dict(nsq_rel_err=err, pass1_ms=p1, launches=counts)
        print(f"[embed-train] {label}: norms² vs fused max rel err {err:.2e} (limit "
              f"{NSQ_RTOL}); pass 1 {p1:.1f} ms (fused {steps[0]['pass1_ms']:.1f}); "
              f"launches { {k: v for k, v in counts.items() if v} }", flush=True)
    # one Poisson step: expected 8 of N = 1e6, padded with all-zero rows
    poisson = trainer_for(sampling="poisson")
    gc.collect()
    torch.cuda.empty_cache()
    rec, pbatch, _, _ = counted_step(poisson, model, state, "fused", split=False)
    add(rec["launches"])
    mask = pbatch["mask"]
    nsq, _ = nsq_only(model, state, poisson.cfg.dp, pbatch)
    real = int(mask.sum())
    assert rec["realized_batch"] == real, (rec["realized_batch"], real)
    assert bool(torch.all(nsq[~mask] == 0.0)) and bool(torch.all(nsq[mask] > 0.0)), nsq
    assert not pbatch["embeds"][~mask].any() and not pbatch["labels"][~mask].any()
    eps = poisson.history[-1]["epsilon"]
    routes["poisson"] = dict(rec, capacity=poisson.capacity, nsq_real=nsq[mask].tolist(),
                             epsilon=eps)
    print(f"[embed-train] poisson step {state.step - 1}: realized batch {real} of "
          f"capacity {poisson.capacity} (all-zero embeds and labels padded); padded "
          f"rows' norms² all exactly 0.0; loss {rec['loss']:.4f}; {rec['step_ms']:.1f} "
          f"ms; eps {eps:.6f}", flush=True)
    r1f = trainer_for(algo="dpsgd_r1f")
    gc.collect()
    torch.cuda.empty_cache()
    rec, *_ = counted_step(r1f, model, state, "fused", split=False)
    add(rec["launches"])
    routes["dpsgd_r1f"] = rec
    print(f"[embed-train] dpsgd_r1f fused+kernels step (its first): {rec['step_ms']:.1f} "
          f"ms, loss {rec['loss']:.4f}; launches "
          f"{ {k: v for k, v in rec['launches'].items() if v} }", flush=True)
    out = dict(arch=arch.name, n_layers=arch.n_layers, params=n_par, batch=TRAIN_B,
               T=MG_T, steps=steps,
               mean_step_ms=float(np.mean([r["step_ms"] for r in steps])),
               peak_bytes=peak, memory=row, routes=routes, launches=launches,
               nsq_fused=nsq_f.tolist(), profile=prof)
    del model, trainer, state, batch, pbatch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def chameleon_train():
    """Phase 15 (e): chameleon-34b at full width on ``CH_TRAIN_LAYERS`` of
    its 48 layers (one fewer at a time, down to ``CH_MIN_LAYERS``, while
    the planner puts the step above ``MOE_PLAN_LIMIT``), B 8 x T 512
    precomputed embeddings, ``dpsgd_r`` fused + kernels, ``remat="block"``,
    AdamW: a warm-up and two counted steps (the first split into its
    passes) beside the planner's estimate; the norms² of the split's batch
    through the plain rules (the q and k norm taps among them) and through
    ``auto`` (every site to ``gram_norm`` at T 512; counted against
    ``pass1_launches``) against fused's within ``NSQ_RTOL``."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.memory import within_tolerance
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    layers, plan = CH_TRAIN_LAYERS, []
    while True:
        arch = dataclasses.replace(get_arch(CHAMELEON_ARCH), n_layers=layers)
        shape, cfg = train_shape_and_config(arch, "block")
        model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0, remat="block")
        trainer = Trainer(model, cfg, shape)
        t = time.perf_counter()
        est = trainer.memory_report(None, trainer.make_batch(0))
        plan.append((layers, est["peak_bytes"], time.perf_counter() - t))
        print(f"[embed-train] {arch.name} at {layers} layers: the planner estimates "
              f"{est['peak_bytes'] / 2**30:.2f} GiB (limit {MOE_PLAN_LIMIT / 2**30:.0f} "
              f"GiB; trace {plan[-1][2]:.1f} s)", flush=True)
        if est["peak_bytes"] <= MOE_PLAN_LIMIT or layers == CH_MIN_LAYERS:
            break
        del model, trainer
        gc.collect()
        torch.cuda.empty_cache()
        layers -= 1
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state()
    n_par = sum(p.numel() for p in model.parameters())
    lshape = launch_shape(arch, TRAIN_B, TRAIN_T)
    print(f"[embed-train] {arch.name} at full width, {layers} of 48 layers: "
          f"{n_par / 1e9:.3f}B params bf16 + AdamW f32 state; batch {TRAIN_B} x "
          f"{TRAIN_T} embeddings of {arch.d_model}; launch shape {lshape}", flush=True)
    timed_step(trainer, state)                    # warm-up
    steps, launches = [], dict.fromkeys(read_counts(), 0)
    for i in range(2):
        rec, b, _, _ = counted_step(trainer, model, state, "fused", split=i == 0)
        if i == 0:
            batch = b
        steps.append(rec)
        for k, v in rec["launches"].items():
            launches[k] += v
        split = (f" = pass 1 {rec['pass1_ms']:.1f} + pass 2 {rec['pass2_ms']:.1f} + "
                 f"noise and optimizer {rec['noise_opt_ms']:.1f}" if i == 0 else "")
        print(f"[embed-train] dpsgd_r fused+kernels step {state.step - 1}: loss "
              f"{rec['loss']:.4f}; {rec['step_ms']:.1f} ms{split}; launches "
              f"{ {k: v for k, v in rec['launches'].items() if v} }", flush=True)
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(r["loss"]) for r in steps), steps
    row = memory_row(f"phase 15: {arch.name} {layers} layers, B {TRAIN_B} x T {TRAIN_T}, "
                     f"remat block, dpsgd_r fused", trainer, state, peak, est=est,
                     trace_s=plan[-1][2])
    assert within_tolerance(row["ratio"]), row
    # every route's pass 1 on the split's batch at the same params
    nsq_f, _ = nsq_only(model, state, cfg.dp, batch)
    routes = {}
    for label, dp in (("plain", dict(use_kernels=False)),
                      ("auto", dict(norm_strategy="auto"))):
        gc.collect()
        torch.cuda.empty_cache()
        zero_counts()
        nsq, p1 = nsq_only(model, state, dataclasses.replace(cfg.dp, **dp), batch)
        counts = read_counts()
        if label == "auto":
            want = pass1_launches(label, remat=model.remat, **lshape)
            assert counts == want, (counts, want)
            for k, v in counts.items():
                launches[k] += v
        err = ((nsq - nsq_f).abs() / nsq_f.abs()).max().item()
        assert err <= NSQ_RTOL, (label, err)
        routes[label] = dict(nsq_rel_err=err, pass1_ms=p1, launches=counts)
        print(f"[embed-train] {arch.name} cut, {label}: norms² vs fused max rel err "
              f"{err:.2e} (limit {NSQ_RTOL}); pass 1 {p1:.1f} ms (fused "
              f"{steps[0]['pass1_ms']:.1f}); launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    out = dict(arch=arch.name, n_layers=layers, params=n_par, plan=plan, batch=TRAIN_B,
               T=TRAIN_T, steps=steps, peak_bytes=peak, memory=row, routes=routes,
               launches=launches, nsq_fused=nsq_f.tolist())
    del model, trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def embed_path():
    """Phase 15 (see the module docstring).  Returns its record."""
    lap = stopwatch("phase 15")
    kernels = check_embed_kernels()
    lap("(a) kernels")
    mg = embed_serve(MUSICGEN_ARCH, TRAIN_B, MG_PROMPT, MG_NEW, paged=True, ragged=True,
                     layers=MG_SERVE_LAYERS)
    lap("(b) musicgen serving")
    with expandable_segments():
        ch = embed_serve(CHAMELEON_ARCH, CH_REQUESTS, CH_PROMPT, CH_NEW, paged=False,
                         ragged=False)
    lap("(c) chameleon serving")
    train = musicgen_train()
    lap("(d) musicgen training")
    with expandable_segments():
        cut = chameleon_train()
    lap("(e) chameleon training")
    launches = {k: train["launches"][k] + cut["launches"][k] for k in train["launches"]}
    launches["flash_attn_fwd"] += mg["flash_launches"] + ch["flash_launches"]
    return dict(kernels=kernels, musicgen=mg, chameleon=ch, train=train, cut=cut,
                launches=launches, seconds=lap.secs)



def pipeline_ab():
    """Phase 16 (a): the pipelined block stack against the sequential one
    on the same params (two ``Model``s over one set of tensors) and batch:
    σ = 0 norms², losses and clipped sums, then counted steps in turns
    (sequential, pipelined, pipelined, sequential) on one AdamW state, each
    with its peak."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import algo
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer, TrainState
    arch = dataclasses.replace(get_arch("phi3-mini-3.8b"), n_layers=PP_LAYERS)
    shape, cfg = train_shape_and_config(arch, "block")
    cfg = dataclasses.replace(cfg, dp=dataclasses.replace(cfg.dp, noise_multiplier=0.0))
    pipe = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0, remat="block",
                 pp_stages=PP_STAGES)
    seq = Model(arch, pipe.params, dtype=torch.bfloat16, device="cuda", remat="block")
    M = algo.stage_microbatches(TRAIN_B, PP_STAGES, pipe.pp_microbatches)
    trainers = {"sequential": Trainer(seq, cfg, shape), "pipelined": Trainer(pipe, cfg, shape)}
    batch = trainers["sequential"].make_batch(0)
    out = {}
    for key, tr in trainers.items():
        nsq, losses = algo.norm_pass(tr.model.loss_fn, tr.model.params, batch, cfg.dp)
        grads, _ = algo.make_noisy_grad_fn(tr.model.loss_fn, cfg.dp)(
            tr.model.params, batch, tr.noise_generator(0))
        out[key] = (nsq, losses, grads)
    (nsq_s, loss_s, g_s), (nsq_p, loss_p, g_p) = out["sequential"], out["pipelined"]
    nsq_err = ((nsq_p - nsq_s).abs() / nsq_s.abs()).max().item()
    loss_err = ((loss_p - loss_s).abs() / loss_s.abs()).max().item()
    sum_err = leaf_gap(g_p, g_s)
    del out, g_s, g_p
    assert nsq_err <= NSQ_RTOL and loss_err <= NSQ_RTOL, (nsq_err, loss_err)
    assert sum_err <= CLIP_SUM_TOL, sum_err
    print(f"[pipeline] phi3-mini-3.8b at full width, {PP_LAYERS} layers, B {TRAIN_B} x "
          f"T {TRAIN_T}, bf16, dpsgd_r fused + kernels, remat block: pp_stages "
          f"{PP_STAGES} (M {M}) against 1 on the same params and batch at sigma 0: "
          f"norms² max rel err {nsq_err:.2e}, losses {loss_err:.2e} (limit {NSQ_RTOL}); "
          f"clipped sums {sum_err:.2e} of each leaf's max (limit {CLIP_SUM_TOL})",
          flush=True)

    state = trainers["sequential"].init_state()
    states = {"sequential": state,
              "pipelined": TrainState(state.step, pipe.params, state.opt_state)}
    for key, tr in trainers.items():
        timed_step(tr, states[key])                      # warm-up
    steps = {k: [] for k in trainers}
    launches = dict.fromkeys(read_counts(), 0)
    for key in ("sequential", "pipelined", "pipelined", "sequential"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        rec = timed_step(trainers[key], states[key])
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        counts = read_counts()
        want = path_launches("fused", PP_LAYERS, remat="block",
                             microbatches=M if key == "pipelined" else 1)
        assert counts == want, (key, counts, want)
        rec["launches"] = counts
        launches = {k: launches[k] + counts[k] for k in launches}
        steps[key].append(rec)
    ms = {k: [r["step_ms"] for r in v] for k, v in steps.items()}
    peak = {k: max(r["peak_bytes"] for r in v) for k, v in steps.items()}
    print(f"[pipeline] step ms sequential {ms['sequential']} | pipelined "
          f"{ms['pipelined']} (pipelined / sequential "
          f"{sum(ms['pipelined']) / sum(ms['sequential']):.3f}); peak "
          f"{peak['sequential'] / 2**30:.2f} | {peak['pipelined'] / 2**30:.2f} GiB; "
          f"launches a pipelined step {steps['pipelined'][0]['launches']}", flush=True)
    return dict(layers=PP_LAYERS, stages=PP_STAGES, microbatches=M,
                nsq_rel_err=nsq_err, loss_rel_err=loss_err, clip_sum_err=sum_err,
                steps=steps, peak_bytes=peak, launches=launches)


def leaf_gap(got, want) -> float:
    """The largest gap between two lists of tensors, leaf by leaf, as a
    share of each reference leaf's largest entry."""
    worst = 0.0
    for a, b in zip(got, want, strict=True):
        scale = float(b.abs().max()) or 1.0
        worst = max(worst, float((a.float() - b.float()).abs().max()) / scale)
    return worst


LAUNCH_LINES = {
    "backend": r"\[train\] backend (\w+): rank (\d+) of (\d+) on ([\w:]+)",
    "fingerprint": r"\[train\] init fingerprint (0x[0-9a-f]+) \((\d+) process",
    "step": r"\[trainer\] step\s+(\d+) loss (\S+) grad_norm_mean (\S+) .*?\((\d+) ms\)",
    "estimate": r"\[train\] memory: estimated peak (\S+) GB.*?per device (\S+) GB",
    "measured": r"\[train\] memory: measured peak (\S+) GB",
    "resident": r"\[train\] resident on this rank: params (\d+) B, optimizer state (\d+) B",
    "launches": (r"\[train\] steps \d+\.\.\d+: kernel launches (\{[^}]*\}); "
                 r"collectives (\{[^}]*\}) B in (\d+) calls"),
}


def parse_launcher(text: str) -> dict:
    """What the training launcher's ranks printed: each pattern's matches
    in order, and the step records by step index, one a rank.  A rank's
    line reaches the pipe in one write and its newline in another, so
    another rank's line may follow a line's last token directly: no
    pattern's last field runs on into a ``[``."""
    import re
    out = {k: re.findall(p, text) for k, p in LAUNCH_LINES.items()}
    steps: dict = {}
    for step, loss, gnorm, ms in out["step"]:
        steps.setdefault(int(step), []).append(
            dict(loss=float(loss), grad_norm_mean=float(gnorm), ms=int(ms)))
    out["steps"] = steps
    return out


def launcher_cmd(nproc: int, ckpt_dir: str, arch: str, layers: int, steps: int,
                 sets, mesh=None) -> list:
    """``torch.distributed.run`` of the training launcher: ``arch`` at full
    width on ``layers`` layers, B 8 x T 512, ``steps`` steps, on ``mesh``
    (``(--mesh, --axes)``; default one data axis over ``nproc`` ranks), the
    ``--set`` keys ``sets``, a step line each step and checkpoints in
    ``ckpt_dir``."""
    shape, axes = (str(nproc), "data") if mesh is None else mesh
    sets = [*sets, "log_every=1", f"ckpt_dir={ckpt_dir}"]
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc), "-m", "repro_torch.launch.train",
            "--arch", arch, "--layers", str(layers), "--batch", str(TRAIN_B),
            "--seq", str(TRAIN_T), "--steps", str(steps), "--mesh", shape,
            "--axes", axes, *[x for kv in sets for x in ("--set", kv)]]


def start_launcher(cmd):
    """A launcher world (``cmd``) started in the background: (the process,
    its start time)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return (subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True),
            time.perf_counter())


def launcher_result(started, name, log: str, timeout: float) -> dict:
    """Wait for a world ``start_launcher`` started; its output to
    ``chiprun_out/chip_smoke_<log><name>.log``.  A nonzero exit (a rank's
    failure, a collective's timeout) or the wall-clock limit raises (the
    world is killed)."""
    proc, t = started
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    secs = time.perf_counter() - t
    (ROOT / "chiprun_out" / f"chip_smoke_{log}{name}.log").write_text(
        out + "\n--- stderr\n" + err)
    if proc.returncode != 0:
        raise RuntimeError(f"the launcher's world {name} exited "
                           f"{proc.returncode}:\n{out[-3000:]}\n{err[-3000:]}")
    return dict(parse_launcher(out), seconds=secs)


def ckpt_shard_counts(manifest: dict, leaves) -> list:
    """The shard files of each of ``leaves`` (manifest indices) in a
    launcher checkpoint."""
    return [len(manifest["leaves"][i]["shards"]) for i in leaves]


def zero1_expected_shards(arch, width: int, axis: str = "data"):
    """The shards ZeRO-1 (and FSDP, the same slices) cuts each param's
    optimizer state into on a ``width``-wide data axis: ``width`` where
    ``state_shardings`` puts a dim on ``data``.  ``axis="model"``: the
    slices tensor parallelism cuts each param (and its state) into on a
    ``width``-wide model axis."""
    import types
    from repro_torch.dist import sharding
    from repro_torch.models.transformer import abstract_params, logical_axes
    mesh = types.SimpleNamespace(axis_names=(axis,), shape=(width,))
    return [width if axis in sharding.spec_for_param(ax, p.shape, mesh, fsdp=True)
            else 1 for _, p, ax in sharding._paired(abstract_params(arch),
                                                     logical_axes(arch))]


def ckpt_leaf_gaps(dirs, leaves, step: int, device: str = "cuda"):
    """The largest gap of each checkpoint in ``dirs[1:]`` from ``dirs[0]``'s
    over the leaves ``leaves`` (manifest indices), each restored whole by
    the port's reader and compared on the card, as a share of the
    reference leaf's largest entry; one leaf at a time."""
    from repro_torch.train import checkpoint as ck
    recs = [json.loads((Path(d) / f"step_{step}" / "manifest.json").read_text())
            for d in dirs]
    gaps = [0.0] * (len(dirs) - 1)
    for i in leaves:
        got = [ck._to_torch(ck._read_leaf(str(Path(d) / f"step_{step}"),
                                          r["leaves"][i]), r["leaves"][i]["dtype"])
               .to(device) for d, r in zip(dirs, recs)]
        for k, g in enumerate(got[1:]):
            gaps[k] = max(gaps[k], leaf_gap([g], [got[0]]))
        del got
    return gaps


def printed_unit(x: float) -> float:
    """One unit of the 6th significant digit, the last the launcher prints
    a step's loss with (``:.6g``)."""
    return 10.0 ** (math.floor(math.log10(abs(x))) - 5)


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def worlds_agree(one, two, steps: int, loss_tol, sliced: bool) -> str:
    """The launcher's output of a world of 1 (``one``) and of 2 ranks
    (``two``), as ``launcher_result`` reads them: world 1 on NCCL, world 2's
    ranks on gloo, both on ``cuda:0``; one fingerprint on world 2's ranks,
    and world 1's too unless ``sliced`` (world 2's params are slices, which
    record no bytes); each step's loss and ``grad_norm_mean`` equal on both
    ranks, the loss within ``loss_tol(loss)`` of world 1's and
    ``grad_norm_mean`` within ``NSQ_RTOL``.  Returns world 2's fingerprint;
    raises on a difference."""
    assert [b[0] for b in one["backend"]] == ["nccl"], one["backend"]
    assert sorted(b[0] for b in two["backend"]) == ["gloo", "gloo"], two["backend"]
    assert {b[3] for b in two["backend"]} == {"cuda:0"}, two["backend"]
    fps = {f for f, _ in two["fingerprint"]}
    if not sliced:
        fps |= {f for f, _ in one["fingerprint"]}
    assert len(fps) == 1 and len(one["fingerprint"]) == 1 \
        and len(two["fingerprint"]) == 2, (one["fingerprint"], two["fingerprint"])
    for step in range(steps):
        (a,), (b, c) = one["steps"][step], two["steps"][step]
        assert (b["loss"], b["grad_norm_mean"]) == (c["loss"], c["grad_norm_mean"])
        assert abs(b["loss"] - a["loss"]) <= loss_tol(a["loss"]), (step, a, b)
        assert abs(b["grad_norm_mean"] - a["grad_norm_mean"]) <= \
            NSQ_RTOL * abs(a["grad_norm_mean"]), (step, a, b)
    return fps.pop()


def start_worlds(cmds, log: str) -> dict:
    """The launcher in the named worlds ``cmds`` (name -> (ranks, the
    command ``cmd(ckpt_dir)``)) started side by side on the card, each
    with a checkpoint directory of its own under a temporary one."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{log}_")
    ckpt = {name: str(Path(tmp) / f"world{name}") for name in cmds}
    return dict(log=log, tmp=tmp, ckpt=ckpt, names=list(cmds),
                started={name: start_launcher(cmd(ckpt[name]))
                         for name, (_, cmd) in cmds.items()})


def stop_worlds(worlds: dict) -> None:
    """Kill what is left of ``start_worlds``' worlds (a failure's) and
    remove their directory."""
    import shutil
    for proc, _ in worlds["started"].values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    shutil.rmtree(worlds["tmp"], ignore_errors=True)


def compare_worlds(worlds, *, steps: int, params, moments, shards, timeout: float,
                   loss_tol, sliced) -> dict:
    """Wait for ``start_worlds``' worlds: the first a world of 1 on NCCL,
    each other 2 ranks sharing the card over gloo, each rank its share of
    the batch (half of it on a 2-wide data axis; all of it, alike on both,
    on a 2-wide model or stage axis); each world's output to
    ``chiprun_out/chip_smoke_<log><name>.log``.  Checks, for each world
    after the first: ``worlds_agree`` with the first (``sliced``: the names
    whose params are FSDP, model or stage slices); the leaves of each
    ``(range, counts)`` of ``shards[name]`` (ranges of manifest indices) in
    ``counts`` files each in its checkpoint, in 1 in the first's;
    ``params`` and ``moments`` (ranges) restored whole one leaf at a time
    within ``CLIP_SUM_TOL`` of each leaf's max of the first's.  The
    temporary directories are removed.  Returns the runs, fingerprints,
    gaps and sharded leaves by name."""
    ckpt, tmp = worlds["ckpt"], worlds["tmp"]
    first, *others = worlds["names"]
    runs = {}
    try:
        for name in worlds["names"]:
            runs[name] = launcher_result(worlds["started"][name], name, worlds["log"],
                                         timeout)
            runs[name]["ckpt_bytes"] = dir_bytes(ckpt[name])
        fingerprint = {name: worlds_agree(runs[first], runs[name], steps, loss_tol,
                                          name in sliced) for name in others}
        manifests = {n: json.loads((Path(d) / f"step_{steps}" / "manifest.json")
                                   .read_text()) for n, d in ckpt.items()}
        for name in others:
            for leaves, want in shards[name]:
                assert 2 in want, want
                assert ckpt_shard_counts(manifests[name], leaves) == want, name
                assert ckpt_shard_counts(manifests[first], leaves) == [1] * len(want)
        t = time.perf_counter()
        dirs = [ckpt[first]] + [ckpt[n] for n in others]
        param_gap = dict(zip(others, ckpt_leaf_gaps(dirs, params, steps)))
        moment_gap = dict(zip(others, ckpt_leaf_gaps(dirs, moments, steps)))
        for name in others:
            assert param_gap[name] <= CLIP_SUM_TOL and \
                moment_gap[name] <= CLIP_SUM_TOL, (name, param_gap, moment_gap)
        restore_s = time.perf_counter() - t
    finally:
        stop_worlds(worlds)
    assert not Path(tmp).exists()
    return dict(runs=runs, fingerprint=fingerprint, param_gap=param_gap,
                moment_gap=moment_gap, restore_s=restore_s,
                sharded_leaves={n: sum(x == 2 for x in shards[n][0][1]) for n in others},
                n_params=len(shards[others[0]][0][1]))


def _worlds(cmd, **more):
    """``compare_worlds``' worlds of 1 and 2 ranks of ``cmd(nproc,
    ckpt_dir)``, and ``more`` (name -> (ranks, ``cmd(ckpt_dir)``))."""
    return {1: (1, lambda d: cmd(1, d)), 2: (2, lambda d: cmd(2, d)), **more}


def _world_steps(run) -> list:
    return [[r["ms"] for r in s] for s in run["steps"].values()]


def _world_losses(run) -> list:
    return [s[0]["loss"] for s in run["steps"].values()]


DIST_SETS = ("zero1=true", "compress_pod_grads=true", "pp_stages=2",
             "dp.noise_multiplier=0", "optim.name=adamw", "optim.lr=1e-4",
             "optim.schedule=constant", "dp.norm_strategy=fused",
             "dp.use_kernels=true")


def dist_cmd(nproc: int, ckpt_dir: str) -> list:
    """Phase 16 (b)-(c)'s launcher: phi3-mini at full width on DIST_LAYERS
    layers, ZeRO-1, the compression rider, pp_stages 2, σ 0, AdamW,
    dpsgd_r fused + kernels."""
    return launcher_cmd(nproc, ckpt_dir, "phi3-mini-3.8b", DIST_LAYERS,
                        DIST_STEPS, DIST_SETS)


def dist_path(pipe, worlds):
    """Phase 16 (b)-(c), given (a)'s ``pipeline_ab`` record ``pipe``: the
    launcher (``dist_cmd``) in a world of 1 on NCCL and in 2 ranks sharing
    the card over gloo, side by side with each other and with phase 19's
    worlds (``worlds``, ``start_worlds``' handle; ``compare_worlds``): one
    fingerprint on all 3 ranks, losses within ``NSQ_RTOL`` (the int8 rider
    rounds each rank's share of the gradient), the first moments of (c) in
    2 shard files each, params and first moments within ``CLIP_SUM_TOL``."""
    from repro_torch.configs import get_arch
    arch = dataclasses.replace(get_arch("phi3-mini-3.8b"), n_layers=DIST_LAYERS)
    n = len(zero1_expected_shards(arch, 2))
    # leaves: the step, the params, the compression residuals, then the
    # optimizer's m, master, v
    first_moments = range(1 + 2 * n, 1 + 3 * n)
    got = compare_worlds(worlds, steps=DIST_STEPS, params=range(1, 1 + n),
                         moments=first_moments,
                         shards={2: [(first_moments, zero1_expected_shards(arch, 2))]},
                         timeout=DIST_TIMEOUT, loss_tol=lambda x: NSQ_RTOL * abs(x),
                         sliced=())
    one, two = got["runs"][1], got["runs"][2]
    for k, run in got["runs"].items():
        print(f"[time] phase 16 ({'b' if k == 1 else 'c'}) world of {k}: "
              f"{run['seconds']:.1f} s; its checkpoint {run['ckpt_bytes'] / 1e9:.2f} GB "
              f"on disk", flush=True)
    print(f"[dist] phi3-mini-3.8b at full width, {DIST_LAYERS} layers, B {TRAIN_B} x "
          f"T {TRAIN_T}, ZeRO-1 + int8 compression + pp_stages 2, sigma 0, AdamW, "
          f"{DIST_STEPS} steps: world 1 (nccl) {one['seconds']:.1f} s, steps "
          f"{_world_steps(one)} ms, peak {one['measured']} GB; world 2 (gloo, both "
          f"ranks on cuda:0) {two['seconds']:.1f} s, steps {_world_steps(two)} ms, "
          f"peaks {two['measured']} GB; fingerprint {got['fingerprint'][2]} on all 3 "
          f"ranks; losses {_world_losses(one)} | {_world_losses(two)}; checkpoints "
          f"restored whole ({got['restore_s']:.1f} s): params {got['param_gap'][2]:.2e}, "
          f"first moments {got['moment_gap'][2]:.2e} of each leaf's max (limit "
          f"{CLIP_SUM_TOL}); the 2-rank checkpoint holds {got['sharded_leaves'][2]} of "
          f"{n} moments in 2 shard files; temporary directories removed", flush=True)
    return dict(pipeline=pipe, launches=pipe["launches"], worlds={
        k: {key: v[key] for key in ("backend", "fingerprint", "steps", "estimate",
                                     "measured", "seconds", "ckpt_bytes")}
        for k, v in got["runs"].items()},
        param_gap=got["param_gap"][2], moment_gap=got["moment_gap"][2],
        restore_s=got["restore_s"])


# ---------------------------------------------------------------------------
# phase 18: FSDP (a use_fsdp arch's params sharded over the data axis)
# ---------------------------------------------------------------------------

FSDP_SETS = ("zero1=true", "remat=none", "dp.noise_multiplier=0",
             f"optim.name={FSDP_OPTIM}", "optim.lr=1e-4", "optim.schedule=constant",
             "dp.norm_strategy=fused", "dp.use_kernels=true")


def fsdp_cmd(nproc: int, ckpt_dir: str) -> list:
    """Phase 18's launcher: chameleon-34b at full width on FSDP_LAYERS
    layers, B 8 x T 512 embeddings, ``dpsgd_r`` fused + kernels,
    ``remat="none"``, σ 0, ``FSDP_OPTIM`` at a constant 1e-4, ZeRO-1 (FSDP
    live above 1 rank)."""
    return launcher_cmd(nproc, ckpt_dir, CHAMELEON_ARCH, FSDP_LAYERS, FSDP_STEPS,
                        FSDP_SETS)


def fsdp_path():
    """Phase 18: the launcher on chameleon-34b (``fsdp_cmd``) in a world of 1
    on NCCL, where FSDP is a no-op, and, side by side with it on the card,
    of 2 ranks sharing the card over gloo, each holding its half of every
    sharded param (the step times of each world are taken beside the
    other's).  ``compare_worlds`` checks: each step's loss and
    ``grad_norm_mean`` equal on both ranks, the loss to the 6 digits the
    launcher prints (one unit) and ``grad_norm_mean`` within ``NSQ_RTOL``
    of world 1's; the 2-rank checkpoint's params and momenta in 2 shard
    files where ``param_shardings`` puts a dim on ``data``; restored whole,
    params and momenta (the sums of the steps' gradients) within
    ``CLIP_SUM_TOL`` of each leaf's max of world 1's.  Here: each rank's
    resident param and optimizer-state bytes half of world 1's within
    ``BYTES_RTOL``; each rank's kernel launches equal to ``path_launches``
    for its half batch.  Prints each rank's measured peak beside the
    planner's (conservative: params and optimizer state taken as
    replicated) estimate, each world's step ms, the gathered and reduced
    bytes a step and the phase's seconds."""
    from repro_torch.configs import get_arch
    t0 = time.perf_counter()
    arch = dataclasses.replace(get_arch(CHAMELEON_ARCH), n_layers=FSDP_LAYERS)
    n = len(zero1_expected_shards(arch, 2))
    # leaves: the step, the params, then the optimizer's state (SGD's momenta)
    params, moments = range(1, 1 + n), range(1 + n, 1 + 2 * n)
    counts = zero1_expected_shards(arch, 2)
    got = compare_worlds(start_worlds(_worlds(fsdp_cmd), "fsdp"), steps=FSDP_STEPS,
                         params=params, moments=moments,
                         shards={2: [(params, counts), (moments, counts)]},
                         timeout=FSDP_TIMEOUT, loss_tol=printed_unit, sliced=(2,))
    runs = got["runs"]
    one, two = runs[1], runs[2]
    for k, run in runs.items():
        print(f"[time] phase 18 world of {k}: {run['seconds']:.1f} s; its checkpoint "
              f"{run['ckpt_bytes'] / 1e9:.2f} GB on disk", flush=True)
    # resident bytes: each rank half of world 1's
    (p1, o1), = [tuple(map(int, r)) for r in one["resident"]]
    halves = []
    for p2, o2 in [tuple(map(int, r)) for r in two["resident"]]:
        halves.append((p2 / p1, o2 / o1))
        assert abs(p2 / (p1 / 2) - 1) <= BYTES_RTOL, (p2, p1)
        assert abs(o2 / (o1 / 2) - 1) <= BYTES_RTOL, (o2, o1)
    assert len(halves) == 2, two["resident"]
    # launches: the formula of each rank's batch, every step
    moved = {}
    for nproc, run in runs.items():
        want = path_launches("fused", remat="none", chunks=FSDP_STEPS,
                             **launch_shape(arch, TRAIN_B // nproc, TRAIN_T))
        assert len(run["launches"]) == nproc, run["launches"]
        for launched, coll, _ in run["launches"]:
            assert json.loads(launched) == want, (nproc, launched, want)
        moved[nproc] = [json.loads(coll) for _, coll, _ in run["launches"]]
    per_step = {k: v / FSDP_STEPS for k, v in moved[2][0].items()}
    assert all(per_step.get(k, 0) > 0 for k in ("all-gather", "reduce-scatter"))
    secs = time.perf_counter() - t0
    est = {k: [(float(g), float(d)) for g, d in v["estimate"]] for k, v in runs.items()}
    print(f"[fsdp] {arch.name} at full width, {FSDP_LAYERS} of 48 layers, B {TRAIN_B} x "
          f"T {TRAIN_T} embeddings, dpsgd_r fused + kernels, remat none, sigma 0, "
          f"{FSDP_OPTIM}, ZeRO-1, {FSDP_STEPS} steps, the two worlds side by side on "
          f"the card: world 1 (nccl) {one['seconds']:.1f} s, steps {_world_steps(one)} "
          f"ms; world 2 (gloo, both ranks on cuda:0, FSDP) {two['seconds']:.1f} s, "
          f"steps {_world_steps(two)} ms; losses {_world_losses(one)} | "
          f"{_world_losses(two)}; the 2-rank checkpoint holds {got['sharded_leaves'][2]} "
          f"of {n} params and their momenta in 2 shard files", flush=True)
    print(f"[fsdp] resident a rank: params {[r[0] for r in two['resident']]} B, "
          f"optimizer state {[r[1] for r in two['resident']]} B against world 1's "
          f"{p1} B, {o1} B (ratios {halves}, want 0.5 within {BYTES_RTOL:.0%}); "
          f"measured peaks world 1 {one['measured']} GB, world 2 {two['measured']} GB "
          f"beside the planner's (estimated peak, per device) {est[1]} | {est[2]} GB; "
          f"a step of world 2 moves {per_step} B a rank (all-gather: every sharded "
          f"leaf's whole bytes once a pass, and the losses, norms and mask; "
          f"reduce-scatter: the sharded leaves' whole gradients once; all-reduce: "
          f"the norm scales' gradients and update_norm); launches a rank "
          f"{json.loads(two['launches'][0][0])} = path_launches; checkpoints restored "
          f"whole ({got['restore_s']:.1f} s): params {got['param_gap'][2]:.2e}, momenta "
          f"{got['moment_gap'][2]:.2e} of each leaf's max (limit {CLIP_SUM_TOL})",
          flush=True)
    return dict(worlds={k: {key: v[key] for key in (
        "backend", "fingerprint", "steps", "estimate", "measured", "resident",
        "launches", "seconds", "ckpt_bytes")} for k, v in runs.items()}, halves=halves,
        moved_per_step=per_step, param_gap=got["param_gap"][2],
        moment_gap=got["moment_gap"][2], restore_s=got["restore_s"], seconds=secs)


# ---------------------------------------------------------------------------
# phase 19: tensor parallelism (the dense decoder's params over the model axis)
# ---------------------------------------------------------------------------

TP_SETS = ("remat=none", "dp.noise_multiplier=0", f"optim.name={TP_OPTIM}",
           "optim.lr=1e-4", "optim.schedule=constant", "dp.norm_strategy=fused",
           "dp.use_kernels=true")


def tp_cmd(nproc: int, ckpt_dir: str) -> list:
    """Phase 19's launcher: phi3-mini at full width on TP_LAYERS layers, B 8
    x T 512, ``dpsgd_r`` fused + kernels, ``remat="none"``, σ 0,
    ``TP_OPTIM`` at a constant 1e-4; one rank on a data axis of 1, or two
    on a (1, 2) ``data,model`` mesh."""
    mesh = ("1", "data") if nproc == 1 else (f"1,{nproc}", "data,model")
    return launcher_cmd(nproc, ckpt_dir, "phi3-mini-3.8b", TP_LAYERS, TP_STEPS,
                        TP_SETS, mesh=mesh)


def tp_kernel_checks():
    """The kernels at the shapes a model rank of phase 19 gives them that no
    earlier phase ran, bf16: ``dense_bwd_norm`` at every dense site's local
    (d_in, d_out) (``TP_SHAPES``) and the flash pair at the rank's 16 heads
    of hd 96; every one takes the tensor-core path phase 3 asks of the
    training shapes.  (The embedding's ``gram_norm`` runs at phase 3's
    (B, T, d) masked shape: a rank zeroes the rows of other ranks' ids.)"""
    import torch
    bf16 = torch.bfloat16
    dense = [check_dense_bwd_norm(nm, TRAIN_B, TRAIN_T, di, do, 1, bf16, iters=5)
             for nm, di, do in TP_SHAPES]
    for r in dense:
        assert (r["path"], r["norm_path"]) == ("wgmma+tma", "wgmma+tma"), r
    heads = 16
    fwd = check_flash("tp-train", TRAIN_B, heads, heads, TRAIN_T, 96, True, bf16)
    bwd = check_flash_bwd("tp-train", TRAIN_B * heads, TRAIN_B * heads, TRAIN_T, 96,
                          True, bf16, iters=5)
    assert bwd["path"] == "mma+cp.async", bwd["path"]
    return dict(dense=dense, flash_fwd=fwd, flash_bwd=bwd)


def stage_cmd(ckpt_dir: str) -> list:
    """Phase 19's stage world: ``tp_cmd``'s run on two ranks of a (1, 2)
    ``data,stage`` mesh, ``pp_stages`` 2 (2 microbatches), each rank holding
    the blocks of its stage."""
    return launcher_cmd(2, ckpt_dir, "phi3-mini-3.8b", TP_LAYERS, TP_STEPS,
                        (*TP_SETS, "pp_stages=2"), mesh=("1,2", "data,stage"))


def stage_launches(index: int, width: int, route: str, L: int, **kw):
    """``path_launches`` of stage rank ``index`` of a ``width``-wide stage
    axis of the dense decoder with ``L`` layers: its ``L / width`` layers'
    sites and attention, the embedding's ``gram_norm`` on the first rank
    alone and the head's site on the last alone."""
    return path_launches(route, L // width, embeds=int(index == 0),
                         head=int(index == width - 1), **kw)


def stage_moved(arch, B: int, T: int, element: int = 2) -> list:
    """The bytes each stage rank of a (1, 2) ``data,stage`` mesh moves in one
    ``dpsgd_r`` step of ``arch`` at B x T (activations of ``element``
    bytes), by kind, as the launcher meters them (``runtime._record``: a
    send its bytes, a broadcast and an all-reduce the result's size on one
    rank): [the first rank's, the last's].  Sends: each of the two forwards
    carries the activations (B, T, d) and the (B,) aux total forward, pass
    1 also the (B,) norm accumulator, and each backward their cotangents
    back; the last rank gives its (B,) float32 losses to the first after
    each forward.  Broadcasts: the float32 clipped sums of the embedding
    (from the first), the final norm and the head (from the last), on both
    ranks.  All-reduces: the (B,) norms² and ``update_norm``'s partial
    square over the stage group."""
    from repro_torch.models.transformer import padded_vocab
    d, V = arch.d_model, padded_vocab(arch.vocab)
    sends = 2 * B * T * d * element + 4 * B + 2 * 4 * B
    common = {"broadcast": 4 * (2 * V * d + d), "all-reduce": 4 * B + 4}
    return [dict(common, send=sends), dict(common, send=sends + 2 * 4 * B)]


def replicated_bytes(arch, width: int, optim: str, axis: str = "model"):
    """(param bytes, optimizer-state bytes) of the leaves every rank of a
    ``width``-wide ``axis`` holds whole (on a model axis the norm scales;
    on a stage axis the embedding, final norm and head), as the launcher's
    params (bf16 weights, float32 scales) and ``optim``'s state make
    them."""
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import OptimConfig
    from repro_torch.models.transformer import abstract_params
    from repro_torch.optim.optimizers import make_optimizer
    counts = zero1_expected_shards(arch, width, axis=axis)
    whole = [p for p, c in zip(tree.leaves(abstract_params(arch, torch.bfloat16)),
                               counts) if c == 1]
    state = make_optimizer(OptimConfig(name=optim)).init(whole)
    return (sum(p.numel() * p.element_size() for p in whole),
            sum(t.numel() * t.element_size() for t in tree.leaves(state)))


def halved(one, two, replicated) -> list:
    """Each rank of world ``two``'s (2 x its resident bytes - the bytes of
    the leaves every rank holds whole) / world ``one``'s, params and
    optimizer state, each within ``BYTES_RTOL`` of 1."""
    (p1, o1), = [tuple(map(int, r)) for r in one["resident"]]
    rp, ro = replicated
    halves = []
    for p2, o2 in [tuple(map(int, r)) for r in two["resident"]]:
        halves.append(((2 * p2 - rp) / p1, (2 * o2 - ro) / o1))
        assert abs((2 * p2 - rp) / p1 - 1) <= BYTES_RTOL, (p2, p1, rp)
        assert abs((2 * o2 - ro) / o1 - 1) <= BYTES_RTOL, (o2, o1, ro)
    assert len(halves) == 2, two["resident"]
    return halves


def tp_path(kernels):
    """Phase 19, the model and stage axes, after the kernels at a model
    rank's local shapes (``kernels``, ``tp_kernel_checks``' record): the
    launcher on phi3-mini in three worlds side by side on the card (and
    beside phase 16 (b)-(c)'s): a world of 1 on NCCL
    (``tp_cmd``), 2 ranks sharing the card over gloo on a (1, 2) data,model
    mesh, each holding half of the heads, FFN and vocabulary and taking the
    whole batch, and 2 ranks on a (1, 2) data,stage mesh with ``pp_stages``
    2 (``stage_cmd``), each holding one layer's blocks and the whole of the
    embedding, final norm and head.  ``compare_worlds`` checks each 2-rank
    world against world 1: each step's loss and ``grad_norm_mean`` equal on
    both ranks and within ``NSQ_RTOL`` of world 1's (the bf16 row-parallel
    sums reorder; the stage world's pipeline runs its blocks a microbatch
    at a time); the checkpoint's sliced params and their momenta in 2 shard
    files and the rest in 1; restored whole, params and momenta within
    ``CLIP_SUM_TOL`` of each leaf's max of world 1's.  Here: each rank's
    resident param and optimizer-state bytes half of world 1's within
    ``BYTES_RTOL`` once the leaves each rank holds whole are added back;
    the model ranks' kernel launches equal to ``path_launches`` of the
    whole batch (every count is by site, not by width), the stage ranks'
    to ``stage_launches`` of each rank, which sum to the pipelined whole's
    ``path_launches``; the stage ranks' bytes moved a step by kind equal to
    ``stage_moved``'s.  Prints each world's step ms, each rank's measured
    peak beside the planner's per-device estimate (a trace of the rank's
    slices), the bytes moved a step by kind and the phase's seconds."""
    from repro_torch.configs import get_arch
    t0 = time.perf_counter()
    arch = dataclasses.replace(get_arch("phi3-mini-3.8b"), n_layers=TP_LAYERS)
    counts = zero1_expected_shards(arch, 2, axis="model")
    by_stage = zero1_expected_shards(arch, 2, axis="stage")
    n = len(counts)
    # leaves: the step, the params, then the optimizer's state (SGD's momenta)
    params, moments = range(1, 1 + n), range(1 + n, 1 + 2 * n)
    got = compare_worlds(start_worlds(_worlds(tp_cmd, stage=(2, stage_cmd)), "tp"),
                         steps=TP_STEPS, params=params, moments=moments,
                         shards={2: [(params, counts), (moments, counts)],
                                 "stage": [(params, by_stage), (moments, by_stage)]},
                         timeout=TP_TIMEOUT, loss_tol=lambda x: NSQ_RTOL * abs(x),
                         sliced=(2, "stage"))
    runs = got["runs"]
    one, two, stage = runs[1], runs[2], runs["stage"]
    for k, run in runs.items():
        print(f"[time] phase 19 world {k}: {run['seconds']:.1f} s; its checkpoint "
              f"{run['ckpt_bytes'] / 1e9:.2f} GB on disk", flush=True)
    halves = halved(one, two, replicated_bytes(arch, 2, TP_OPTIM))
    stage_rep = replicated_bytes(arch, 2, TP_OPTIM, axis="stage")
    stage_halves = halved(one, stage, stage_rep)
    want = path_launches("fused", remat="none", chunks=TP_STEPS,
                         **launch_shape(arch, TRAIN_B, TRAIN_T))
    moved = {}
    for nproc, run in ((1, one), (2, two)):
        assert len(run["launches"]) == nproc, run["launches"]
        for launched, coll, _ in run["launches"]:
            assert json.loads(launched) == want, (nproc, launched, want)
        moved[nproc] = [json.loads(coll) for _, coll, _ in run["launches"]]
    per_step = {k: v / TP_STEPS for k, v in moved[2][0].items()}
    assert per_step.get("all-reduce", 0) > 0, per_step
    # the stage ranks, in the order their lines came: each its own stage's
    # launches, which sum to the pipelined whole's, and its bytes a step
    kw = dict(remat="none", chunks=TP_STEPS, microbatches=2)
    ranks = [stage_launches(i, 2, "fused", TP_LAYERS, **kw) for i in range(2)]
    whole = path_launches("fused", TP_LAYERS, **kw)
    assert {k: ranks[0][k] + ranks[1][k] for k in whole} == whole, (ranks, whole)
    got_launches = [json.loads(launched) for launched, _, _ in stage["launches"]]
    assert sorted(json.dumps(x, sort_keys=True) for x in got_launches) == \
        sorted(json.dumps(x, sort_keys=True) for x in ranks), (
        got_launches, ranks)
    stage_step = [{k: v // TP_STEPS for k, v in json.loads(coll).items()}
                  for _, coll, _ in stage["launches"]]
    predicted = stage_moved(arch, TRAIN_B, TRAIN_T)
    assert sorted(json.dumps(x, sort_keys=True) for x in stage_step) == \
        sorted(json.dumps(x, sort_keys=True) for x in predicted), (
        stage_step, predicted)
    secs = time.perf_counter() - t0
    est = {k: [(float(g), float(d)) for g, d in v["estimate"]] for k, v in runs.items()}
    print(f"[tp] phi3-mini-3.8b at full width, {TP_LAYERS} of 32 layers, B {TRAIN_B} x "
          f"T {TRAIN_T}, dpsgd_r fused + kernels, remat none, sigma 0, {TP_OPTIM}, "
          f"{TP_STEPS} steps, three worlds side by side on the card: world 1 (nccl) "
          f"{one['seconds']:.1f} s, steps {_world_steps(one)} ms; world 2 (gloo, both "
          f"ranks on cuda:0, a (1, 2) data,model mesh) {two['seconds']:.1f} s, steps "
          f"{_world_steps(two)} ms; losses {_world_losses(one)} | {_world_losses(two)}; "
          f"the 2-rank checkpoint holds {got['sharded_leaves'][2]} of {n} params and "
          f"their momenta in 2 shard files", flush=True)
    (p1, o1), (rp, ro) = one["resident"][0], replicated_bytes(arch, 2, TP_OPTIM)
    print(f"[tp] resident a rank: params {[r[0] for r in two['resident']]} B, "
          f"optimizer state {[r[1] for r in two['resident']]} B against world 1's "
          f"{p1} B, {o1} B; with the norm scales ({rp} B, state {ro} B) added back, "
          f"2 x rank / world 1 {halves} (want 1 within {BYTES_RTOL:.0%}); measured "
          f"peaks world 1 {one['measured']} GB, world 2 {two['measured']} GB beside "
          f"the planner's (estimated peak, per device) {est[1]} | {est[2]} GB; a step "
          f"of world 2 moves {per_step} B a rank (all-reduce: every layer's "
          f"row-parallel outputs and its inputs' gradients, the embedding rows, the "
          f"cross-entropy's max, sum and target, the norms², update_norm); launches a "
          f"rank {json.loads(two['launches'][0][0])} = path_launches; checkpoints "
          f"restored whole ({got['restore_s']:.1f} s): params {got['param_gap'][2]:.2e}, "
          f"momenta {got['moment_gap'][2]:.2e} of each leaf's max (limit "
          f"{CLIP_SUM_TOL}); the worlds {secs:.1f} s", flush=True)
    print(f"[stage] phi3-mini-3.8b at full width, {TP_LAYERS} of 32 layers, B "
          f"{TRAIN_B} x T {TRAIN_T}, the same run on 2 ranks sharing the card over "
          f"gloo on a (1, 2) data,stage mesh, pp_stages 2, M 2, beside the other two "
          f"worlds: {stage['seconds']:.1f} s, steps {_world_steps(stage)} ms; losses "
          f"{_world_losses(one)} | {_world_losses(stage)}; the checkpoint holds "
          f"{got['sharded_leaves']['stage']} of {n} params (the blocks) and their "
          f"momenta in 2 shard files, the rest in 1", flush=True)
    print(f"[stage] resident a rank: params {[r[0] for r in stage['resident']]} B, "
          f"optimizer state {[r[1] for r in stage['resident']]} B against world 1's "
          f"{one['resident'][0][0]} B, {one['resident'][0][1]} B; with the whole "
          f"leaves (embedding, final norm, head: {stage_rep[0]} B, state "
          f"{stage_rep[1]} B) added back, (2 x rank - whole) / world 1 "
          f"{stage_halves} (want 1 within {BYTES_RTOL:.0%}); measured peaks "
          f"{stage['measured']} GB beside the planner's (a trace of the rank's "
          f"stage) {[(float(g), float(d)) for g, d in stage['estimate']]} GB; a step "
          f"moves {stage_step} B by rank (predicted {predicted}: sends of the "
          f"activations forward and their cotangents back, the losses, the "
          f"broadcast float32 sums of the embedding and the head, the norms²); "
          f"launches by rank {got_launches} = stage_launches, summing to the "
          f"pipelined whole's {whole}; checkpoints restored whole: params "
          f"{got['param_gap']['stage']:.2e}, momenta {got['moment_gap']['stage']:.2e} "
          f"of each leaf's max (limit {CLIP_SUM_TOL})", flush=True)
    return dict(kernels=kernels, worlds={k: {key: v[key] for key in (
        "backend", "fingerprint", "steps", "estimate", "measured", "resident",
        "launches", "seconds", "ckpt_bytes")} for k, v in runs.items()}, halves=halves,
        moved_per_step=per_step, param_gap=got["param_gap"][2],
        moment_gap=got["moment_gap"][2], restore_s=got["restore_s"],
        stage=dict(halves=stage_halves, moved_per_step=stage_step, predicted=predicted,
                   launches=got_launches, param_gap=got["param_gap"]["stage"],
                   moment_gap=got["moment_gap"]["stage"]), seconds=secs)


# ---------------------------------------------------------------------------
# phase 20: the dry-run, and prefill and decode on model slices
# ---------------------------------------------------------------------------

def dryrun_cmd(out: str, group: int) -> list:
    """Phase 20 (a)'s subprocess of ``DRYRUN_GROUPS[group]``:
    ``dryrun_cells`` into ``out``."""
    return [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-cells", out,
            str(group)]


def serve_tp_cells():
    """Phase 20 (b)'s configuration as ``launch/dryrun.py`` cells: (the
    arch cut to ``SERVE_TP_LAYERS``, {kind: its ``ShapeConfig``}) of the
    prefill of ``SERVE_TP_B`` x ``SERVE_TP_T`` and of a decode step
    against a cache of ``SERVE_TP_S``, on a traced (1, 2) data,model mesh."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    arch = dataclasses.replace(get_arch("phi3-mini-3.8b"), n_layers=SERVE_TP_LAYERS)
    return arch, {kind: ShapeConfig(f"serve_tp_{kind}", seq, SERVE_TP_B, kind)
                  for kind, seq in (("prefill", SERVE_TP_T), ("decode", SERVE_TP_S))}


def dryrun_cells(out: str, group: int) -> None:
    """``launch/dryrun.py`` ``run_cell`` on fake CUDA tensors, artifacts in
    ``out``: phi3-mini's ``DRYRUN_CELLS`` of ``DRYRUN_GROUPS[group]``; the
    last group also ``DRYRUN_REFUSED`` and phase 20 (b)'s two cells (the
    body of ``dryrun_cmd``)."""
    from repro_torch.launch import dryrun
    for i in DRYRUN_GROUPS[group]:
        dryrun.run_cell("phi3-mini-3.8b", *DRYRUN_CELLS[i], out, device="cuda")
    if group == len(DRYRUN_GROUPS) - 1:
        dryrun.run_cell(*DRYRUN_REFUSED, out, device="cuda")
        arch, shapes = serve_tp_cells()
        for shape in shapes.values():
            dryrun.run_cell(arch, shape, "serve-tp", out, mesh_shape="1,2",
                            mesh_axes="data,model", device="cuda")


def start_dryrun(out: Path) -> list:
    """Phase 20 (a)'s subprocesses (``dryrun_cmd``), one a group, started
    side by side."""
    return [start_launcher(dryrun_cmd(str(out), g)) for g in range(len(DRYRUN_GROUPS))]


def stop_dryrun(started) -> None:
    """Kill what is left of ``start_dryrun``'s subprocesses."""
    for proc, _ in started:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def dryrun_path(started, out: Path) -> dict:
    """Phase 20 (a): wait for ``start_dryrun``'s subprocesses (their output
    to ``chiprun_out/chip_smoke_dryrun<group>.log``) and read the
    artifacts: every phi3 cell ``ok``, each train cell's rank peak under the
    card's memory; the refused cell ``ok: false`` with a
    ``NotImplementedError`` naming ROADMAP.  Prints each cell's rank peak,
    FLOPs, collective bytes and roofline terms and its trace's seconds."""
    import torch
    t = time.perf_counter()
    try:
        for group, (proc, _) in enumerate(started):
            text, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
            (ROOT / "chiprun_out" / f"chip_smoke_dryrun{group}.log").write_text(
                text + "\n--- stderr\n" + err)
            if proc.returncode != 0:
                raise RuntimeError(f"the dry-run's cells (group {group}) exited "
                                   f"{proc.returncode}:\n{text[-3000:]}\n{err[-3000:]}")
    finally:
        stop_dryrun(started)
    card = torch.cuda.get_device_properties(0).total_memory
    cells = {}
    for shape, mesh in DRYRUN_CELLS:
        rec = json.loads((out / f"phi3-mini-3.8b--{shape}--{mesh}.json").read_text())
        assert rec["ok"], (shape, mesh, rec.get("error"), rec.get("traceback"))
        peak = rec["rank_memory"]["peak_bytes"]
        if rec["shape"] == "train_4k":
            assert peak < card, (shape, mesh, peak, card)
        roof = rec["roofline"]
        print(f"[dryrun] phi3-mini-3.8b {shape} on the {mesh} mesh "
              f"({rec['mesh_shape']}, batch over {rec['batch_axes']}"
              + (f", grad_accum {rec['grad_accum']}" if "grad_accum" in rec else "")
              + f"), one rank's trace on fake CUDA tensors: rank peak "
              f"{peak / 1e9:.3f} GB (the card {card / 1e9:.1f} GB; at "
              f"{rec['rank_memory']['peak_op']}), rank {rec['rank_flops']:.4e} FLOPs "
              f"and {rec['rank_bytes']:.4e} B, collectives a rank "
              f"{rec['collective_bytes_per_device']['total']:.4e} wire B "
              f"{ {k: v for k, v in rec['collective_bytes_per_device'].items() if k != 'total'} }; "
              f"global {rec['analytic']['total_flops']:.4e} FLOPs, peak "
              f"{rec['memory']['peak_bytes'] / 1e9:.2f} GB; H100 roofline compute "
              f"{roof['compute_s']:.4e} s, memory {roof['memory_s']:.4e} s, "
              f"collective {roof['collective_s']:.4e} s ({roof['bottleneck']}), "
              f"model / traced FLOPs {roof['model_vs_hlo_flops']:.3f}; trace "
              f"{rec['trace_s']:.1f} s", flush=True)
        cells[f"{shape}/{mesh}"] = {k: rec[k] for k in (
            "rank_memory", "rank_flops", "rank_bytes", "collective_bytes_per_device",
            "roofline", "trace_s", "total_s", "batch_axes", "memory")}
    arch, shape, mesh = DRYRUN_REFUSED
    rec = json.loads((out / f"{arch}--{shape}--{mesh}.json").read_text())
    assert rec["ok"] is False and rec["error"].startswith("NotImplementedError: ") \
        and "ROADMAP" in rec["error"], rec
    waited = time.perf_counter() - t
    print(f"[dryrun] {arch} {shape} on the {mesh} mesh refused, as recorded: "
          f"{rec['error']}; the cells' traces {[c['total_s'] for c in cells.values()]} "
          f"s in {len(started)} subprocesses beside phases 17 (c) to 19, "
          f"{waited:.1f} s waited after them", flush=True)
    return dict(cells=cells, refused=rec["error"], waited=waited)


def serve_tp_cmd(out: str) -> list:
    """Phase 20 (b)'s two gloo ranks: ``serve_tp_rank`` under
    ``torch.distributed.run`` (``env://``), their logits to ``out``."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", str(ROOT / "chip_smoke.py"), "--serve-tp-rank", out]


def serve_tp_model(compute: str, mesh=None):
    """phi3-mini at full width on ``SERVE_TP_LAYERS`` layers, seeded bf16
    weights on the card (the same bits whatever the compute type),
    activations in ``compute``: whole, or this rank's slices on ``mesh``
    (seeded init draws only them)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import Model
    arch = dataclasses.replace(get_arch("phi3-mini-3.8b"), n_layers=SERVE_TP_LAYERS)
    return Model(arch, seed=0, mesh=mesh, dtype=getattr(torch, compute),
                 param_dtype=torch.bfloat16)


def serve_tp_greedy(model) -> dict:
    """``SERVE_TP_B`` seeded prompts of ``SERVE_TP_T`` tokens prefilled into
    a cache of ``SERVE_TP_S``, then ``SERVE_TP_STEPS`` greedy decode steps,
    under the active layout: the greedy tokens (steps + 1, B), every step's
    last-position logits (``logits``, (steps + 1, B, Vpad) on the host), the
    collectives metered in the prefill and in the first decode step
    (``dryrun.collective_summary``), the cache's and the params' bytes, the
    launches (counted from zero) and the times."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.dist import runtime
    from repro_torch.launch.dryrun import collective_summary
    V = model.arch.vocab
    rng = np.random.default_rng(20)
    prompts = torch.from_numpy(rng.integers(0, V, (SERVE_TP_B, SERVE_TP_T))).cuda()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with runtime.metered() as pre:
        logits, cache = model.prefill(prompts, SERVE_TP_S)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps, toks, dec = [logits[:, -1]], [logits[:, -1, :V].argmax(-1)], None
    for i in range(SERVE_TP_STEPS):
        pos = torch.full((SERVE_TP_B,), SERVE_TP_T + i, device=prompts.device)
        with runtime.metered() as rec:
            logits, cache = model.decode_step(cache, toks[-1][:, None], pos)
        dec = rec if dec is None else dec
        steps.append(logits[:, -1])
        toks.append(logits[:, -1, :V].argmax(-1))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(tokens=torch.stack(toks).cpu().tolist(),
                logits=torch.stack(steps).cpu(), launches=read_counts(),
                prefill_records=collective_summary(pre),
                decode_records=collective_summary(dec),
                cache_bytes=sum(t.numel() * t.element_size() for t in tree.leaves(cache)),
                param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
                prefill_ms=1e3 * (t1 - t0), decode_ms=1e3 * (t2 - t1) / SERVE_TP_STEPS)


def serve_tp_rank(out: str) -> int:
    """One of phase 20 (b)'s ranks: on a (1, 2) data,model mesh over gloo,
    both ranks on the card, ``serve_tp_greedy`` of its slices in bf16 and
    then in float32 over the same bf16 weights; each run's logits saved to
    ``out`` (``rank<r>_<compute>.pt``), the rest printed as one
    ``[serve-tp-rank]`` JSON line."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.dist import runtime
    from repro_torch.launch.mesh import make_mesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method="env://",
                            timeout=datetime.timedelta(seconds=SERVE_TP_TIMEOUT))
    rank = dist.get_rank()
    mesh = make_mesh((1, 2), ("data", "model"))
    got = {}
    for compute in SERVE_TP_COMPUTE:
        model = serve_tp_model(compute, mesh)
        with runtime.layout(mesh, None):
            run = serve_tp_greedy(model)
        del model
        torch.cuda.empty_cache()
        torch.save(run.pop("logits"), Path(out) / f"rank{rank}_{compute}.pt")
        got[compute] = run
    print("[serve-tp-rank] " + json.dumps(dict(rank=rank, runs=got)), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _first_divergence(a, b) -> list:
    """For each prompt, the first step whose greedy token differs between
    the token streams ``a`` and ``b`` ((steps + 1, B) lists), or their
    length when none does."""
    n = len(a)
    return [next((i for i in range(n) if a[i][j] != b[i][j]), n)
            for j in range(len(a[0]))]


def serve_tp_path(cells_dir: Path) -> dict:
    """Phase 20 (b): ``flash_attn_fwd`` against its plain version at a model
    rank's prefill shape (``SERVE_TP_B`` x 16 heads, T ``SERVE_TP_T``, hd
    96) in both compute types; then the two ranks (``serve_tp_cmd``) beside
    a world of one in this process on whole params of the same seed, in
    bf16 and in float32 over the same bf16 weights (``SERVE_TP_COMPUTE``),
    and the checks.  float32: greedy tokens equal over every step, logits
    within ``SERVE_TP_F32_TOL`` of the largest.  bf16: the prefill's
    logits, and each prompt's logits up to its first differing greedy token
    (a near-tie of the top two bf16 logits, which a row-parallel sum's
    other rounding can flip, after which the streams are two
    conversations), within ``SERVE_TP_TOL``; the agreeing prefixes printed.
    Each rank's cache bytes exactly half of world 1's, its param bytes half
    once the norm scales each holds whole are added back (``BYTES_RTOL``);
    its collectives of the prefill and of a decode step those of
    ``launch/dryrun.py``'s cells of the same configuration on a traced (1,
    2) mesh (``serve_tp_cells``, traced by phase 20 (a) into
    ``cells_dir``); ``flash_attn_fwd`` launched once a layer in each
    prefill."""
    import shutil
    import tempfile
    import torch
    t0 = time.perf_counter()
    kernels = {c: check_flash(f"serve-tp-{c}", SERVE_TP_B, 16, 16, SERVE_TP_T, 96, True,
                              getattr(torch, c)) for c in SERVE_TP_COMPUTE}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_tp_")
    started = start_launcher(serve_tp_cmd(tmp))
    try:
        one = {}
        for compute in SERVE_TP_COMPUTE:
            model = serve_tp_model(compute)
            one[compute] = serve_tp_greedy(model)
            arch = model.arch
            del model
            gc.collect()
            torch.cuda.empty_cache()
        proc, t = started
        text, err = proc.communicate(timeout=SERVE_TP_TIMEOUT)
        (ROOT / "chiprun_out" / "chip_smoke_serve_tp.log").write_text(
            text + "\n--- stderr\n" + err)
        if proc.returncode != 0:
            raise RuntimeError(f"the serving ranks exited {proc.returncode}:\n"
                               f"{text[-3000:]}\n{err[-3000:]}")
        ranks = sorted((json.loads(ln.split(" ", 1)[1]) for ln in text.splitlines()
                        if ln.startswith("[serve-tp-rank] ")), key=lambda r: r["rank"])
        assert len(ranks) == 2, text[-3000:]
        for r in ranks:
            for compute in SERVE_TP_COMPUTE:
                r["runs"][compute]["logits"] = torch.load(
                    Path(tmp) / f"rank{r['rank']}_{compute}.pt")
    finally:
        if started[0].poll() is None:
            started[0].kill()
            started[0].communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    cells = {kind: json.loads((cells_dir / f"{arch.name}--{shape.name}--serve-tp.json"
                               ).read_text())
             for kind, shape in serve_tp_cells()[1].items()}
    rep_params = replicated_bytes(arch, 2, TP_OPTIM)[0]
    gaps, halves, agree = {c: [] for c in SERVE_TP_COMPUTE}, [], []
    for r in ranks:
        bf, f32 = r["runs"]["bfloat16"], r["runs"]["float32"]
        # float32: the same greedy streams, every step's logits close
        assert f32["tokens"] == one["float32"]["tokens"], (
            r["rank"], _first_divergence(f32["tokens"], one["float32"]["tokens"]))
        want = one["float32"]["logits"]
        gap = ((f32["logits"] - want).abs().max() / want.abs().max()).item()
        assert gap <= SERVE_TP_F32_TOL, (r["rank"], gap)
        gaps["float32"].append(gap)
        # bf16: each prompt's logits up to its first differing token
        first = _first_divergence(bf["tokens"], one["bfloat16"]["tokens"])
        agree.append(first)
        want = one["bfloat16"]["logits"].float()
        got = bf["logits"].float()
        for b, k in enumerate(first):
            steps = slice(0, min(k + 1, len(bf["tokens"])))
            gap = ((got[steps, b] - want[steps, b]).abs().max()
                   / want[steps, b].abs().max()).item()
            assert gap <= SERVE_TP_TOL, (r["rank"], b, k, gap)
            gaps["bfloat16"].append(gap)
        for compute, run in r["runs"].items():
            w1 = one[compute]
            assert 2 * run["cache_bytes"] == w1["cache_bytes"], (run["cache_bytes"],
                                                                 w1["cache_bytes"])
            assert run["launches"]["flash_attn_fwd"] == SERVE_TP_LAYERS, run["launches"]
        half = (2 * bf["param_bytes"] - rep_params) / one["bfloat16"]["param_bytes"]
        assert abs(half - 1) <= BYTES_RTOL, (bf["param_bytes"], one["bfloat16"]["param_bytes"])
        halves.append(half)
        for kind in ("prefill", "decode"):
            want = [list(x) for x in cells[kind]["collective_records"]]
            assert cells[kind]["ok"] and [list(x) for x in bf[f"{kind}_records"]] == want, (
                kind, bf[f"{kind}_records"], want)
    for run in one.values():
        assert run["launches"]["flash_attn_fwd"] == SERVE_TP_LAYERS, run["launches"]
    moved = {kind: sum(n * b for k, b, g, n in cells[kind]["collective_records"])
             for kind in ("prefill", "decode")}
    secs = time.perf_counter() - t0
    bf1 = one["bfloat16"]
    print(f"[serve-tp] phi3-mini-3.8b at full width, {SERVE_TP_LAYERS} of 32 layers, "
          f"seeded bf16 weights: {SERVE_TP_B} prompts of {SERVE_TP_T} into a cache of "
          f"{SERVE_TP_S}, {SERVE_TP_STEPS} greedy decode steps, on 2 gloo ranks of a "
          f"(1, 2) data,model mesh sharing the card (16 heads, 4096 FFN columns, 16128 "
          f"vocab rows each) against a world of one: float32 compute: greedy tokens "
          f"equal over {len(bf1['tokens'])} positions of {SERVE_TP_B} prompts, logits "
          f"within {max(gaps['float32']):.3e} of the largest (limit {SERVE_TP_F32_TOL}); "
          f"bf16 compute: greedy streams agree for {agree} steps of "
          f"{len(bf1['tokens'])} by rank and prompt (a near-tie flips them apart), "
          f"logits up to each prompt's first differing token within "
          f"{max(gaps['bfloat16']):.3e} of the largest (limit {SERVE_TP_TOL})",
          flush=True)
    print(f"[serve-tp] bf16: cache a rank {ranks[0]['runs']['bfloat16']['cache_bytes']} B "
          f"= world 1's {bf1['cache_bytes']} B / 2; params a rank "
          f"{[r['runs']['bfloat16']['param_bytes'] for r in ranks]} B against "
          f"{bf1['param_bytes']} B, (2 x rank - the norm scales {rep_params} B) / world 1 "
          f"{halves}; collectives a rank = the dry-run's traced cells: prefill "
          f"{moved['prefill']} B, a decode step {moved['decode']} B "
          f"({cells['decode']['collective_records']}); flash_attn_fwd {SERVE_TP_LAYERS} "
          f"launches a prefill on each process and compute type; prefill ms "
          f"{[round(r['runs']['bfloat16']['prefill_ms'], 1) for r in ranks]} against "
          f"{bf1['prefill_ms']:.1f}, decode ms a step "
          f"{[round(r['runs']['bfloat16']['decode_ms'], 2) for r in ranks]} against "
          f"{bf1['decode_ms']:.2f} (float32: "
          f"{[round(r['runs']['float32']['decode_ms'], 2) for r in ranks]} against "
          f"{one['float32']['decode_ms']:.2f}); {secs:.1f} s", flush=True)
    launches = sum(run["launches"]["flash_attn_fwd"] for r in ranks
                   for run in r["runs"].values())
    launches += sum(run["launches"]["flash_attn_fwd"] for run in one.values())
    return dict(kernels=kernels, agree=agree, logit_gap=gaps, param_halves=halves,
                cache_bytes=[r["runs"]["bfloat16"]["cache_bytes"] for r in ranks]
                + [bf1["cache_bytes"]], moved=moved, launches=launches,
                prefill_ms={c: [r["runs"][c]["prefill_ms"] for r in ranks]
                            + [one[c]["prefill_ms"]] for c in SERVE_TP_COMPUTE},
                decode_ms={c: [r["runs"][c]["decode_ms"] for r in ranks]
                           + [one[c]["decode_ms"]] for c in SERVE_TP_COMPUTE},
                seconds=secs)


# ---------------------------------------------------------------------------
# phase 17: the launch tools (launch/roofline.py, costs.py, autotune.py)
# ---------------------------------------------------------------------------

def kernel_record_flops(arch, layers, B, T, launches):
    """The FLOPs each kernel's cost records should hold over ``launches``
    (``path_launches`` of a dense-decoder step at B x T with ``layers``
    layers): this script's per-launch formulas with the causal and the
    symmetric-tile halvings removed (a record is the plain version's work)
    times the launches.  The flash pair at B·H heads (4·BH·T²·hd forward,
    10·BH·T²·hd backward), ``gram_norm`` at the embedding rule (2·B·T²·d),
    ``dense_bwd_norm`` its two products and ``pegrad_norm`` and
    ``dense_dgrad`` one each, over ``dense_mix``'s calls (a launch count
    that is a whole number of passes over them)."""
    BH, hd = B * arch.n_heads, arch.hd
    mix = dense_mix(arch, layers)
    calls = sum(n for *_, n in mix)
    one_pass = sum(n * dense_flops(B, T, di, do) for _, di, do, n in mix)

    def dense(n, products):
        assert n % calls == 0, (n, calls)
        return products * one_pass * n // calls

    return {"flash_attn_fwd": launches["flash_attn_fwd"]
            * flash_fwd_flops(BH, T, T, hd, causal=False),
            "flash_attn_bwd": launches["flash_attn_bwd"]
            * flash_bwd_flops(BH, T, hd, causal=False),
            "gram_norm": launches["gram_norm"]
            * gram_flops(B, T, 0, arch.d_model, square=False, tiles=False),
            "dense_bwd_norm": dense(launches["dense_bwd_norm"], 2),
            "pegrad_norm": dense(launches["pegrad_norm"], 1),
            "dense_dgrad": dense(launches["dense_dgrad"], 1),
            "clip_reduce": 0.0}


def plan_launches(arch, plan: dict, B=TRAIN_B, T=TRAIN_T):
    """``path_launches`` of one ``dpsgd_r`` step of the dense decoder under
    an autotune plan (``LaunchPlan.as_dict``): its grad_accum chunks, remat
    policy and pipeline microbatches (the scorer's models take the default
    one a stage), ``auto`` resolved site by site at the chunk's shapes (a
    block's sites M times a pass, the head once).  Without kernels only
    the flash pair launches (``ops.flash_attention`` at every attention),
    and ``fused`` pass 1's attention backward is the plain one."""
    from repro_torch.core.algo import stage_microbatches
    from repro_torch.core.sites import resolve_strategy
    chunks, route = plan["grad_accum"], plan["norm_strategy"]
    chunk = B // chunks
    M = stage_microbatches(chunk, plan["pp_stages"]) if plan["pp_stages"] > 1 else 1
    kw = dict(chunks=chunks, remat=plan["remat"], microbatches=M)
    if not plan["use_kernels"]:
        n = path_launches("materialize", arch.n_layers, **kw)
        n.update(pegrad_norm=0, gram_norm=0)
        if route == "fused":
            n["flash_attn_bwd"] //= 2
        return n
    if route == "auto":
        picks = [resolve_strategy(k, "auto", ops, gy)
                 for k, ops, gy in norm_sites(arch, chunk // M, T)]
        blocks, head = picks[:-1], picks[-1:]
        kw["auto_norms"] = tuple(M * blocks.count(r) + head.count(r)
                                 for r in ("materialize", "gram"))
    return path_launches(route, arch.n_layers, **kw)


def autotune_launches(arch, measured, iters: int, B=TRAIN_B, T=TRAIN_T):
    """The launches a solve's measurement makes: each measured plan's
    ``plan_launches`` times its warm-up and ``iters`` timed steps
    (``autotune.measure_plan``); the search's fake-tensor traces launch
    nothing."""
    total = dict.fromkeys(read_counts(), 0)
    for rec in measured:
        for k, v in plan_launches(arch, rec["plan"], B, T).items():
            total[k] += (max(1, iters) + 1) * v
    return total


def check_kernel_records(costs, want) -> float:
    """The largest relative gap between the cost records' kernel FLOPs and
    ``want`` (``kernel_record_flops``); a kernel without launches has no
    record.  Raises above ``KERNEL_FLOPS_RTOL``."""
    got = {k: v["dot_flops"] for k, v in costs["kernels"].items()}
    assert set(got) == {k for k, v in want.items() if v}, (got, want)
    worst = max(abs(got[k] - want[k]) / want[k] for k in got)
    assert worst <= KERNEL_FLOPS_RTOL, (worst, got, want)
    return worst


def roofline_phase(train):
    """Phase 17 (a): the costs of phase 6's step (one fake-tensor trace on
    the card's device, taken in phase 6) and its roofline beside phase 6's
    measured step."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import roofline
    arch = dataclasses.replace(get_arch("phi3-mini-3.8b"), n_layers=TRAIN_LAYERS)
    costs, trace_s = train["costs"], train["costs_trace_s"]
    launches = path_launches("fused", TRAIN_LAYERS)
    gap = check_kernel_records(costs, kernel_record_flops(arch, TRAIN_LAYERS, TRAIN_B,
                                                         TRAIN_T, launches))
    step_s = sum(r["step_ms"] for r in train["steps"]) / len(train["steps"]) / 1e3
    shape = ShapeConfig("chip_smoke", TRAIN_T, TRAIN_B, "train")
    mf = roofline.model_flops(arch, shape, train["params"])
    terms = roofline.roofline_terms(costs["total_flops"], costs["total_bytes"], 0.0, 1)
    mfu = mf / (step_s * roofline.PEAK_FLOPS)
    dots = {k: f"{v / 1e12:.3f}" for k, v in costs["dot_flops_by_dtype"].items()}
    print(f"[roofline] phase 6's step (phi3-mini-3.8b, {TRAIN_LAYERS} layers, B {TRAIN_B} x "
          f"T {TRAIN_T}, dpsgd_r fused + kernels, remat none, bf16), one fake-tensor "
          f"trace of {trace_s:.1f} s: dot TFLOP by dtype {dots}, elementwise "
          f"{costs['elementwise_flops'] / 1e12:.4f} TFLOP, bytes {costs['total_bytes'] / 1e9:.2f} "
          f"GB (products {costs['dot_bytes'] / 1e9:.2f}, moves {costs['move_bytes'] / 1e9:.2f}), "
          f"{len(costs['gemms'])} distinct GEMMs; traced / model FLOPs (6·N·D, N "
          f"{train['params'] / 1e9:.3f}B) {costs['total_flops'] / mf:.3f}", flush=True)
    print(f"[roofline] H100 terms (bf16 {roofline.PEAK_FLOPS:.3g} FLOP/s, HBM "
          f"{roofline.HBM_BW:.3g} B/s): compute {1e3 * terms['compute_s']:.1f} ms, memory "
          f"{1e3 * terms['memory_s']:.1f} ms, collective {1e3 * terms['collective_s']:.1f} ms; "
          f"bottleneck {terms['bottleneck']}; phase 6's measured step {1e3 * step_s:.1f} ms: "
          f"mfu {mfu:.4f}, the traced compute term {terms['compute_s'] / step_s:.4f} of it, "
          f"the larger term {max(terms['compute_s'], terms['memory_s']) / step_s:.4f}; the "
          f"kernel records' FLOPs at most {gap:.1e} from this script's formulas x launches "
          f"{ {k: v['calls'] for k, v in costs['kernels'].items()} }", flush=True)
    return dict(trace_s=trace_s, costs={k: v for k, v in costs.items() if k != "gemms"},
                gemms=len(costs["gemms"]), model_flops=mf, terms=terms, step_s=step_s,
                mfu=mfu, compute_share=terms["compute_s"] / step_s, kernel_flops_gap=gap)


def _plan_text(p) -> str:
    return (f"accum {p['grad_accum']} remat {p['remat']} {p['norm_strategy']}"
            f"{'+kernels' if p['use_kernels'] else ''} pp {p['pp_stages']}"
            f"{' mb ' + str(p['microbatch']) if p['microbatch'] else ''}")


def autotune_phase():
    """Phase 17 (b): a solve on the card at phi3-mini's full width on
    ``TUNE_LAYERS`` layers; the winner no slower than the default, every
    measured peak within the planner's tolerance of its estimate, the
    traces no more than the evaluations."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import MemConfig, TuneConfig
    from repro_torch.launch import autotune, roofline
    from repro_torch.launch.memory import within_tolerance
    arch = dataclasses.replace(get_arch("phi3-mini-3.8b"), n_layers=TUNE_LAYERS)
    shape, cfg = train_shape_and_config(arch, "none")
    cfg = dataclasses.replace(
        cfg, mem=MemConfig(hbm_budget_bytes=TUNE_BUDGET),
        tune=TuneConfig(seed=0, method="ga", population=TUNE_POP,
                        generations=TUNE_GENS, topk=TUNE_TOPK,
                        measure_iters=TUNE_ITERS, include_kernels=True))
    scorer = autotune.PlanScorer(arch, cfg, shape, device="cuda")
    zero_counts()
    report = autotune.solve(arch, cfg, shape, mesh_shapes=[(1, 1)], scorer=scorer)
    launches = read_counts()
    print(f"[autotune] phi3-mini-3.8b at full width, {TUNE_LAYERS} layers, B {TRAIN_B} x "
          f"T {TRAIN_T}, dpsgd_r, AdamW, bf16, budget {TUNE_BUDGET / 2**30:.0f} GiB; "
          f"{report.method} (seed {report.seed}, population {TUNE_POP}, {TUNE_GENS} "
          f"generations): space {report.space_size}, {report.evals} evals, "
          f"{report.traces} traces, {report.cache_hits} cache hits; search "
          f"{report.search_s:.1f} s, measurement {report.measure_s:.1f} s", flush=True)
    rows = []
    for rec in report.measured:
        plan = autotune.LaunchPlan(**{**rec["plan"],
                                      "mesh_shape": tuple(rec["plan"]["mesh_shape"])})
        costs = scorer.costs_of(plan)
        terms = roofline.roofline_terms(costs["total_flops"], costs["total_bytes"], 0.0, 1)
        ratio = rec["pred_peak_bytes"] / rec["measured_peak_bytes"]
        rows.append(dict(rec, terms=terms, peak_ratio=ratio))
        print(f"[autotune] {_plan_text(rec['plan'])}: predicted "
              f"{1e3 * rec['pred_seconds']:.2f} ms, measured {1e3 * rec['seconds']:.1f} ms; "
              f"peak predicted {rec['pred_peak_bytes'] / 2**30:.2f} GiB, measured "
              f"{rec['measured_peak_bytes'] / 2**30:.2f} GiB ({ratio:.3f}); H100 terms "
              f"compute {1e3 * terms['compute_s']:.1f} ms, memory "
              f"{1e3 * terms['memory_s']:.1f} ms ({terms['bottleneck']})", flush=True)
        assert within_tolerance(ratio), (rec, ratio)
    by_plan = {json.dumps(r["plan"], sort_keys=True): r for r in rows}
    default = by_plan[json.dumps(report.default_plan.as_dict(), sort_keys=True)]
    winner = by_plan[json.dumps(report.plan.as_dict(), sort_keys=True)]
    assert winner["seconds"] <= default["seconds"], (winner, default)
    assert report.traces <= report.evals, report
    want = autotune_launches(arch, report.measured, TUNE_ITERS)
    assert launches == want, (launches, want)
    for k in ("flash_attn_fwd", "flash_attn_bwd", "dense_bwd_norm", "gram_norm"):
        assert launches[k] > 0, (k, launches)   # the default's route ran its kernels
    print(f"[autotune] winner {_plan_text(winner['plan'])} {1e3 * winner['seconds']:.1f} ms "
          f"against the default's {1e3 * default['seconds']:.1f} ms; Spearman of predicted "
          f"and measured over {len(rows)} plans: "
          f"{'none' if report.rank_correlation is None else f'{report.rank_correlation:.3f}'}"
          f"; launches "
          f"{launches}", flush=True)
    out = report.as_dict()
    out.update(measured=rows, launches=launches)
    del scorer
    gc.collect()
    torch.cuda.empty_cache()
    return out


TUNE_LINES = {
    "autotune": r"\[train\] autotune \((\w+), seed=(\d+)\): searched (\d+) plans, "
                r"(\d+) traces \((\d+) cache hits\); winner (LaunchPlan\(.*?pp_stages=\d+\))",
    "correlation": r"\[train\] autotune predicted-vs-measured rank correlation: "
                   r"(\S+) over (\d+) measured plans",
    "step": r"\[trainer\] step\s+(\d+) loss (\S+) ",
    "privacy": r"\[train\] finished at step (\d+); privacy spent: eps=(\S+) ",
}


def parse_autotune_launch(text: str) -> dict:
    """What the launcher printed under ``--autotune``: each pattern's
    matches in order."""
    import re
    return {k: re.findall(p, text) for k, p in TUNE_LINES.items()}


def launch_tune_cmd(ckpt_dir: str):
    """Phase 17 (c): the training launcher with ``--autotune`` at phi3-mini's
    full width on ``LAUNCH_TUNE_LAYERS`` layers, B 8 x T 512, two steps."""
    sets = ["dp.norm_strategy=fused", "dp.use_kernels=true", "tune.method=ga",
            f"tune.population={LAUNCH_TUNE_POP}",
            f"tune.generations={LAUNCH_TUNE_GENS}", f"tune.topk={LAUNCH_TUNE_TOPK}",
            f"tune.measure_iters={LAUNCH_TUNE_ITERS}", "tune.include_kernels=true",
            "log_every=1",
            f"ckpt_dir={ckpt_dir}"]
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch", "phi3-mini-3.8b",
            "--layers", str(LAUNCH_TUNE_LAYERS), "--batch", str(TRAIN_B), "--seq",
            str(TRAIN_T), "--steps", "2", "--autotune",
            *[x for kv in sets for x in ("--set", kv)]]


def start_launcher_autotune():
    """Phase 17 (c), started in the background (it runs beside phase 18's
    worlds, ``launcher_autotune`` waits for it): (the process, its start
    time, its checkpoint directory)."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_", dir=ROOT / "build")
    return (*start_launcher(launch_tune_cmd(tmp)), tmp)


def launcher_autotune(started):
    """Phase 17 (c): the launcher's ``--autotune`` on the card
    (``start_launcher_autotune``); its output to
    ``chiprun_out/chip_smoke_autotune.log``.  Its autotune line, two step
    lines and the ``privacy spent`` line must come; a nonzero exit or the
    time limit raises."""
    import shutil
    proc, t, tmp = started
    try:
        out, err = proc.communicate(timeout=LAUNCH_TUNE_TIMEOUT)
        secs = time.perf_counter() - t
        ckpt_bytes = dir_bytes(tmp)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    (ROOT / "chiprun_out" / "chip_smoke_autotune.log").write_text(
        out + "\n--- stderr\n" + err)
    if proc.returncode != 0:
        raise RuntimeError(f"the launcher's --autotune exited {proc.returncode}:\n"
                           f"{out[-3000:]}\n{err[-3000:]}")
    got = parse_autotune_launch(out)
    assert len(got["autotune"]) == 1 and len(got["step"]) == 2 \
        and len(got["privacy"]) == 1, got
    (method, seed, size, traces, hits, winner), = got["autotune"]
    print(f"[autotune] the launcher (phi3-mini-3.8b, {LAUNCH_TUNE_LAYERS} layers, B "
          f"{TRAIN_B} x T {TRAIN_T}, 2 steps, beside phase 18's worlds) in "
          f"{secs:.1f} s: {method} seed {seed}, "
          f"{size} plans, {traces} traces ({hits} cache hits); winner {winner}; "
          f"correlation {got['correlation']}; losses {[x[1] for x in got['step']]}; "
          f"eps {got['privacy'][0][1]}; its checkpoint {ckpt_bytes / 1e9:.2f} GB on "
          f"disk", flush=True)
    return dict(got, seconds=secs, ckpt_bytes=ckpt_bytes)


def launch_tools_path(train):
    """Phase 17: (a) ``roofline_phase``, (b) ``autotune_phase``, and (c)
    ``launcher_autotune`` started (``"started"``; the caller waits for it
    once phase 18, which runs beside it, is done)."""
    lap = stopwatch("phase 17")
    roof = roofline_phase(train)
    lap("(a) roofline")
    tune = autotune_phase()
    lap("(b) autotune")
    return dict(roofline=roof, autotune=tune, started=start_launcher_autotune(),
                launches=tune["launches"], seconds=dict(lap.secs))


class _Tee:
    """A text stream writing to every one of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()

    def isatty(self):
        return False

    def fileno(self):
        return self.streams[0].fileno()


def main(argv=None) -> int:
    import torch
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the "
              "card", file=sys.stderr)
        return 1
    if argv[:1] == ["--serve-tp-rank"]:       # phase 20 (b)'s ranks
        return serve_tp_rank(argv[1])
    if argv[:1] == ["--dryrun-cells"]:        # phase 20 (a)'s cells
        dryrun_cells(argv[1], int(argv[2]))
        return 0
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models.transformer import padded_vocab
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 references
    torch.backends.cudnn.allow_tf32 = False
    # every line also to chiprun_out/chip_smoke.log (the tail of stdout is
    # all a caller may get back)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    sys.stdout = _Tee(sys.stdout, open(ROOT / "chiprun_out" / "chip_smoke.log", "w"))

    # 1. device
    t_start = time.perf_counter()
    t_phase = [t_start]

    def lap(label):
        now = time.perf_counter()
        print(f"[time] {label}: {now - t_phase[0]:.1f} s", flush=True)
        t_phase[0] = now
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
        # a wide leaf, the stacked w1 of 16 layers at B 8 (phase 9 launched
        # on it before dpsgd took flat buffers; kept as the wide-N row whose
        # times earlier runs give); and a ragged width (the column loads)
        clip_recs.append(check_clip_reduce("phi3-w1-stack", TRAIN_B, L * d * f,
                                           dtype))
        clip_recs.append(check_clip_reduce("ragged", 3, 1_000_003, dtype))
        # a narrow leaf: the CNN head's bias over 256 examples
        clip_recs.append(check_clip_reduce("cnn-head-bias", IMAGE_B, 10, dtype))
    # phase 9's dpsgd launches: the flat buffers of its ALGO_LAYERS layers
    # (one a parameter dtype: the bf16 weights in bf16, the float32 norm
    # scales in float32), the whole batch at once and one example at a time
    for dtype, _, n_pad in flat_groups(dataclasses.replace(arch,
                                                           n_layers=ALGO_LAYERS))[0]:
        for mb in DPSGD_MICROBATCHES:
            gc.collect()
            torch.cuda.empty_cache()
            tag = "" if dtype == torch.bfloat16 else "-f32"
            clip_recs.append(check_clip_reduce(f"phi3-flat{tag}-b{mb}", mb, n_pad,
                                               dtype))
    gc.collect()
    torch.cuda.empty_cache()

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

    lap("phases 1-3")
    # 4. small references
    small_reference("cuda")
    train_reference()
    for image_arch in IMAGE_ARCHS:
        train_reference(image_arch, augmult=2)

    lap("phase 4")
    # 5. the serving path
    print(f"[main] allocated before the serving path: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    runs, serve_launches, breakdown, serve_out, busy = main_path(arch, prompts)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] allocated before the training path: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)

    lap("phase 5")
    # 6. the training path
    train, model, fused_trainer, state = train_main_path()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[route] allocated before the norm-route path (phase 6's model and "
          f"AdamW state): {torch.cuda.memory_allocated() / 2**30:.3f} GiB",
          flush=True)

    lap("phase 6")
    # 7. the per-site norm rules and Poisson batches, on phase 6's state
    routes = train_norm_routes(model, fused_trainer, state)
    del model, fused_trainer, state
    gc.collect()
    torch.cuda.empty_cache()

    lap("phase 7")
    # 8. remat at 16 layers and phi3-mini at full depth
    remat = train_remat()
    gc.collect()
    torch.cuda.empty_cache()

    lap("phase 8")
    # 9. the paper's comparison: sgd, dpsgd_r, dpsgd_r1f, dpsgd
    algos = train_algorithms()
    gc.collect()
    torch.cuda.empty_cache()

    lap("phase 9")
    # 10. chatglm3-6b at full width and depth from a memmap corpus, adam8bit;
    # the checkpoint drill
    glm = train_glm_path()
    gc.collect()
    torch.cuda.empty_cache()

    lap("phase 10")
    # 11. the image families at full width and depth: augmult 16, adaptive clip
    images = train_images()
    gc.collect()
    torch.cuda.empty_cache()

    lap("phase 11")
    # 12. the memory planner and the host loop
    planner = memory_planner_and_host_loop(prompts, serve_out, runs)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 12")
    # 13. the MoE family: its kernel shapes, deepseek-moe-16b served and
    # trained at full width on cuts of its layers, grok-1-314b served at 2
    moe = moe_path()
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 13")
    # 14. the SSM family: its kernel shapes, mamba2-1.3b served and trained at
    # full width on cuts of its layers, jamba's two-layer cut served and its
    # passes
    ssm = ssm_path()
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 14")
    # 15. the embedding-input models: their kernel shapes, musicgen-medium
    # served and trained at full width on cuts of its layers, chameleon-34b
    # served at full depth and trained at full width on a cut of its layers
    embed = embed_path()
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 15")
    # 16. distribution: (a) the pipeline schedule in one process; (b)-(c)
    # the launcher in a world of 1 (NCCL) and of 2 ranks sharing the card
    # (gloo), which run beside phase 19's worlds
    pipe = pipeline_ab()
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 16 (a) pipeline")
    # 17. the launch tools: phase 6's roofline, a solve on the card, the
    # launcher's --autotune (which runs beside phase 18's worlds)
    tools = launch_tools_path(train)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 17 (a)-(b)")
    # 20 (a): phi3-mini's dry-run cells, traced on the host beside phases
    # 17 (c), 18, 19 and 16 (b)-(c), whose gates read no time
    dry_out = ROOT / "chiprun_out" / "dryrun_torch"
    dry = start_dryrun(dry_out)
    try:
        # 18. FSDP: chameleon-34b through the launcher in a world of 1
        # (NCCL) and of 2 ranks sharing the card (gloo), each holding half
        # its params
        try:
            fsdp = fsdp_path()
        except BaseException:           # stop phase 17 (c) before leaving
            tools["started"][0].kill()
            tools["started"][0].communicate()
            raise
        tools["launcher"] = launcher_autotune(tools.pop("started"))
        gc.collect()
        torch.cuda.empty_cache()
        lap("phases 17 (c) and 18")
        # 19. the model and stage axes: the kernels at a model rank's
        # shapes, then phi3-mini through the launcher in a world of 1
        # (NCCL), of 2 model ranks sharing the card (gloo), each holding
        # half of its heads, FFN and vocabulary, and of 2 stage ranks
        # (gloo), each holding one layer's blocks, beside phase 16
        # (b)-(c)'s worlds
        tp_kernels = tp_kernel_checks()
        lap("phase 19 kernels")
        dist_worlds = start_worlds(_worlds(dist_cmd), "dist")
        try:
            tp = tp_path(tp_kernels)
        except BaseException:           # stop phase 16's worlds before leaving
            stop_worlds(dist_worlds)
            raise
        dist = dist_path(pipe, dist_worlds)
        lap("phases 16 (b)-(c) and 19")
        dry_rec = dryrun_path(dry, dry_out)
    finally:
        stop_dryrun(dry)
    lap("phase 20 (a)")
    # 20 (b): prefill and decode on two model ranks against a world of one
    serve_tp = serve_tp_path(dry_out)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 20 (b)")
    ckpts = {**{f"16 ({'b' if k == 1 else 'c'})": w["ckpt_bytes"]
                for k, w in dist["worlds"].items()},
             "17 (c)": tools["launcher"]["ckpt_bytes"],
             **{f"18 world {k}": w["ckpt_bytes"] for k, w in fsdp["worlds"].items()},
             **{f"19 world {k}": w["ckpt_bytes"] for k, w in tp["worlds"].items()}}
    print(f"[disk] the launchers' checkpoints, written and removed: "
          f"{ {k: round(v / 1e9, 2) for k, v in ckpts.items()} } GB, "
          f"{sum(ckpts.values()) / 1e9:.2f} GB in all", flush=True)
    launches = {k: sum(r["launches"][k] for r in (train, routes, remat, algos, glm,
                                                  images, moe, ssm, embed, dist, tools))
                for k in train["launches"]}
    for world in [*fsdp["worlds"].values(), *tp["worlds"].values()]:
        for got, _, _ in world["launches"]:       # every rank's steps
            for k, v in json.loads(got).items():
                launches[k] += v
    launches["flash_attn_fwd"] += serve_launches + serve_tp["launches"]

    flash_rec = pick(kernel_recs, "phi3-wave")
    bwd_rec, gram_rec = pick(bwd_recs, "phi3-train"), pick(gram_recs, "embed")
    clip_rec = pick(clip_recs, f"phi3-flat-b{TRAIN_B}")
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
                                       "bound_by", "library_ms")},
                **{k: rec[k] for k in ("device_ms", "library_device_ms") if k in rec}}

    vit_shape = (f"({IMAGE_B * IMAGE_K} x 8 heads, T 64, hd 32) non-causal, bf16")
    image_rows = {
        "flash_attn_fwd": dict(cnn=None, vit=dict(image_row(
            "flash_attn_fwd", "vit-cifar10", ik["flash_fwd"][1]), shape=vit_shape)),
        "flash_attn_bwd": dict(cnn=None, vit=dict(image_row(
            "flash_attn_bwd", "vit-cifar10", ik["flash_bwd"][1]), shape=vit_shape)),
        "clip_reduce": {m.split("-")[0]: image_row("clip_reduce", m,
                                                    ik["clip_reduce"][m]["flat"]["bfloat16"])
                        for m in IMAGE_ARCHS}}
    for kernel in ("dense_bwd_norm", "pegrad_norm", "dense_dgrad", "gram_norm"):
        image_rows[kernel] = {m.split("-")[0]: image_row(kernel, m)
                              for m in IMAGE_ARCHS}
    # phase 13's shapes (bf16) and launches on the deepseek training path
    for kernel, recs in moe["kernels"].items():
        image_rows[kernel]["moe"] = dict(
            launches=moe["train"]["launches"][kernel],
            shapes=[{k: r.get(k) for k in (
                "shape", "BG", "BH", "T", "di", "do", "E", "hd", "rep", "max_abs_err",
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "path",
                "norm_path")} for r in recs if r["dtype"] == "bfloat16"])

    # phase 14's and phase 15's shapes (bf16) and launches on their paths
    for key, rec in (("ssm", ssm), ("embed", embed)):
        for kernel, recs in rec["kernels"].items():
            image_rows[kernel][key] = dict(
                launches=rec["launches"][kernel],
                shapes=[{k: r.get(k) for k in (
                    "shape", "BG", "BH", "T", "di", "do", "E", "hd", "max_abs_err", "ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms", "path",
                    "norm_path")} for r in recs])

    # phase 19's local shapes (bf16) and launches on a model rank's path
    tpk = tp["kernels"]
    tp_recs = {"dense_bwd_norm": tpk["dense"], "flash_attn_fwd": [tpk["flash_fwd"]],
               "flash_attn_bwd": [tpk["flash_bwd"]],
               "gram_norm": [pick(gram_recs, "embed")]}
    for kernel, recs in tp_recs.items():
        image_rows[kernel]["tp"] = dict(
            launches=sum(json.loads(got)[kernel] for got, _, _ in
                         tp["worlds"][2]["launches"]),
            shapes=[{k: r.get(k) for k in (
                "shape", "BG", "BH", "T", "di", "do", "hd", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms", "path",
                "norm_path")} for r in recs])

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
                               f"T {TRAIN_T}, hd 128) causal"),
              serve_tp=dict(launches=serve_tp["launches"], shapes=[
                  {k: rec[k] for k in ("shape", "dtype", "BH", "T", "hd", "max_abs_err",
                                       "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "path")}
                  for rec in serve_tp["kernels"].values()])),
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
              shape=f"({TRAIN_B}, {clip_rec['N']}) bf16, the flat buffer of "
                    f"{L} layers' per-example weight gradients",
              launched_on="dpsgd's clipped sums (phase 9)",
              device_ms=clip_rec["device_ms"],
              library_device_ms=clip_rec["library_device_ms"]),
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
         "decode_breakdown_ms": breakdown, "decode_busy": busy,
         "planner": planner, "train": train, "routes": routes,
         "remat": remat, "algos": algos, "glm": glm, "image_kernels": image_kernels,
         "images": images, "moe": moe, "ssm": ssm, "embed": embed, "dist": dist,
         "tools": tools, "fsdp": fsdp, "tp": tp, "dryrun": dry_rec,
         "serve_tp": serve_tp, "json_line": kernels},
        indent=1, default=str))
    print(f"[time] chip_smoke.py: {time.perf_counter() - t_start:.1f} s from the device "
          f"query to the last check", flush=True)
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
