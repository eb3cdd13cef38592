#!/usr/bin/env python3
"""One side of an A/B of vanilla DP-SGD's clipped sum on one NVIDIA card:
``clip_reduce`` alone at the image and decoder shapes, and one ``dpsgd``
step of each image model at ``chip_smoke.py`` phase 11's shape, from the
port (``src/repro_torch``) of the checkout given by ``--src``.

    python3 tools/dpsgd_ab.py --label change
    python3 tools/dpsgd_ab.py --src <a parent checkout>/src --label parent

Run both sides in one call on one card, in turns (parent, change, change,
parent), one process each: a process imports one tree's port.  It uses
``chip_smoke.py``'s helpers from this checkout, calling only what both
trees' ports have (``clip_reduce(g, c)``, the Trainer), so an older tree
runs unchanged.

Per side it prints one ``[ab]`` line a measurement and, as its last line,
one JSON record (also written to ``--out`` when given):
- ``clip_reduce(g, c)`` (a fresh float32 sum) at B 256 x the ViT's w2
  (262,144), the CNN's stage-2 conv (36,864) and the CNN's flat buffer
  (272,288), and 8 x phi3-mini's w1 stacked over 16 layers (402,653,184),
  bf16: device time (``torch.profiler``) beside ``torch.matmul``'s and the
  bytes bound;
- each image model (bf16, seeded weights, 256 examples x 16 views,
  adaptive clipping, remat block, ``dp.algo="dpsgd"`` with the whole batch
  at once): a warm-up step, a timed step with its peak memory and its
  ``clip_reduce`` launches, and a step under ``torch.profiler`` with
  ``clip_reduce``'s device time summed over it.
Imports nothing of JAX or of the JAX package.  Needs one card.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [("vit-w2", 256, 262144), ("cnn-s2w2", 256, 36864),
          ("cnn-flat", 256, 272288), ("phi3-w1-stack", 8, 16 * 3072 * 8192)]


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_times(smoke):
    import torch
    from repro_torch.kernels import clip_reduce
    out = []
    for name, B, N in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        grads = torch.randn((B, N), generator=g, device="cuda").to(torch.bfloat16)
        c = torch.rand((B,), generator=g, device="cuda")
        cg = c.to(torch.bfloat16)
        ms = smoke.device_ms(lambda: clip_reduce.clip_reduce(grads, c),
                             label=f"clip_reduce {name}")
        mm = smoke.device_ms(lambda: torch.matmul(cg, grads), label=f"matmul {name}")
        assert ms is not None and mm is not None, f"{name}: no device time recorded"
        bound, _ = smoke.clip_bound_ms(B, N, 2)
        rec = dict(shape=name, B=B, N=N, ms=ms, matmul_ms=mm, bound_ms=bound)
        print(f"[ab] clip_reduce {name} (B {B} x N {N}) bf16: {ms:.4f} ms, matmul "
              f"{mm:.4f} ms, bound {bound:.4f} ms ({100 * bound / ms:.1f}%)", flush=True)
        out.append(rec)
        del grads
        torch.cuda.empty_cache()
    return out


def dpsgd_step(smoke, name):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model_for
    arch = get_arch(name)
    shape, cfg = smoke.image_shape_and_config(arch, algo="dpsgd", microbatch=0)
    model = build_model_for(arch, dtype=torch.bfloat16, device="cuda", seed=0,
                            remat="block")
    trainer = smoke.image_trainer(model, shape, cfg)
    state = trainer.init_state()
    smoke.timed_step(trainer, state)                      # warm-up
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    smoke.zero_counts()
    rec = smoke.timed_step(trainer, state)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["launches"] = smoke.read_counts()["clip_reduce"]
    rec["profile"] = smoke.kernel_device_ms(lambda: smoke.timed_step(trainer, state),
                                            "clip_reduce")
    p = rec["profile"]
    print(f"[ab] {name} dpsgd step: {rec['step_ms']:.1f} ms, peak "
          f"{rec['peak_bytes'] / 2**30:.3f} GiB, {rec['launches']} clip_reduce "
          f"launches; profiled step: clip_reduce {p['ms']:.4f} ms of device time in "
          f"{p['launches']} launches, step {p['step_ms']:.1f} ms", flush=True)
    del trainer, state, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch to measure")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", help="a file to write the JSON record to")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dpsgd_ab: no CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    sys.path.insert(0, str(Path(args.src).resolve()))    # ahead of chip_smoke's
    import repro_torch
    assert Path(repro_torch.__file__).resolve().is_relative_to(Path(args.src).resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(f"[ab] {args.label}: {repro_torch.__file__}; {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = dict(label=args.label, src=str(args.src), device=smi,
               kernels=kernel_times(smoke),
               dpsgd={n: dpsgd_step(smoke, n) for n in smoke.IMAGE_ARCHS})
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1, default=str))
    print(json.dumps(rec, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
