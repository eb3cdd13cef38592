"""Training launcher of the port: one process, one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --reduced --steps 3 --device cpu --dtype float32 \
        --set dp.norm_strategy=fused --set dp.use_kernels=true

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --reduced --steps 3 --device cpu --dtype float32 \
        --set dp.sampling=poisson --set dp.norm_strategy=materialize \
        --set dp.use_kernels=true

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --reduced --steps 3 --device cpu --dtype float32 --set remat=sites \
        --set dp.algo=dpsgd --set dp.microbatch=2 --set dp.use_kernels=true

    PYTHONPATH=src python -m repro_torch.launch.train --arch vit-cifar10 \
        --reduced --device cpu --dtype float32 --set dp.augmult=4 \
        --set dp.adaptive_clip=true

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --reduced --steps 6 --device cpu --dtype float32 \
        --set ckpt_dir=/path/to/ckpts --set ckpt_every=3 \
        --set data_source=memmap:/path/to/tokens.bin --set optim.name=adam8bit

The JAX launcher's flags ``--arch``, ``--reduced``, ``--steps``, ``--batch``,
``--seq`` and ``--set`` (``--set shape=...`` picks the input shape), plus
``--device`` (default ``cuda``) and ``--dtype`` as in ``launch/serve.py``.
``--dtype`` sets ``param_dtype`` and ``compute_dtype`` before the ``--set``
overrides (default: the config's, ``bfloat16``); ``--set param_dtype=float32
--set compute_dtype=bfloat16`` holds float32 weights and computes in bf16.
A run resumes from the latest checkpoint in ``ckpt_dir`` (``[trainer]
restored step N``), else starts from a seeded random init, and saves every
``ckpt_every`` steps, at its last and on SIGTERM/SIGINT.  ``data_source=
memmap:<path>`` reads windows of a flat int32 token file.  Under
``dp.sampling=poisson`` each step's line gives its realized batch and the
padded capacity.
"""
from __future__ import annotations

import argparse
from dataclasses import replace

import torch

from repro_torch.configs import (IMAGE_FAMILIES, SHAPES, ShapeConfig,
                                 TrainConfig, apply_overrides, get_arch,
                                 parse_set_args, reduced)
from repro_torch.models import build_model_for
from repro_torch.train import Trainer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU smoke scale)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--set", action="append", default=[],
                    help="config overrides, e.g. --set dp.clip_norm=0.5")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None)
    args = ap.parse_args(argv)

    cfg = TrainConfig()
    if args.dtype:
        cfg = replace(cfg, param_dtype=args.dtype, compute_dtype=args.dtype)
    cfg = apply_overrides(cfg, parse_set_args(args.set))
    for key in ("param_dtype", "compute_dtype"):
        if getattr(cfg, key) not in DTYPES:
            raise ValueError(f"{key}={getattr(cfg, key)!r}; the launcher "
                             f"takes {sorted(DTYPES)}")
    if args.steps is not None:
        cfg = replace(cfg, steps=args.steps,
                      optim=replace(cfg.optim, total_steps=args.steps))
    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)
    shape = SHAPES[cfg.shape]
    if args.batch or args.seq or args.reduced:
        shape = ShapeConfig(shape.name,
                            args.seq or (64 if args.reduced else shape.seq_len),
                            args.batch or (8 if args.reduced else
                                           shape.global_batch),
                            shape.kind)
    cfg = replace(cfg, arch=arch.name)

    model = build_model_for(arch, dtype=DTYPES[cfg.compute_dtype],
                            param_dtype=DTYPES[cfg.param_dtype],
                            device=args.device, seed=cfg.seed, remat=cfg.remat)
    trainer = Trainer(model, cfg, shape)
    if arch.family in IMAGE_FAMILIES:
        rows = (f"{shape.global_batch} images {arch.image_shape()} x "
                f"{cfg.dp.augmult} views")
    else:
        rows = f"{shape.global_batch} x {shape.seq_len}"
    print(f"[train] {arch.name}: {sum(p.numel() for p in model.parameters())} "
          f"params {cfg.param_dtype} (compute {cfg.compute_dtype}) on "
          f"{model.device}; data {cfg.data_source}; batch {rows}; remat "
          f"{cfg.remat}; dp {cfg.dp.algo} norm_strategy={cfg.dp.norm_strategy} "
          f"use_kernels={cfg.dp.use_kernels} adaptive_clip="
          f"{trainer.adaptive_clip}", flush=True)
    if trainer.sampling == "poisson":
        print(f"[train] poisson sampling: q = {trainer.sample_rate:.3e}, "
              f"expected batch {shape.global_batch}, capacity "
              f"{trainer.capacity} rows", flush=True)
    state = trainer.run(trainer.restore_or_init())
    eps = trainer.accountant.epsilon_at(state.step)
    split = ""
    if trainer.adaptive_clip:
        bd = trainer.accountant.epsilon_breakdown(state.step)
        split = (f" = composed grad {bd['eps_grad']:.3f} and clip "
                 f"{bd['eps_clip']:.3f}; clip_norm "
                 f"{float(trainer.clip_norm(state)):.4f}")
    print(f"[train] finished at step {state.step}; privacy spent: "
          f"eps={eps:.3f}{split} (delta={cfg.dp.delta}, "
          f"q={trainer.sample_rate:.2e})")


if __name__ == "__main__":
    main()
