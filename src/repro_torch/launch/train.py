"""Training launcher of the port: one process, or one process a device of
a data-parallel world.

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
        --reduced --steps 2 --device cpu --dtype float32 --set dp.algo=dpsgd \
        --set mem.hbm_budget_bytes=6000000 --set mem.auto_microbatch=true

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --reduced --steps 2 --device cpu --dtype float32 --autotune \
        --set dp.norm_strategy=fused --set tune.method=ga \
        --set tune.population=4 --set tune.generations=2 --set tune.topk=2

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --reduced --steps 6 --device cpu --dtype float32 \
        --set ckpt_dir=/path/to/ckpts --set ckpt_every=3 \
        --set data_source=memmap:/path/to/tokens.bin --set optim.name=adam8bit

    # tensor parallel: phi3-mini at full width on two model ranks:
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc_per_node 2 -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --layers 2 --steps 2 --mesh 1,2 --axes data,model

    # pipeline stages: phi3-mini at full width on two stage ranks:
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc_per_node 2 -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --layers 2 --steps 2 --mesh 1,2 --axes data,stage --set pp_stages=2

    # FSDP: a use_fsdp arch at full width on two ranks (a card each):
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc_per_node 2 -m repro_torch.launch.train --arch chameleon-34b \
        --layers 1 --steps 2 --mesh 2 --axes data --set zero1=true

    # data parallel, two processes (one a card, or both on the CPU):
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc_per_node 2 -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --reduced --steps 3 --device cpu --dtype float32 --mesh 2 --axes data \
        --set zero1=true --set compress_pod_grads=true --set pp_stages=2

The JAX launcher's flags ``--arch``, ``--reduced``, ``--steps``, ``--batch``,
``--seq``, ``--set``, ``--mesh``/``--axes``, ``--autotune`` and
``--coordinator``/``--num-processes``/``--process-id`` (``--set
shape=...`` picks the input shape), plus ``--device`` (default ``cuda``) and ``--dtype`` as in
``launch/serve.py``, and ``--layers`` (the arch cut to its first N layers
at full width, for a run on one card).
``--dtype`` sets ``param_dtype`` and ``compute_dtype`` before the ``--set``
overrides (default: the config's, ``bfloat16``); ``--set param_dtype=float32
--set compute_dtype=bfloat16`` holds float32 weights and computes in bf16.
A run resumes from the latest checkpoint in ``ckpt_dir`` (``[trainer]
restored step N``), else starts from a seeded random init, and saves every
``ckpt_every`` steps, at its last and on SIGTERM/SIGINT.  ``data_source=
memmap:<path>`` reads windows of a flat int32 token file.  Under
``dp.sampling=poisson`` each step's line gives its realized batch and the
padded capacity.

Distribution.  Under ``torch.distributed.run`` (its ``RANK``/
``WORLD_SIZE``/``LOCAL_RANK`` environment) or with ``--coordinator``
(``tcp://`` address), ``--num-processes`` and ``--process-id``, the
launcher joins the process group; with ``--mesh`` alone it makes a group of
one.  Rank r runs on ``cuda:LOCAL_RANK % device_count`` (or the CPU under
``--device cpu``).  The backend follows from that, and the first line
prints it: ``nccl`` when each rank has a card of its own, ``gloo`` when
ranks share a card (NCCL refuses two ranks on one device) or run on the
CPU.  The mesh is ``--mesh``/``--axes``, else the ``mesh.*`` keys when one
is set, else one ``data`` axis over a world of more than one process.  The
batch shards over its batch axes (``dist.sharding.batch_pspec``): each rank
trains on its slice, the clipped sum is all-reduced before the noise and
every rank adds the same noise, so the run has the DP-SGD semantics of one
process on the global batch.  A fresh run prints the init fingerprint that
every process agreed on.  A ``use_fsdp`` arch (chameleon-34b, grok-1-314b,
jamba-1.5-large-398b) on a ``data`` axis above 1 is built FSDP-sharded:
each rank draws and holds its slice of every param ``param_shardings``
places on ``data``, gathers each layer's whole params just before the
layer runs, and its pass-2 gradients are summed over the ranks and cut
back to its slices (dist/runtime.py); the init fingerprint then records a
slice's whole shape and no bytes.  A ``model`` axis above 1 trains the
dense decoders tensor-parallel (``--mesh 1,2 --axes data,model``, or
``2,2`` with ZeRO-1 over ``data``): each rank holds its slices of the
heads, FFN and vocabulary (``models/transformer.py``), every model rank of
a ``data`` coordinate takes the same examples, and the norms² are summed
over the ``model`` group before the clip.  A ``stage`` axis of width W
above 1 runs the pipeline stages across processes (``--mesh 1,2 --axes
data,stage --set pp_stages=2``, or ``2,2`` with ZeRO-1 over ``data``):
``pp_stages`` must be a multiple of W, stage rank w holds the blocks of
stages [w·S/W, (w+1)·S/W) and the whole of the embedding, prelude, final
norm and head (models/transformer.py), each microbatch's activations,
norm accumulator and aux total cross the ranks point to point (over gloo),
and the norms² are summed over the ``stage`` group before the clip.  Not
ported, and refused by name (ROADMAP queue 1): on a ``model`` axis,
``use_fsdp``, MoE, Mamba, image and ``qk_norm`` archs, KV heads the axis
does not divide, ``pp_stages`` > 1, ``dp.algo=dpsgd`` and ``--autotune``;
on a ``stage`` axis, a width that does not divide ``pp_stages``, a
``model`` axis beside it, ``use_fsdp``, Mamba and image archs,
``dp.algo=dpsgd``, ``--autotune`` and NCCL; and with FSDP, model or stage
slices ``compress_pod_grads`` and ``adam8bit``, whose int8 blocks span the
flattened whole leaf.

``--autotune`` solves for the fastest feasible launch plan first
(``launch/autotune.py``; ``--set tune.*`` sets the search): it searches the
plan space on fake-tensor traces of the step, measures the top plans and
the default on the run's device, prints the method, seed, space size,
traces, cache hits and winner, then the predicted-against-measured rank
correlation, and trains with the winner.  On the card the measured plans
launch their kernels there; one that cannot build or launch raises.  In a
world of more than one process rank 0 solves and broadcasts its winner,
and every rank prints the plan it trains with.

Every launch prints the estimated peak of one step (``launch/memory.py``)
before the run, and, on a mesh, the per-device share of it over the batch
axes (``per_device_peak_bytes``; the estimate traces the rank's own model
and stage slices), with a warning when that
exceeds ``mem.hbm_budget_bytes``; under ``mem.auto_microbatch`` with a
budget the Trainer first picks the largest microbatch that fits
(``[trainer] auto_microbatch: grad_accum a -> b``).  With
``mem.compiled_check`` (the default) on a CUDA device the run's measured
peak (``torch.cuda.max_memory_allocated`` over its steps) is printed beside
the estimate after it.  Each rank then prints its resident param and
optimizer-state bytes before the run, and after it the kernel launches
of its steps and the bytes its collectives moved (each result's size on
one rank, by kind, over the steps and a step).
"""
from __future__ import annotations

import argparse
import datetime
import gc
import json
import os
from dataclasses import replace

import torch
import torch.distributed as dist

from repro_torch import kernels, tree
from repro_torch.configs import (IMAGE_FAMILIES, SHAPES, ShapeConfig,
                                 TrainConfig, apply_overrides, get_arch,
                                 parse_set_args, reduced)
from repro_torch.dist import runtime, sharding
from repro_torch.models import build_model_for
from repro_torch.models.transformer import stage_refusal, tp_refusal
from repro_torch.train import Trainer
from repro_torch.train.trainer import fsdp_refusal

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# a collective that a rank never reaches fails the run after this long
GROUP_TIMEOUT = datetime.timedelta(seconds=300)
# ranks above 0 wait this long for rank 0's autotune solve
SOLVE_TIMEOUT = datetime.timedelta(seconds=3600)


def join_world(args, mesh_keys: bool = False):
    """Join the process group the arguments or ``torch.distributed.run``'s
    environment describe, on the backend the devices call for.  Returns
    (device, backend or None, rank, world); one process without ``--mesh``
    or a ``mesh.*`` key (``mesh_keys``) joins nothing."""
    env = os.environ
    if args.coordinator:
        rank, world = args.process_id, args.num_processes
        local, local_world = rank, world
        init = f"tcp://{args.coordinator}"
    elif "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        init = "env://"
    elif args.mesh or mesh_keys:
        rank, world, local, local_world = 0, 1, 0, 1
        init = None
    else:
        return args.device, None, 0, 1
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("repro_torch: no CUDA device available; pass "
                               "--device cpu to run the plain PyTorch path")
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    # NCCL refuses two ranks on one device: ranks sharing a card take gloo
    shared = local_world > torch.cuda.device_count() if device.type == "cuda" else True
    backend = "gloo" if shared else "nccl"
    if init is None:                  # --mesh in one process: a group of one
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=GROUP_TIMEOUT)
        return device, backend, 0, 1
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)
    return device, backend, rank, world


def make_run_mesh(args, cfg, mesh_keys: bool, world: int):
    """The run's mesh: ``--mesh``/``--axes``, else ``cfg.mesh`` when a
    ``mesh.*`` key was set, else one data axis over a world of more than
    one process (None in one process)."""
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    if args.mesh:
        return make_mesh([int(x) for x in args.mesh.split(",")],
                         args.axes.split(","))
    if mesh_keys:
        return sharding.mesh_from_config(cfg.mesh)
    return make_host_mesh() if world > 1 else None


def unported_mesh_reason(arch, sizes: dict, cfg=None,
                         autotune: bool = False) -> str:
    """Why the port cannot run ``arch`` on a mesh of these axis sizes
    (``{"model": 1, "data": 2}``; an absent axis is 1) under the training
    config ``cfg`` (and ``--autotune``), naming ROADMAP; "" when it can.
    The launch autotuner gives it as a plan's reason (``autotune``: its
    measurement runs in one process, so a ``model`` or ``stage`` axis above
    1 is refused there)."""
    size = sizes.get(sharding.STAGE_AXIS, 1)
    width = sizes.get(sharding.MODEL_AXIS, 1)
    if size > 1:
        if autotune:
            return (f"a {size}-wide 'stage' mesh axis (pipeline stages across "
                    f"processes) is not ported under --autotune: its "
                    f"measurement runs in one process (ROADMAP queue 1)")
        reason = stage_refusal(arch, size, 1 if cfg is None else cfg.pp_stages,
                               width)
        if reason:
            return reason
        if cfg is not None and cfg.dp.enabled and cfg.dp.algo == "dpsgd":
            return (f"{arch.name} on a {size}-wide 'stage' axis (pipeline "
                    f"stages across processes): dp.algo='dpsgd' not ported "
                    f"(ROADMAP queue 1)")
    if width > 1:
        if autotune:
            return (f"a {width}-wide 'model' mesh axis (tensor parallelism) is "
                    f"not ported under --autotune: its measurement runs in one "
                    f"process (ROADMAP queue 1)")
        reason = tp_refusal(arch, width, 1 if cfg is None else cfg.pp_stages)
        if reason:
            return reason
        if cfg is not None and cfg.dp.enabled and cfg.dp.algo == "dpsgd":
            return (f"{arch.name} on a {width}-wide 'model' axis (tensor "
                    f"parallelism): dp.algo='dpsgd' not ported (ROADMAP "
                    f"queue 1)")
    if cfg is not None and (width > 1 or size > 1
                            or arch.use_fsdp and sizes.get("data", 1) > 1):
        reason = fsdp_refusal(cfg)
        if reason:
            how = ("tensor parallel" if width > 1 else
                   "pipeline stages" if size > 1 else "use_fsdp")
            return f"{arch.name} ({how}): {reason}"
    return ""


def refuse_unported(mesh, arch, cfg=None, autotune: bool = False) -> None:
    """Raise, naming ROADMAP, on a mesh the port does not run."""
    reason = unported_mesh_reason(arch, {
        a: sharding._axis_size(mesh, a)
        for a in (sharding.MODEL_AXIS, sharding.STAGE_AXIS, "data")}, cfg,
        autotune)
    if reason:
        raise NotImplementedError(reason)


def autotune_plan(arch, cfg, shape, mesh, device, rank: int, world: int):
    """The launch plan every rank trains with.  Rank 0 solves (searches,
    then measures the top plans and the default in its own process, on the
    global batch) and prints the reference's two lines; in a world of more
    than one process it broadcasts its winner, so the replicas never train
    with different plans (one with the compression rider, one without).
    The other ranks wait for it on a gloo group of ``SOLVE_TIMEOUT``:
    the solve outlasts the run's ``GROUP_TIMEOUT``."""
    from repro_torch.launch.autotune import solve
    group = (dist.new_group(backend="gloo", timeout=SOLVE_TIMEOUT)
             if world > 1 else None)
    plan = None
    if rank == 0:
        mesh_shape = ((1, 1) if mesh is None else
                      (sharding.batch_axis_width(mesh),
                       sharding._axis_size(mesh, sharding.MODEL_AXIS)))
        report = solve(arch, cfg, shape, mesh_shapes=[mesh_shape],
                       device=device)
        plan = report.plan
        print(f"[train] autotune ({report.method}, seed={report.seed}): "
              f"searched {report.space_size} plans, {report.traces} traces "
              f"({report.cache_hits} cache hits); winner {plan}", flush=True)
        if report.rank_correlation is not None:
            print(f"[train] autotune predicted-vs-measured rank "
                  f"correlation: {report.rank_correlation:.3f} over "
                  f"{len(report.measured)} measured plans", flush=True)
        del report
        gc.collect()                  # the solve's models and their cache
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    if group is not None:
        box = [plan]
        dist.broadcast_object_list(box, src=0, group=group)
        plan = box[0]
        print(f"[train] rank {rank} of {world} trains the autotune winner "
              f"{plan}", flush=True)
        dist.destroy_process_group(group)
    return plan


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
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch to its first N layers (full width)")
    ap.add_argument("--mesh", default=None, help="e.g. 2 or 2,1")
    ap.add_argument("--axes", default="data,model")
    ap.add_argument("--coordinator", default=None, help="host:port of rank 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--autotune", action="store_true",
                    help="solve for the fastest feasible launch plan "
                         "(launch/autotune.py) before launching; knobs via "
                         "--set tune.seed=... etc.")
    args = ap.parse_args(argv)
    device, backend, rank, world = join_world(
        args, any(p.startswith("mesh.") for p in args.set))
    try:
        _train(args, device, backend, rank, world)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args, device, backend, rank, world) -> None:
    print(f"[train] backend {backend or 'none (one process)'}: rank {rank} of "
          f"{world} on {device}", flush=True)

    cfg = TrainConfig()
    if args.dtype:
        cfg = replace(cfg, param_dtype=args.dtype, compute_dtype=args.dtype)
    sets = parse_set_args(args.set)
    # moe.* keys override the arch's MoEConfig, the rest the TrainConfig
    arch_sets = {k: v for k, v in sets.items() if k.startswith("moe.")}
    cfg = apply_overrides(cfg, {k: v for k, v in sets.items()
                                if k not in arch_sets})
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
    if args.layers:
        arch = replace(arch, n_layers=args.layers)
    arch = apply_overrides(arch, arch_sets)
    shape = SHAPES[cfg.shape]
    if args.batch or args.seq or args.reduced:
        shape = ShapeConfig(shape.name,
                            args.seq or (64 if args.reduced else shape.seq_len),
                            args.batch or (8 if args.reduced else
                                           shape.global_batch),
                            shape.kind)
    cfg = replace(cfg, arch=arch.name)
    mesh = None
    if backend is not None:
        mesh = make_run_mesh(args, cfg, any(k.startswith("mesh.") for k in sets),
                             world)
    if mesh is not None:
        refuse_unported(mesh, arch, cfg, args.autotune)

    plan = None
    if args.autotune:
        plan = autotune_plan(arch, cfg, shape, mesh, device, rank, world)
        cfg = plan.apply(cfg)

    model = build_model_for(arch, dtype=DTYPES[cfg.compute_dtype],
                            param_dtype=DTYPES[cfg.param_dtype],
                            device=device, seed=cfg.seed, remat=cfg.remat,
                            pp_stages=cfg.pp_stages,
                            pp_microbatches=cfg.pp_microbatches, mesh=mesh)
    trainer = Trainer(model, cfg, shape, mesh=mesh, plan=plan)
    bax = None if mesh is None else sharding.batch_pspec(mesh, trainer.capacity)
    with runtime.layout(mesh, bax):
        _run(trainer, model, cfg, shape, arch, mesh, bax, world)


def _run(trainer, model, cfg, shape, arch, mesh, bax, world) -> None:
    if arch.family in IMAGE_FAMILIES:
        rows = (f"{shape.global_batch} images {arch.image_shape()} x "
                f"{cfg.dp.augmult} views")
    else:
        rows = f"{shape.global_batch} x {shape.seq_len}"
    held = sum(p.numel() for p in model.parameters())
    total, sliced = held, ""
    for attr, what in (("fsdp", "FSDP"), ("tp", "tensor parallel"),
                       ("stage", "pipeline stage")):
        if getattr(model, attr, None) is not None:
            total = sum(p.numel() for p in tree.leaves(model.abstract_params()))
            sliced = f" ({what}: this rank holds {held} of them)"
    print(f"[train] {arch.name}: {total} params{sliced} "
          f"{cfg.param_dtype} (compute {cfg.compute_dtype}) on "
          f"{model.device}; data {cfg.data_source}; batch {rows}; remat "
          f"{cfg.remat}; dp {cfg.dp.algo} norm_strategy={cfg.dp.norm_strategy} "
          f"use_kernels={cfg.dp.use_kernels} adaptive_clip="
          f"{trainer.adaptive_clip}", flush=True)
    if mesh is not None or cfg.pp_stages > 1:
        axes = ("none" if mesh is None else
                dict(zip(sharding._axis_names(mesh), sharding._mesh_shape(mesh))))
        print(f"[train] mesh {axes}; batch over {bax}; zero1={cfg.zero1} "
              f"compress_pod_grads={cfg.compress_pod_grads} pp_stages="
              f"{cfg.pp_stages} pp_microbatches={cfg.pp_microbatches}",
              flush=True)
    if arch.moe.enabled:
        print(f"[train] {arch.moe}", flush=True)
    if trainer.sampling == "poisson":
        print(f"[train] poisson sampling: q = {trainer.sample_rate:.3e}, "
              f"expected batch {shape.global_batch}, capacity "
              f"{trainer.capacity} rows", flush=True)
    fresh = trainer.ckpt.latest_step() is None
    state = trainer.restore_or_init()
    if fresh:
        # every process fingerprints its init; a mismatch (seed or config
        # drift between ranks) raises before any step
        fp = runtime.verify_init_consistency(state.params)
        print(f"[train] init fingerprint {fp:#010x} ({world} process(es) "
              f"agree)", flush=True)
    # the estimated peak beside the measured one, every launch, so the
    # estimator's drift (and the remat policy's effect) stays visible; the
    # estimate is of the global batch in one process, shared out below
    from repro_torch.launch.memory import per_device_peak_bytes
    rep = trainer.memory_report(state, {k: torch.from_numpy(v) for k, v in
                                        trainer.global_batch(state.step).items()})
    per_dev = rep["peak_bytes"]
    share = ""
    if mesh is not None:
        # a stage rank's estimate is already a trace of its own blocks
        width = sharding.batch_axis_width(mesh)
        per_dev = per_device_peak_bytes(rep, width)
        share = (f"; per device {per_dev / 1e9:.3f} GB over a {width}-wide "
                 f"batch axis")
    print(f"[train] memory: estimated peak {rep['peak_bytes'] / 1e9:.3f} GB "
          f"(remat={cfg.remat}, grad_accum={trainer.cfg.grad_accum}, "
          f"per-example side-channel "
          f"{rep['per_example_grad_bytes'] / 1e9:.3f} GB){share}", flush=True)
    budget = cfg.mem.hbm_budget_bytes
    if budget and per_dev > budget:
        print(f"[train] WARNING estimated per-device peak "
              f"{per_dev / 1e9:.3f} GB exceeds mem.hbm_budget_bytes="
              f"{budget / 1e9:.3f} GB (set mem.auto_microbatch=true to split "
              f"the batch)", flush=True)
    print(f"[train] resident on this rank: params "
          f"{sum(p.numel() * p.element_size() for p in tree.leaves(state.params))} B, "
          f"optimizer state "
          f"{sum(t.numel() * t.element_size() for t in tree.leaves(state.opt_state))} "
          f"B", flush=True)
    measure = cfg.mem.compiled_check and model.device.type == "cuda"
    if measure:
        torch.cuda.reset_peak_memory_stats(model.device)
    first = state.step
    launches = kernels.launch_counts()
    with runtime.metered() as records:
        state = trainer.run(state)
    if measure:
        peak = torch.cuda.max_memory_allocated(model.device)
        print(f"[train] memory: measured peak {peak / 1e9:.3f} GB over steps "
              f"{first}..{state.step - 1} (estimate/measured "
              f"{rep['peak_bytes'] / max(peak, 1):.2f})", flush=True)
    launches = {k: v - launches[k] for k, v in kernels.launch_counts().items()}
    moved = {}
    for r in records:
        moved[r["kind"]] = moved.get(r["kind"], 0) + r["bytes"]
    steps = max(1, state.step - first)
    print(f"[train] steps {first}..{state.step - 1}: kernel launches "
          f"{json.dumps(launches)}; collectives {json.dumps(moved)} B in "
          f"{len(records)} calls; a step "
          f"{json.dumps({k: v // steps for k, v in moved.items()})} B", flush=True)
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
