"""The dry-run: every (architecture x applicable input shape) cell on the
production meshes, without a device or an allocation.  Counterpart of
``repro/launch/dryrun.py``.

For every cell, on the single-pod (16, 16) ``data,model`` and multi-pod
(2, 16, 16) ``pod,data,model`` meshes (``launch/mesh.py`` ``PRODUCTION``):
the train step (the Trainer's ``TrainStep``: ``dpsgd_r`` by default,
AdamW, ``adam8bit`` for ``use_fsdp`` archs, ZeRO-1 over ``data``), the
prefill or the decode step is traced on fake tensors, and its records go
to a JSON artifact a cell.  The reference lowers and compiles one SPMD
program over 512 fake devices; the port runs one process a device, so a
cell is **one rank's program**: rank 0 of a traced mesh (axis names and
sizes, no process group), holding its slices of the params (the
``model`` axis's heads, FFN columns and vocabulary rows; FSDP and stage
slices where the mesh has them), its rows of the batch over the batch
axes and, for the decode, its rows and KV heads of the cache
(``dist.sharding.cache_shardings``), traced under ``dist.runtime.layout``
inside ``runtime.traced()``, where every collective is recorded and not
run (``launch/costs.py`` ``traced_rank``: its costs, collectives and peak
from one trace).  The global fields come from a trace of the whole
program on whole params: ``launch/memory.py`` ``estimate_train_memory``
(or ``estimate_serve_memory``) with its ``CostCounter`` record, as the
reference takes ``jaxpr_costs`` and ``jaxpr_peak_bytes`` of its program.

Artifact: the reference's keys where the meaning is the same (``arch``,
``shape``, ``mesh``, ``n_devices``, ``dp_algo``, ``norm_strategy``,
``tag``, ``mesh_shape``, ``grad_accum``, ``optimizer``, the DP recipe's
``augmult``, ``adaptive_clip``, ``clip_quantile``, ``clip_count_noise``,
``norm_rules``, ``memory`` (the global peak estimate), ``ok``,
``analytic`` (the global costs), ``collective_bytes_per_device`` (rank 0's
wire bytes by kind, ``launch/roofline.py`` ``collective_bytes``),
``collective_top``, ``n_params``, ``n_active_params``,
``model_flops_global``, ``roofline`` (the H100's terms, with
``model_vs_hlo_flops``), ``autotune``, ``total_s``).  The XLA-only keys
are replaced:

* ``memory_analysis`` (XLA's per-device buffers) -> ``rank_memory``, the
  traced peak of rank 0's program (``PeakEstimate`` and ``peak_op``);
* ``xla_flops_per_device``, ``xla_bytes_per_device`` -> ``rank_flops``,
  ``rank_bytes``: rank 0's traced FLOPs and bytes moved;
* ``lower_s``, ``compile_s`` -> ``trace_s``: the seconds of the two traces
  (a process traces a whole program once: the cells of one config on
  other meshes reuse it);
* ``hlo_bytes`` has no counterpart and is dropped.

Added: ``collective_records`` (rank 0's collectives as [kind, bytes,
group, count], the multiset a metered world of the same configuration
gives), ``device``, ``use_kernels``, ``local_ops`` and ``batch_axes``.

A cell the port does not run records ``ok: false`` and ``error:
"NotImplementedError: <reason>"`` before any trace, the reason naming
ROADMAP: ``launch/train.py`` ``unported_mesh_reason`` for a train cell,
``models/transformer.py`` ``serve_mesh_refusal`` (``tp_refusal`` and the
serving refusals) for a prefill or decode cell.  ``--device`` (default
``cuda``) is the fake tensors' device, so it picks the kernel routes; it
never falls back to the CPU (``--device cuda`` without a CUDA build of
PyTorch raises).  No process group, no environment set-up.

Usage:
  python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  python -m repro_torch.launch.dryrun --all --device cpu --out DIR
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.configs import ARCHS, SHAPES, get_arch, shape_applicable
from repro_torch.configs.base import (IMAGE_FAMILIES, DPConfig, OptimConfig,
                                      TrainConfig, TuneConfig)
from repro_torch.dist import sharding
from repro_torch.launch.mesh import PRODUCTION, traced_mesh

DEFAULT_OUT = "results/dryrun_torch"
# the collectives ``collective_top`` lists, by wire bytes
TOP = 12


# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no allocation)
# ---------------------------------------------------------------------------

def input_specs(arch, shape, augmult: int = 1) -> dict:
    """Abstract model inputs of a cell as meta tensors: the reference's
    shapes and dtypes (bf16 embeddings and images, int32 ids and labels;
    ``tokens`` of T+1 for a train cell, T for a prefill, 1 for a decode).
    ``augmult = K > 1`` multiplies a train cell's rows by K."""
    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    B, T = shape.global_batch, shape.seq_len
    rows = B * max(1, augmult) if shape.kind == "train" else B
    if arch.family in IMAGE_FAMILIES:
        assert shape.kind == "train", (arch.name, shape.name)
        size, _, channels = arch.image_shape()
        return {"images": meta((rows, size, size, channels), torch.bfloat16),
                "labels": meta((rows,), torch.int32)}
    if shape.kind in ("train", "prefill"):
        if arch.embed_stub:
            return {"embeds": meta((rows, T, arch.d_model), torch.bfloat16),
                    "labels": meta((rows, T), torch.int32)}
        extra = 1 if shape.kind == "train" else 0
        return {"tokens": meta((rows, T + extra), torch.int32)}
    if arch.embed_stub:                 # decode: one new position
        return {"embeds": meta((rows, 1, arch.d_model), torch.bfloat16)}
    return {"tokens": meta((rows, 1), torch.int32)}


def cell_norm_rules(arch, shape) -> list:
    """The per-site norm-rule cost table of a train cell, from the site
    registry's own FLOP formulas (``costs.norm_rule_summary``): which rule
    ``auto`` picks at this cell's shapes, a site kind each."""
    from repro_torch.launch.costs import norm_rule_summary
    B, T = shape.global_batch, shape.seq_len
    rows = []
    if arch.family == "cnn":
        from repro_torch.models.cnn import iter_conv_sites
        rows = [(label, "conv2d", op_shapes, gy_shape)
                for label, op_shapes, gy_shape in iter_conv_sites(arch, B)]
        rows.append(("head", "dense", ((B, arch.cnn.stage_channels[-1]),),
                     (B, arch.n_classes)))
    elif arch.family == "vit":
        v = arch.vit
        d, p, T = arch.d_model, v.patch_size, v.n_patches
        rows.append(("patch", "conv2d",
                     ((B, v.image_size, v.image_size, v.in_channels),
                      (p, p, v.in_channels, d)),
                     (B, v.grid, v.grid, d)))
        rows.append(("attn_q", "dense", ((B, T, d),), (B, T, arch.n_heads * arch.hd)))
        rows.append(("mlp_w1", "dense", ((B, T, d),), (B, T, arch.d_ff)))
        rows.append(("head", "dense", ((B, d),), (B, arch.n_classes)))
    else:
        d = arch.d_model
        if not arch.embed_stub:
            rows.append(("embed", "embed", ((B, T), (arch.vocab, d)), (B, T, d)))
        if arch.n_heads:
            rows.append(("attn_q", "dense", ((B, T, d),),
                         (B, T, arch.n_heads * arch.hd)))
        if arch.d_ff > 0:
            rows.append(("mlp_w1", "dense", ((B, T, d),), (B, T, arch.ff_dense())))
        if arch.moe.enabled:
            from repro_torch.models.moe import capacity
            C = capacity(arch.moe, T)
            rows.append(("moe_we1", "moe_dense",
                         ((B, arch.moe.num_experts, C, d),),
                         (B, arch.moe.num_experts, C, arch.moe.d_expert)))
    return norm_rule_summary(rows)


def make_grad_accum(arch, shape, mesh) -> int:
    """Keep a device's live batch at <= 4 sequences for 4k-token training:
    the chunks of a train cell's batch (1 for serving)."""
    if shape.kind != "train":
        return 1
    bax = sharding.batch_pspec(mesh, shape.global_batch)
    dp = 1
    for a in (bax or ()):
        dp *= sharding._axis_size(mesh, a)
    per_dev = max(shape.global_batch // dp, 1)
    accum = max(1, per_dev // 4)
    while shape.global_batch % accum or (shape.global_batch // accum) % dp:
        accum -= 1
    return accum


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def cell_mesh(mesh_kind: str, mesh_shape: str = "", mesh_axes: str = ""):
    """The traced mesh of a cell: the production mesh of ``mesh_kind``, or
    ``mesh_shape`` ("16,16") with ``mesh_axes`` (default ``data,model``,
    ``pod,data,model`` for three dims)."""
    if not mesh_shape:
        return traced_mesh(*PRODUCTION[mesh_kind])
    shape = tuple(int(s) for s in mesh_shape.split(","))
    axes = tuple(mesh_axes.split(",")) if mesh_axes else \
        (("pod", "data", "model") if len(shape) == 3 else ("data", "model"))
    return traced_mesh(shape, axes)


def _sizes(mesh) -> dict:
    return {a: sharding._axis_size(mesh, a)
            for a in (sharding.MODEL_AXIS, sharding.STAGE_AXIS, "data")}


def train_config(arch, shape, mesh, dp_algo: str = "dpsgd_r",
                 norm_strategy: str = "auto", augmult: int = 1,
                 adaptive_clip: bool = False, use_kernels: bool = False,
                 dtype: str = "bfloat16") -> TrainConfig:
    """The training config of a train cell: the reference's DP recipe,
    ``adam8bit`` for a ``use_fsdp`` arch and AdamW otherwise, ZeRO-1, the
    chunks of ``make_grad_accum``; params and compute in ``dtype``."""
    opt = "adam8bit" if arch.use_fsdp else "adamw"
    return TrainConfig(
        arch=arch.name, shape=shape.name, param_dtype=dtype, compute_dtype=dtype,
        grad_accum=make_grad_accum(arch, shape, mesh), zero1=True,
        dp=DPConfig(algo=dp_algo, norm_strategy=norm_strategy, augmult=augmult,
                    adaptive_clip=adaptive_clip, use_kernels=use_kernels),
        optim=OptimConfig(name=opt))


def cell_refusal(arch, shape, mesh, cfg: Optional[TrainConfig] = None,
                 serve_fsdp: bool = True) -> str:
    """Why the port does not run this cell, naming ROADMAP; "" when it
    does.  A train cell: ``launch/train.py`` ``unported_mesh_reason`` of
    its config; a prefill or decode: ``serve_mesh_refusal`` (stage slices,
    ``tp_refusal``, FSDP-sharded params)."""
    if shape.kind == "train":
        from repro_torch.launch.train import unported_mesh_reason
        return unported_mesh_reason(arch, _sizes(mesh), cfg)
    from repro_torch.models.transformer import serve_mesh_refusal
    return serve_mesh_refusal(arch, _sizes(mesh), fsdp=serve_fsdp)


@dataclasses.dataclass
class Cell:
    """One cell's program: ``kind`` (``"train"``, ``"prefill"`` or
    ``"decode"``), the whole ``model`` on the meta device, its inputs
    ``batch_abs`` (meta tensors), the ``train_cfg`` of a train cell, the
    cache's ``cache_len`` of a serving one, and the artifact's ``extra``
    keys."""
    kind: str
    model: object
    batch_abs: dict
    train_cfg: Optional[TrainConfig]
    cache_len: int
    extra: dict


def _abstract_params(arch, dtype):
    if arch.family == "cnn":
        from repro_torch.models.cnn import abstract_params
    elif arch.family == "vit":
        from repro_torch.models.vit import abstract_params
    else:
        from repro_torch.models.transformer import abstract_params
    return abstract_params(arch, dtype)


def build_cell(arch, shape, mesh, dp_algo: str = "dpsgd_r",
               norm_strategy: str = "auto", serve_fsdp: bool = True,
               augmult: int = 1, adaptive_clip: bool = False,
               use_kernels: bool = False, dtype: str = "bfloat16") -> Cell:
    """The ``Cell`` of (``arch``, ``shape``) on ``mesh``: the model whole
    on the meta device (nothing allocated; the traces make its params
    fake), the inputs of ``input_specs``.  ``serve_fsdp`` is recorded (a
    ``use_fsdp`` arch serving its FSDP slices is refused by
    ``cell_refusal``)."""
    from repro_torch.models import build_model_for
    dt = getattr(torch, dtype)
    model = build_model_for(arch, _abstract_params(arch, dt), dtype=dt,
                            param_dtype=dt, device="meta")
    batch_abs = input_specs(arch, shape, augmult=augmult)
    if shape.kind == "train":
        cfg = train_config(arch, shape, mesh, dp_algo, norm_strategy, augmult,
                           adaptive_clip, use_kernels, dtype)
        dp = cfg.dp
        extra = {"grad_accum": cfg.grad_accum, "optimizer": cfg.optim.name,
                 "dp_algo": dp_algo, "augmult": int(max(1, augmult)),
                 "adaptive_clip": bool(adaptive_clip),
                 "clip_quantile": dp.clip_quantile if adaptive_clip else None,
                 "clip_count_noise": dp.clip_count_noise if adaptive_clip else None}
        return Cell("train", model, batch_abs, cfg, 0, extra)
    return Cell(shape.kind, model, batch_abs, None, shape.seq_len,
                {"serve_fsdp": bool(serve_fsdp)})


def param_counts(arch, model):
    """(params, active params a token): an MoE layer counts its top-k
    routed experts and its shared ones, as the reference's
    ``active_param_count``."""
    total = sum(p.numel() for p in tree.leaves(model.abstract_params()))
    if not arch.moe.enabled:
        return total, total
    from repro_torch.models.moe import moe_spec
    m = arch.moe
    per_expert = sum(math.prod(p.shape) // m.num_experts
                     for k, p in moe_spec(arch).items() if k.startswith("we"))
    n_moe = sum(arch.is_moe_layer(i) for i in range(arch.n_layers))
    return total, total - n_moe * (m.num_experts - m.top_k) * per_expert


def collective_summary(records):
    """Rank 0's collective records as a sorted multiset: [kind, bytes,
    group, count] each."""
    counts = {}
    for r in records:
        key = (r["kind"], int(r["bytes"]), int(r["group"]))
        counts[key] = counts.get(key, 0) + 1
    return [[k, b, g, n] for (k, b, g), n in sorted(counts.items())]


def _collective_top(summary, n_dev: int) -> list:
    from repro_torch.launch.roofline import RING_FACTORS
    top = [{"kind": k, "bytes": b, "group": g, "count": n,
            "wire_bytes": n * b * RING_FACTORS.get(k, lambda _: 1.0)(max(g or n_dev, 1))}
           for k, b, g, n in summary]
    top.sort(key=lambda r: -r["wire_bytes"])
    return top[:TOP]


# this process's traces of whole programs: a cell's whole program is the
# same on every mesh that gives it the same config (a serving cell's on
# every mesh, a train cell's on meshes of one grad_accum)
_WHOLE: dict = {}


def _trace_global(arch, shape, cell: Cell, device) -> tuple:
    """(memory estimate, costs) of the whole program on whole params."""
    from repro_torch.launch import memory
    key = (arch, shape, cell.kind, cell.train_cfg, cell.cache_len,
           cell.model.dtype, str(device))
    if key not in _WHOLE:
        if cell.kind == "train":
            est = memory.estimate_train_memory(cell.model, cell.train_cfg,
                                               cell.batch_abs, device=device,
                                               costs=True)
        else:
            est = memory.estimate_serve_memory(cell.model, cell.kind, cell.batch_abs,
                                               cell.cache_len, device=device,
                                               costs=True)
        _WHOLE[key] = (est, est.pop("costs"))
    return copy.deepcopy(_WHOLE[key])


def check_device(device) -> torch.device:
    """``device`` as the fake tensors' device; a CUDA device needs a CUDA
    build of PyTorch (the dry-run never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError("repro_torch.launch.dryrun: --device cuda needs a CUDA "
                           "build of PyTorch; pass --device cpu to trace the plain "
                           "PyTorch routes")
    return device


def run_cell(arch, shape, mesh_kind: str, out_dir: str,
             dp_algo: str = "dpsgd_r", norm_strategy: str = "auto", tag: str = "",
             mesh_shape: str = "", mesh_axes: str = "", local_ops: bool = False,
             serve_fsdp: bool = True, augmult: int = 1,
             adaptive_clip: bool = False, autotune: bool = False, *,
             device="cuda", use_kernels: bool = False,
             dtype: str = "bfloat16") -> dict:
    """Trace one cell and write its artifact (``<arch>--<shape>--<mesh>
    [-tag].json`` in ``out_dir``); returns the record.  ``arch`` and
    ``shape``: names, or an ``ArchConfig`` and a ``ShapeConfig`` (a cut
    from Python).  A refused cell records its reason before any trace; an
    exception in a trace is recorded with its traceback, as the reference
    records a failed compile."""
    device = check_device(device)
    arch = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh = cell_mesh(mesh_kind, mesh_shape, mesh_axes)
    n_dev = math.prod(mesh.shape)
    rec = {"arch": arch.name, "shape": shape.name, "mesh": mesh_kind,
           "n_devices": int(n_dev), "dp_algo": dp_algo,
           "norm_strategy": norm_strategy, "tag": tag,
           "mesh_shape": mesh_shape or ",".join(map(str, mesh.shape)),
           "device": str(device), "use_kernels": bool(use_kernels),
           "local_ops": bool(local_ops),
           "batch_axes": sharding.batch_pspec(mesh, shape.global_batch)}
    t0 = time.time()
    try:
        cell = build_cell(arch, shape, mesh, dp_algo, norm_strategy, serve_fsdp,
                          augmult=augmult, adaptive_clip=adaptive_clip,
                          use_kernels=use_kernels, dtype=dtype)
        rec.update(cell.extra)
        if shape.kind == "train":
            rec["norm_rules"] = cell_norm_rules(arch, shape)
        reason = cell_refusal(arch, shape, mesh, cell.train_cfg, serve_fsdp)
        if reason:
            raise NotImplementedError(reason)
        from repro_torch.launch.costs import traced_rank
        from repro_torch.launch.roofline import (collective_bytes, model_flops,
                                                 roofline_terms)
        t1 = time.time()
        est, analytic = _trace_global(arch, shape, cell, device)
        rank = traced_rank(cell.model, mesh, cell.batch_abs, train_cfg=cell.train_cfg,
                           kind=cell.kind, cache_len=cell.cache_len, device=device)
        trace_s = time.time() - t1
        coll = collective_bytes(rank["collectives"], n_dev)
        summary = collective_summary(rank["collectives"])
        n_params, n_active = param_counts(arch, cell.model)
        rec.update({
            "ok": True,
            "trace_s": round(trace_s, 2),
            "analytic": analytic,
            "memory": est,
            "rank_memory": rank["memory"],
            "rank_flops": float(rank["costs"]["total_flops"]),
            "rank_bytes": float(rank["costs"]["total_bytes"]),
            "collective_bytes_per_device": coll,
            "collective_top": _collective_top(summary, n_dev),
            "collective_records": summary,
            "n_params": int(n_params),
            "n_active_params": int(n_active),
        })
        rec["model_flops_global"] = model_flops(arch, shape, n_active)
        rec["roofline"] = roofline_terms(
            analytic["total_flops"], analytic["total_bytes"] + analytic["io_bytes"],
            coll.get("total", 0.0) * n_dev, n_dev)
        rec["roofline"]["model_vs_hlo_flops"] = (
            rec["model_flops_global"] / max(analytic["total_flops"], 1.0))
        if autotune and shape.kind == "train":
            rec["autotune"] = _autotune(arch, shape, mesh, cell.train_cfg, device)
    except Exception as e:  # noqa: BLE001 -- record the failure, don't die
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}"})
        if not isinstance(e, NotImplementedError):
            rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"-{tag}" if tag else ""
    path = os.path.join(out_dir, f"{arch.name}--{shape.name}--{mesh_kind}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    status = "OK" if rec.get("ok") else "FAIL"
    why = "" if rec.get("ok") else f": {rec['error']}"
    print(f"[dryrun] {status} {arch.name} x {shape.name} x {mesh_kind} "
          f"({rec['total_s']}s) -> {path}{why}", flush=True)
    return rec


def _autotune(arch, shape, mesh, cfg: TrainConfig, device) -> dict:
    """The launch autotuner's winning plan, predicted only (a beam search,
    nothing measured), on the cell's mesh shape; on an axis the autotuner
    refuses (``model``, ``stage``), its reason."""
    from repro_torch.launch.autotune import solve
    from repro_torch.launch.train import unported_mesh_reason
    reason = unported_mesh_reason(arch, _sizes(mesh), cfg, autotune=True)
    if reason:
        return {"refused": f"NotImplementedError: {reason}"}
    cfg_t = dataclasses.replace(cfg, tune=TuneConfig(method="beam", beam_width=4,
                                                     topk=4))
    try:
        report = solve(arch, cfg_t, shape, mesh_shapes=[tuple(mesh.shape)],
                       measure=False, device=device)
    except ValueError as e:
        return {"refused": f"ValueError: {e}"}
    return report.as_dict()


def all_cells():
    """Every (arch name, shape name) whose shape the arch applies to."""
    for arch_name in sorted(ARCHS):
        for shape_name, shape in SHAPES.items():
            if shape_applicable(ARCHS[arch_name], shape):
                yield arch_name, shape_name


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--dp-algo", default="dpsgd_r")
    ap.add_argument("--norm-strategy", default="auto")
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh-shape", default="",
                    help="a traced mesh of any shape, e.g. 256,1")
    ap.add_argument("--mesh-axes", default="")
    ap.add_argument("--use-flash", action="store_true",
                    help="the norm rules' kernel routes (dp.use_kernels); "
                         "attention always takes the flash kernels")
    ap.add_argument("--local-ops", action="store_true",
                    help="recorded: every per-example op of the port is "
                         "local to its rank")
    ap.add_argument("--no-serve-fsdp", action="store_true",
                    help="serve use_fsdp archs on whole params")
    ap.add_argument("--augmult", type=int, default=1,
                    help="augmentation multiplicity K for train cells")
    ap.add_argument("--adaptive-clip", action="store_true",
                    help="trace the quantile-adaptive clip update in train cells")
    ap.add_argument("--autotune", action="store_true",
                    help="add the launch autotuner's winning plan "
                         "(predicted only) to train cells")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cuda: the kernel routes)")
    args = ap.parse_args(argv)
    check_device(args.device)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    n_fail = 0
    for arch_name, shape_name in cells:
        for mk in meshes:
            suffix = f"-{args.tag}" if args.tag else ""
            path = os.path.join(args.out, f"{arch_name}--{shape_name}--{mk}{suffix}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        print(f"[dryrun] skip existing {path}", flush=True)
                        continue
            rec = run_cell(arch_name, shape_name, mk, args.out, args.dp_algo,
                           args.norm_strategy, args.tag, args.mesh_shape,
                           args.mesh_axes, local_ops=args.local_ops,
                           serve_fsdp=not args.no_serve_fsdp, augmult=args.augmult,
                           adaptive_clip=args.adaptive_clip, autotune=args.autotune,
                           device=args.device, use_kernels=args.use_flash)
            n_fail += 0 if rec.get("ok") else 1
    print(f"[dryrun] done; {n_fail} failures", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
