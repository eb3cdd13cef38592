"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU, small.

* Its pure functions against the reference's (``repro.launch.dryrun``):
  ``input_specs`` (shapes and dtypes), ``cell_norm_rules`` and
  ``make_grad_accum`` on both production meshes for every arch x
  applicable shape, and ``all_cells``.
* Reduced phi3 ``train``, ``prefill`` and ``decode`` cells, each one
  rank's fake-tensor trace, on a traced (2, 2) ``data,model`` mesh and a
  (2, 1, 2) ``pod,data,model`` one: ``ok``, the record's keys, the global
  ``analytic`` and ``memory`` those of the whole program's own traces, and
  rank 0's FLOPs times the ranks at least the global FLOPs and at most
  ``REPLICATED`` times them (the work every model rank repeats: the norms,
  the residual stream's elementwise ops, the embedding's and the
  cross-entropy's reductions).
* ``--autotune`` on a model axis records the autotuner's refusal in the
  cell, which stays ``ok``.
* What the port refuses on a model axis records ``ok: false`` and its
  reason, naming ROADMAP, before any trace; prefill and decode of pipeline
  stage slices and of FSDP-sharded params raise by name.
* The CLI on a refused production cell exits 1 with a ``FAIL`` line and
  its JSON; ``--device cuda`` without a CUDA build raises.
"""
import dataclasses
import json
import math
import types

import pytest
import torch

from repro_torch import tree
from repro_torch.configs import ARCHS, SHAPES, reduced, shape_applicable
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import PRODUCTION, traced_mesh
from repro_torch.models.transformer import Model

PHI3 = "phi3-mini-3.8b"
# reduced cells: B 8 x T 16 train, 4 prompts of 16, a decode against 16
CUT = {"train": ShapeConfig("train_4k", 16, 8, "train"),
       "prefill": ShapeConfig("prefill_32k", 16, 4, "prefill"),
       "decode": ShapeConfig("decode_32k", 16, 4, "decode")}
MESHES = {"2x2": ("2,2", "data,model"), "2x1x2": ("2,1,2", "pod,data,model")}
# rank 0's FLOPs x the ranks over the global FLOPs: at least 1, and at
# most this (reduced phi3's d_model 64 makes the replicated elementwise
# work 3-4% of a train step's FLOPs, under 1% of a serving program's)
REPLICATED = 1.1
KEYS = ("arch", "shape", "mesh", "n_devices", "dp_algo", "norm_strategy", "tag",
        "mesh_shape", "memory", "ok", "analytic", "collective_bytes_per_device",
        "collective_top", "n_params", "n_active_params", "model_flops_global",
        "roofline", "total_s", "rank_memory", "rank_flops", "rank_bytes", "trace_s",
        "collective_records")
TRAIN_KEYS = ("grad_accum", "optimizer", "augmult", "adaptive_clip", "clip_quantile",
              "clip_count_noise", "norm_rules")


def _phi3():
    return reduced(ARCHS[PHI3])


# ---------------------------------------------------------------------------
# the pure functions against the reference's
# ---------------------------------------------------------------------------

def _ref_mesh(kind):
    shape, axes = PRODUCTION[kind]
    return types.SimpleNamespace(axis_names=axes,
                                 devices=types.SimpleNamespace(shape=shape))


@pytest.mark.parametrize("arch_name", sorted(ARCHS))
def test_pure_functions_match_the_reference(arch_name):
    from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES
    from repro.launch import dryrun as jdryrun
    arch, jarch = ARCHS[arch_name], JARCHS[arch_name]
    for name, shape in SHAPES.items():
        if not shape_applicable(arch, shape):
            continue
        jshape = JSHAPES[name]
        for augmult in ((1, 2) if shape.kind == "train" else (1,)):
            got = dryrun.input_specs(arch, shape, augmult)
            want = jdryrun.input_specs(jarch, jshape, augmult)
            assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                    for k, v in got.items()} == {
                k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}, name
            assert all(v.device.type == "meta" for v in got.values())
        if shape.kind == "train":
            assert dryrun.cell_norm_rules(arch, shape) == \
                jdryrun.cell_norm_rules(jarch, jshape), name
        for kind in PRODUCTION:
            assert dryrun.make_grad_accum(arch, shape, traced_mesh(
                *PRODUCTION[kind])) == jdryrun.make_grad_accum(
                jarch, jshape, _ref_mesh(kind)), (name, kind)


def test_all_cells_match_the_reference():
    from repro.launch import dryrun as jdryrun
    assert list(dryrun.all_cells()) == list(jdryrun.all_cells())
    assert dryrun.DEFAULT_OUT != jdryrun.DEFAULT_OUT


# ---------------------------------------------------------------------------
# reduced cells: one rank's trace on a traced mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    return {(mesh, kind): dryrun.run_cell(
        _phi3(), CUT[kind], "single", str(out / mesh), mesh_shape=shape,
        mesh_axes=axes, device="cpu", dtype="float32", autotune=kind == "train")
        for mesh, (shape, axes) in MESHES.items() for kind in CUT}


@pytest.fixture(scope="module")
def whole():
    """The whole programs' own traces: the train step's ``traced_costs``
    and ``estimate_train_memory``; the serving programs'
    ``estimate_serve_memory`` with its costs."""
    from repro_torch.launch import costs, memory
    from repro_torch.train.trainer import TrainStep
    cell = dryrun.build_cell(_phi3(), CUT["train"], traced_mesh((2, 2), ("data", "model")),
                             dtype="float32")
    step = TrainStep(cell.model, cell.train_cfg)
    cell.model.remat = cell.train_cfg.remat
    params = tree.tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"
                                                 ).requires_grad_(True), cell.model.params)
    out = {"train": (memory.estimate_train_memory(cell.model, cell.train_cfg,
                                                  cell.batch_abs, device="cpu"),
                     costs.traced_costs(lambda p, b: step(step.init_state(p, "cpu"), b,
                                                          torch.Generator()),
                                        params, cell.batch_abs, device="cpu"))}
    for kind in ("prefill", "decode"):
        c = dryrun.build_cell(_phi3(), CUT[kind], traced_mesh((1,), ("data",)),
                              dtype="float32")
        est = memory.estimate_serve_memory(c.model, kind, c.batch_abs, c.cache_len,
                                           device="cpu", costs=True)
        out[kind] = (est, est.pop("costs"))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", sorted(CUT))
def test_reduced_cell(cells, whole, mesh, kind):
    rec = cells[mesh, kind]
    assert rec["ok"], rec.get("traceback", rec.get("error"))
    for k in KEYS + (TRAIN_KEYS if kind == "train" else ()):
        assert k in rec, k
    assert rec["n_devices"] == 4 and rec["mesh_shape"] == MESHES[mesh][0]
    est, want = whole[kind]
    got = rec["analytic"]
    for k in ("dot_flops_by_dtype", "elementwise_flops", "dot_bytes", "move_bytes",
              "gemms", "kernels"):
        assert got[k] == want[k], k
    assert rec["memory"] == est
    ratio = 4 * rec["rank_flops"] / got["total_flops"]
    assert 1.0 <= ratio <= REPLICATED, ratio
    # every rank's model collectives span the 2-wide model axis
    kinds = {r[0] for r in rec["collective_records"]}
    assert "all-reduce" in kinds and "all-gather" in kinds, kinds
    assert rec["collective_bytes_per_device"]["total"] > 0
    assert rec["rank_memory"]["peak_bytes"] < est["peak_bytes"]
    assert set(rec["roofline"]) >= {"compute_s", "memory_s", "collective_s",
                                    "bottleneck", "model_vs_hlo_flops"}
    if kind == "train":
        # the autotuner refuses a model axis: recorded in the cell, which is ok
        assert "--autotune" in rec["autotune"]["refused"], rec["autotune"]


def test_cache_shardings_cut_the_kv_heads():
    """On a model axis a rank's cache holds its rows and KV heads
    (``cache_shardings`` with the model), the shapes of a model rank's
    ``init_cache``; without the model the reference's placement."""
    from repro_torch.launch.memory import abstract_cache
    arch = _phi3()
    mesh = traced_mesh((2, 2), ("data", "model"))
    whole = Model(arch, dtype=torch.float32, device="cpu")
    cache = abstract_cache(whole, 8, 16)
    specs = sharding.cache_shardings(mesh, cache, 8, model=whole)
    assert sharding.spec_leaves(specs) == [
        sharding.PartitionSpec(None, "data", None, "model", None)] * 2
    assert sharding.spec_leaves(sharding.cache_shardings(mesh, cache, 8)) == [
        sharding.PartitionSpec(None, "data", None, None, None)] * 2
    rank = Model(arch, dtype=torch.float32, device="cpu", mesh=types.SimpleNamespace(
        axis_names=("data", "model"), shape=(2, 2), get_local_rank=lambda axis: 0))
    for leaf, spec, got in zip(tree.leaves(cache), sharding.spec_leaves(specs),
                               tree.leaves(abstract_cache(rank, 4, 16))):
        local = [n // math.prod(sharding._axis_size(mesh, a) for a in (
            e if isinstance(e, tuple) else (e,) if e else ())) for n, e in zip(leaf.shape, spec)]
        assert tuple(local) == tuple(got.shape)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

REFUSED = {
    "chatglm3-kv-heads": ("chatglm3-6b", {}, "replicating KV heads"),
    "deepseek-moe": ("deepseek-moe-16b", {}, "MoE layers"),
    "mamba2": ("mamba2-1.3b", {}, "Mamba layers"),
    "chameleon-fsdp-qk-norm": ("chameleon-34b", {"use_fsdp": True}, "qk_norm"),
    "cnn-cifar10": ("cnn-cifar10", {}, "image family"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_cell_records_its_reason(case, tmp_path):
    name, over, what = REFUSED[case]
    arch = dataclasses.replace(reduced(ARCHS[name]), **over)
    kinds = ("train",) if arch.family in ("cnn", "vit") else ("train", "decode")
    for kind in kinds:
        rec = dryrun.run_cell(arch, CUT[kind], "single", str(tmp_path), mesh_shape="2,2",
                              device="cpu")
        assert rec["ok"] is False and rec["error"].startswith("NotImplementedError: ")
        assert what in rec["error"] and "ROADMAP queue 1" in rec["error"], rec["error"]
        assert "analytic" not in rec and "traceback" not in rec
    if case == "chameleon-fsdp-qk-norm":
        assert "FSDP with tensor parallelism" in rec["error"]


def _sliced(kind):
    """A reduced decoder holding rank 0's pipeline stage slices or FSDP
    slices (a mesh of names and sizes)."""
    axes = ("data", "stage") if kind == "stage" else ("data",)
    mesh = types.SimpleNamespace(axis_names=axes, shape=(1, 2) if kind == "stage" else (2,),
                                 get_local_rank=lambda axis: 0)
    arch = _phi3() if kind == "stage" else dataclasses.replace(_phi3(), use_fsdp=True)
    return Model(arch, dtype=torch.float32, device="cpu", mesh=mesh,
                 pp_stages=2 if kind == "stage" else 1)


@pytest.mark.parametrize("sliced,what", [("stage", "pipeline stage slices"),
                                         ("fsdp", "FSDP-sharded params")])
@pytest.mark.parametrize("program", ["prefill", "decode"])
def test_serving_sliced_params_refused(sliced, what, program):
    m = _sliced(sliced)
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item") as err:
        if program == "prefill":
            m.prefill(toks, 8)
        else:
            m.decode_step(m.init_cache(1, 8), toks[:, :1], torch.zeros((1,), dtype=torch.long))
    assert what in str(err.value)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_cli_refused_production_cell(tmp_path, capsys):
    """chatglm3-6b's 2 KV heads on the 16-wide model axis: refused before
    any trace, exit 1 as the reference exits on a failed cell."""
    with pytest.raises(SystemExit) as ex:
        dryrun.main(["--arch", "chatglm3-6b", "--shape", "train_4k", "--mesh", "single",
                     "--device", "cpu", "--out", str(tmp_path)])
    assert ex.value.code == 1
    out = capsys.readouterr().out
    assert "[dryrun] FAIL chatglm3-6b x train_4k x single" in out
    assert "[dryrun] done; 1 failures" in out
    rec = json.loads((tmp_path / "chatglm3-6b--train_4k--single.json").read_text())
    assert rec["ok"] is False and "replicating KV heads" in rec["error"]
    assert rec["mesh_shape"] == "16,16" and rec["n_devices"] == 256
    assert rec["grad_accum"] == 4 and rec["optimizer"] == "adamw"


def test_cli_cuda_needs_a_cuda_build(tmp_path):
    if torch.backends.cuda.is_built():
        pytest.skip("a CUDA build of PyTorch traces fake CUDA tensors")
    with pytest.raises(RuntimeError, match="CUDA build"):
        dryrun.main(["--arch", PHI3, "--shape", "train_4k", "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())
