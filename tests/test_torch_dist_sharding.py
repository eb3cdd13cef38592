"""The port's sharding rules and logical axes against the JAX package's.

Every arch in the registry at full size, allocating nothing: the port's
``logical_axes`` and ``abstract_params`` (meta tensors) against the JAX
package's (``ShapeDtypeStruct``s), path by path.  On fake meshes (16 x 16
data/model, 2 x 16 x 16 pod/data/model, a stage/data mesh), with FSDP on
and off: ``spec_for_param`` over every param, ``batch_pspec``,
``state_shardings`` (ZeRO-1 on the optimizer state, phi3's same-shape
``wq``/``wo`` kept apart) and ``cache_shardings`` against the reference.
The reference builds ``NamedSharding``s, which need a real mesh; the
tests put a constructor that returns the spec in its place, so its rules
run on the fake mesh unchanged.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import OptimConfig as JOptimConfig
from repro.dist import sharding as jsh
from repro.models import build_model_for as j_build_model_for
from repro.optim import make_optimizer as j_make_optimizer
from repro.train.state import TrainState as JTrainState
from repro_torch import tree
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import OptimConfig
from repro_torch.dist import sharding as tsh
from repro_torch.models import cnn as tcnn, transformer as ttf, vit as tvit
from repro_torch.models.transformer import Model
from repro_torch.optim import make_optimizer
from repro_torch.train.state import TrainState

ARCH_NAMES = sorted(TARCHS)
MESHES = {"data16_model16": {"data": 16, "model": 16},
          "pod2_data16_model16": {"pod": 2, "data": 16, "model": 16},
          "stage2_data4": {"stage": 2, "data": 4}}


class _FakeMesh:
    """The reference tests' fake mesh: axis names and a devices array."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


class _ShapeMesh:
    """A port-side fake: axis names and a shape, as a DeviceMesh has."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.shape = tuple(sizes.values())


@pytest.fixture
def spec_only(monkeypatch):
    """The reference's NamedSharding constructor replaced by one that
    returns the PartitionSpec, so its rules run on a fake mesh."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)


def _port_fns(arch):
    return {"cnn": tcnn, "vit": tvit}.get(arch.family, ttf)


def _port_model(arch):
    """What the rules read of a model (the arch, ``abstract_params`` and
    ``logical_axes``) without allocating it."""
    fns = _port_fns(arch)
    return types.SimpleNamespace(
        arch=arch, abstract_params=lambda: fns.abstract_params(arch),
        logical_axes=lambda: fns.logical_axes(arch))


def _jax_model(name):
    return j_build_model_for(JARCHS[name], param_dtype="bfloat16",
                             compute_dtype="bfloat16")


def _jax_paths(t, is_leaf=None):
    return [(jsh._norm_path(p), x) for p, x in
            jax.tree_util.tree_flatten_with_path(t, is_leaf=is_leaf)[0]]


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def _jspec(x):
    return tuple(x)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_logical_axes_and_abstract_params_match_jax(name):
    """Full size: the same param paths in the same order, the same shapes
    and dtypes, the same logical axes (``"layers"`` on a stacked leaf)."""
    jm, arch = _jax_model(name), TARCHS[name]
    fns = _port_fns(arch)
    t_abs = fns.abstract_params(arch, torch.bfloat16)
    got = list(tsh._paired(t_abs, fns.logical_axes(arch)))
    want_abs = _jax_paths(jm.abstract_params())
    want_axes = _jax_paths(jm.logical_axes(), is_leaf=_is_axes)
    assert [p for p, _, _ in got] == [p for p, _ in want_abs] == [p for p, _ in want_axes]
    for (path, leaf, axes), (_, jleaf), (_, jaxes) in zip(got, want_abs, want_axes):
        assert leaf.device.type == "meta", path
        assert tuple(leaf.shape) == tuple(jleaf.shape), path
        assert str(leaf.dtype).removeprefix("torch.") == str(jleaf.dtype), path
        assert axes == tuple(jaxes), path
        assert len(axes) == leaf.dim()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_spec_for_param_and_batch_pspec_match_jax(mesh_name, spec_only):
    """Every param of every full-size arch, FSDP off, on and the arch's own;
    batch placements of several batch sizes; the port's rules on both
    fake meshes."""
    sizes = MESHES[mesh_name]
    jmesh = _FakeMesh(sizes)
    for tmesh in (_FakeMesh(sizes), _ShapeMesh(sizes)):
        assert tsh.batch_axis_width(tmesh) == jsh.batch_axis_width(jmesh)
        assert tsh.stage_axis_width(tmesh) == jsh.stage_axis_width(jmesh)
        for B in (1, 2, 8, 16, 24, 32, 256):
            assert tsh.batch_pspec(tmesh, B) == jsh.batch_pspec(jmesh, B), B
        for name in ARCH_NAMES:
            jm, tm = _jax_model(name), _port_model(TARCHS[name])
            for fsdp in (False, True, None):
                want = jsh.param_shardings(jmesh, jm, fsdp=fsdp)
                got = tsh.param_shardings(tmesh, tm, fsdp=fsdp)
                assert tsh.spec_leaves(got) == [_jspec(s) for s in jax.tree.leaves(
                    want, is_leaf=lambda x: isinstance(x, jsh.P))], (name, fsdp)


def _port_state(arch, optim, riders):
    params = ttf.abstract_params(arch, torch.bfloat16)
    leaves = tree.leaves(params)
    opt = make_optimizer(OptimConfig(name=optim)).init(leaves)
    if riders:
        opt = {"opt": opt, "grad_err": [torch.empty(p.shape, device="meta")
                                        for p in leaves],
               "clip": {"clip_norm": torch.empty((), device="meta")}}
    return TrainState(step=0, params=params, opt_state=opt)


def _jax_state(jm, optim, riders):
    params = jm.abstract_params()
    opt = jax.eval_shape(j_make_optimizer(JOptimConfig(name=optim)).init, params)
    if riders:
        opt = {"opt": opt, "grad_err": params,
               "clip": {"clip_norm": jax.ShapeDtypeStruct((), np.float32)}}
    return JTrainState(step=jax.ShapeDtypeStruct((), np.int32), params=params,
                       opt_state=opt)


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "deepseek-moe-16b"])
def test_state_shardings_match_jax(name, spec_only):
    """ZeRO-1 on and off, AdamW, the 8-bit AdamW and SGD, with and without
    the compression and clip riders: every leaf of the train state placed
    as the reference places it.  phi3's wq and wo are both (3072, 3072):
    their moments keep their own axes (data on wq's dim 0 and wo's dim 1)."""
    jm, arch = _jax_model(name), TARCHS[name]
    tm = _port_model(arch)
    for sizes in (MESHES["data16_model16"], MESHES["pod2_data16_model16"]):
        jmesh, tmesh = _FakeMesh(sizes), _ShapeMesh(sizes)
        for optim, riders, zero1 in (("adamw", False, True), ("adamw", True, True),
                                     ("adamw", False, False), ("adam8bit", True, True),
                                     ("sgd", False, True)):
            want = jax.tree.leaves(
                jsh.state_shardings(jmesh, jm, _jax_state(jm, optim, riders),
                                    zero1=zero1),
                is_leaf=lambda x: isinstance(x, jsh.P))
            got = tsh.spec_leaves(tsh.state_shardings(
                tmesh, tm, _port_state(arch, optim, riders), zero1=zero1))
            assert got == [_jspec(s) for s in want], (optim, riders, zero1)
    if name == "phi3-mini-3.8b":
        specs = tsh.state_shardings(_ShapeMesh(MESHES["data16_model16"]), tm,
                                    _port_state(arch, "adamw", False))
        names = [p for p, _, _ in tsh._paired(tm.abstract_params(),
                                              tm.logical_axes())]
        wq = names.index(("blocks", 0, "attn", "wq"))
        wo = names.index(("blocks", 0, "attn", "wo"))
        assert specs.opt_state["m"][wq] == (None, "data", "model")
        assert specs.opt_state["m"][wo] == (None, "model", "data")


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "jamba-1.5-large-398b"])
def test_cache_shardings_match_jax(name, spec_only):
    """Reduced models' caches: the batch dim over the batch axes (dim 1 of
    a stacked block leaf), at batch sizes that divide and that do not."""
    jarch, tarch = jreduced(JARCHS[name]), treduced(TARCHS[name])
    jm = j_build_model_for(jarch, param_dtype="float32", compute_dtype="float32")
    tm = Model(tarch, dtype=torch.float32, device="cpu")
    for B in (1, 16, 32):
        jcache = jax.eval_shape(lambda: jm.init_cache(B, 8))
        tcache = tm.init_cache(B, 8)
        for sizes in (MESHES["data16_model16"], MESHES["pod2_data16_model16"]):
            want = jax.tree.leaves(
                jsh.cache_shardings(_FakeMesh(sizes), jcache, B),
                is_leaf=lambda x: isinstance(x, jsh.P))
            got = tsh.spec_leaves(tsh.cache_shardings(_ShapeMesh(sizes), tcache, B))
            assert got == [_jspec(s) for s in want], (B, sizes)


def test_launcher_refuses_the_unported_axes():
    """A ``stage`` axis above 1 raises "not ported" naming ROADMAP for what
    pipeline stages across processes do not run (a width that does not
    divide ``pp_stages``, a ``use_fsdp`` arch), and so does a ``model``
    axis above 1 for what tensor parallelism does not run (a ``use_fsdp``
    arch); a ``use_fsdp`` arch on a ``data`` axis above 1 runs (FSDP),
    except with ``compress_pod_grads`` or ``adam8bit``, which raise by
    name; a data axis alone, a width-1 model axis, a dense decoder on a
    model axis above 1 (tensor parallelism) or on a stage axis that divides
    its ``pp_stages``, runs."""
    from repro_torch.configs.base import OptimConfig, TrainConfig
    from repro_torch.launch.train import refuse_unported
    phi3, chameleon = TARCHS["phi3-mini-3.8b"], TARCHS["chameleon-34b"]
    assert chameleon.use_fsdp and not phi3.use_fsdp
    refuse_unported(_ShapeMesh({"data": 1, "model": 2}), phi3)
    refuse_unported(_ShapeMesh({"stage": 2, "data": 1}), phi3, TrainConfig(pp_stages=2))
    for sizes, arch, cfg, what in (
            ({"data": 1, "model": 2}, chameleon, None, "tensor parallelism"),
            ({"stage": 2, "data": 1}, phi3, None, "pp_stages=1, which the axis"),
            ({"stage": 2, "data": 1}, chameleon, TrainConfig(pp_stages=2),
             "FSDP with pipeline stages")):
        with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP queue 1"):
            refuse_unported(_ShapeMesh(sizes), arch, cfg)
    for cfg, what in ((TrainConfig(compress_pod_grads=True), "compress_pod_grads"),
                      (TrainConfig(optim=OptimConfig(name="adam8bit")), "adam8bit")):
        with pytest.raises(NotImplementedError, match=f"{what}.*FSDP.*ROADMAP queue 1"):
            refuse_unported(_ShapeMesh({"data": 2}), chameleon, cfg)
        refuse_unported(_ShapeMesh({"data": 2}), phi3, cfg)
        refuse_unported(_ShapeMesh({"data": 1}), chameleon, cfg)
    refuse_unported(_ShapeMesh({"data": 2}), chameleon)
    refuse_unported(_ShapeMesh({"data": 2}), chameleon, TrainConfig(zero1=True))
    refuse_unported(_ShapeMesh({"data": 2, "model": 1}), phi3)
    refuse_unported(_ShapeMesh({"data": 1}), chameleon)
