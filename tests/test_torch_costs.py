"""The port's cost counter and roofline (``repro_torch/launch/costs.py``,
``roofline.py``) against the JAX package's (``repro/launch/costs.py``,
``roofline.py``).

* Exact counts: a product, a batched product, a convolution, a 10-step loop
  and a remat recompute traced by both packages on the same shapes.
* ``roofline_terms`` and ``model_flops`` equal the reference's with its
  constants passed in, at a train, a prefill and a decode shape of the
  reduced phi3, ``cnn-cifar10`` and ``vit-cifar10``; ``collective_bytes``
  turns a traced step's records under a (2, 1) layout into 2(w-1)/w of
  the clipped sum's bytes; ``norm_rule_summary`` equals the reference's.
* Whole steps on the reduced phi3 and ``cnn-cifar10`` at ``remat="none"``
  in float32: ``sgd`` and ``dpsgd_r`` (``materialize``, ``gram``) against
  ``jaxpr_costs``: dot FLOPs within 1e-6 and the GEMM multisets equal up to
  m <-> n once the records named below are set aside; elementwise FLOPs
  and move bytes within the planner's ``TOLERANCE_FACTOR``; ``dpsgd``'s
  FLOPs (its records are per example by design).
* Kernel routes: each wrapper's record on fake CUDA tensors (its fake
  branch) equals its record on CPU tensors (its plain version), and the
  ``use_kernels`` steps cost their plain route's work plus the named
  records of the kernels' own dataflow.

The records that differ, each with its cause:
* the flash backward recomputes S = QKᵀ from the row logsumexp: one
  (B·H·T, hd, T) product per attention backward that the reference's
  plain attention (autodiff of its forward) does not run; and it forms dK
  and dV with M over (B·H, S), (B·H·T, T, hd), where the reference's
  transposed dot takes M over (B·KV, hd), (B·KV·hd, rep·T, S): the same
  FLOPs;
* a remat region's forward runs in the port's eager step even where only
  its gradient is used; the reference's dead-code pass drops it;
* the reference extracts a conv site's im2col patches with
  ``conv_general_dilated_patches``, a convolution with a one-hot kernel
  ((B·H'·W', kh·kw, C_in·kh·kw), once per conv site in the norm pass),
  where the port's ``unfold`` is a view;
* the port's conv2d site pads x before a VALID convolution, so its input
  gradient covers the padded positions: (B·Hp·Wp, kh·kw·C_out, C_in) where
  the reference's SAME convolution has (B·H·W, ...), per backward of each
  padded conv whose input needs a gradient;
* with kernels, the embedding site's norm is ``gram_norm``'s id-masked Gram
  of gy ((B·T, d, T) a step), where the plain rule sums gy rows by id; and
  the fused norm pass's attention backward is the flash pair (its records
  above) where the plain route differentiates its einsums (dK as the
  reference forms it, dV as the flash backward does).
"""
import collections
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import (DPConfig as JDPConfig,
                                ShapeConfig as JShapeConfig,
                                TrainConfig as JTrainConfig)
from repro.launch import costs as jcosts, roofline as jroof
from repro.launch.memory import abstract_batch as jbatch, abstract_step_args
from repro.models import build_model_for as jbuild
from repro.train.trainer import make_train_step
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tb
from repro_torch.dist import runtime
from repro_torch.kernels import (clip_reduce as _cr, flash_attn as _fa,
                                 fused_bwd as _fb, gram_norm as _gn,
                                 pegrad_norm as _pn)
from repro_torch.launch import costs as tcosts, roofline as troof
from repro_torch.launch.memory import (abstract_batch, estimate_train_memory,
                                       within_tolerance)
from repro_torch.models import build_model_for

PHI3, CNN, VIT = "phi3-mini-3.8b", "cnn-cifar10", "vit-cifar10"
B, T = 2, 24            # T apart from the reduced phi3's hd (16)
RTOL = 1e-6


def _meta(shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta").requires_grad_(grad)


def _sds(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _key(g):
    m, k, n = g[:3]
    return (min(m, n), k, max(m, n))


def _multiset(gemms):
    out = collections.Counter()
    for g in gemms:
        out[_key(g)] += g[3]
    return out


def _flops(c):
    return sum(c["dot_flops_by_dtype"].values())


def _named_flops(named):
    return sum(2.0 * m * k * n * c for (m, k, n), c in named.items())


# ---------------------------------------------------------------------------
# exact counts
# ---------------------------------------------------------------------------

def test_dot_and_batched_dot_and_loop_match_jax():
    p = tcosts.traced_costs(lambda x, y: x @ y, _meta((64, 32), torch.bfloat16),
                            _meta((32, 128), torch.bfloat16))
    j = jcosts.jaxpr_costs(lambda x, y: x @ y, _sds((64, 32), jnp.bfloat16),
                           _sds((32, 128), jnp.bfloat16))
    assert p["dot_flops_by_dtype"] == j["dot_flops_by_dtype"] == {
        "bfloat16": 2 * 64 * 32 * 128}
    assert p["gemms"] == j["gemms"]
    p = tcosts.traced_costs(lambda x, y: torch.einsum("bij,bjk->bik", x, y),
                            _meta((4, 8, 16)), _meta((4, 16, 32)))
    j = jcosts.jaxpr_costs(lambda x, y: jnp.einsum("bij,bjk->bik", x, y),
                           _sds((4, 8, 16)), _sds((4, 16, 32)))
    assert p["dot_flops_by_dtype"] == j["dot_flops_by_dtype"] == {
        "float32": 2 * 4 * 8 * 16 * 32}
    assert p["gemms"] == j["gemms"] == [[32, 16, 32, 1.0]]

    def loop(x):
        for _ in range(10):
            x = x @ x
        return x

    def scan(x):
        return jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=10)[0]

    p = tcosts.traced_costs(loop, _meta((16, 16)))
    j = jcosts.jaxpr_costs(scan, _sds((16, 16)))
    assert p["dot_flops_by_dtype"] == j["dot_flops_by_dtype"] == {
        "float32": 10 * 2 * 16 ** 3}
    assert p["gemms"] == j["gemms"] == [[16, 16, 16, 10.0]]


def test_conv_and_its_backward_match_jax():
    x, w = _meta((2, 3, 8, 8), grad=True), _meta((4, 3, 3, 3), grad=True)
    jx, jw = _sds((2, 8, 8, 3)), _sds((3, 3, 3, 4))

    def jconv(x, w, s):
        return jax.lax.conv_general_dilated(x, w, (s, s), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    for s in (1, 2):
        fwd = tcosts.traced_costs(
            lambda x, w: torch.nn.functional.conv2d(x, w, padding=1, stride=s), x, w)
        assert fwd["gemms"] == jcosts.jaxpr_costs(lambda x, w: jconv(x, w, s),
                                                  jx, jw)["gemms"]
        p = tcosts.traced_costs(lambda x, w: torch.autograd.grad(
            torch.nn.functional.conv2d(x, w, padding=1, stride=s).sum(), (x, w)), x, w)
        j = jcosts.jaxpr_costs(lambda x, w: jax.grad(
            lambda x, w: jconv(x, w, s).sum(), argnums=(0, 1))(x, w), jx, jw)
        # the port's eager step also runs the forward, which the
        # reference's dead-code pass drops from a gradient-only program
        assert _multiset(p["gemms"]) - _multiset(fwd["gemms"]) == _multiset(j["gemms"])
        assert _flops(p) - _flops(fwd) == _flops(j)


def test_remat_counts_the_recompute():
    from torch.utils.checkpoint import checkpoint
    x = _meta((32, 32), grad=True)

    def port(u):
        y = checkpoint(lambda v: torch.sin(v @ v) @ v, u, use_reentrant=False)
        return torch.autograd.grad(y.sum(), u)[0]

    def ref(u):
        g = jax.checkpoint(lambda v: jnp.sin(v @ v) @ v)
        return jax.grad(lambda v: g(v).sum())(u)

    base = tcosts.traced_costs(lambda u: torch.sin(u @ u) @ u, x)
    p, j = tcosts.traced_costs(port, x), jcosts.jaxpr_costs(ref, _sds((32, 32)))
    # both count the recompute; the port also the eager forward (2 products)
    assert _flops(p) > 2 * _flops(base)
    assert _flops(p) - _flops(base) == _flops(j) == 5 * 2 * 32 ** 3


# ---------------------------------------------------------------------------
# roofline, model FLOPs, collectives, norm rules
# ---------------------------------------------------------------------------

def test_h100_constants():
    assert (troof.PEAK_FLOPS, troof.PEAK_FLOPS_F32, troof.HBM_BW,
            troof.LINK_BW) == (989e12, 67e12, 3.35e12, 450e9)
    t = troof.roofline_terms(989e12, 3.35e12 * 2, 0.0, 1)
    assert t["compute_s"] == pytest.approx(1.0) and t["memory_s"] == pytest.approx(2.0)
    assert t["bottleneck"] == "memory"


def _param_count(arch) -> int:
    from repro_torch import tree
    from repro_torch.models import cnn, transformer, vit
    mod = {"cnn": cnn, "vit": vit}.get(arch.family, transformer)
    return sum(p.numel() for p in tree.leaves(mod.abstract_params(arch)))


@pytest.mark.parametrize("name", [PHI3, CNN, VIT])
def test_roofline_and_model_flops_match_jax(name):
    ja, ta = jreduced(JARCHS[name]), tconfigs.reduced(tconfigs.get_arch(name))
    n = _param_count(ta)
    assert n == ja.active_param_count()
    kinds = ["train"] if ta.family in tb.IMAGE_FAMILIES else ["train", "prefill", "decode"]
    for kind in kinds:
        js = JShapeConfig(kind, 64, 4, kind)
        ts = tb.ShapeConfig(kind, 64, 4, kind)
        mf = troof.model_flops(ta, ts, n)
        assert mf == jroof.model_flops(ja, js, n) > 0
        for coll in (0.0, 1e9):
            got = troof.roofline_terms(mf, mf / 3, coll, 4, peak_flops=jroof.PEAK_FLOPS,
                                       hbm_bw=jroof.HBM_BW, link_bw=jroof.ICI_BW)
            assert got == jroof.roofline_terms(mf, mf / 3, coll, 4)


def test_norm_rule_summary_matches_jax():
    from repro.launch.costs import norm_rule_summary as jsummary
    ta = tconfigs.reduced(tconfigs.get_arch(PHI3))
    d, f = ta.d_model, ta.d_ff
    rows = []
    for t in (T, 2048):
        for label, di, do in (("qkvo", d, d), ("w1", d, f), ("w2", f, d),
                              ("head", d, ta.vocab)):
            rows.append((f"{label}@{t}", "dense", ((B, t, di), (di, do)), (B, t, do)))
        rows.append((f"embed@{t}", "embed", ((B, t), (ta.vocab, d)), (B, t, d)))
    assert tcosts.norm_rule_summary(rows) == jsummary(rows)
    assert {r["auto"] for r in tcosts.norm_rule_summary(rows)} >= {"materialize", "gram"}


def test_collective_bytes_of_a_traced_data_parallel_step():
    """A traced step under a (2, 1) layout with no process group: the
    clipped sum's all-reduce records its bytes, and ``collective_bytes``
    prices them at 2(w-1)/w; the metrics' gathers at (w-1)/w.  Outside a
    trace the layout raises instead of skipping the sum."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import tree
    from repro_torch.train.trainer import TrainStep
    ta = tconfigs.reduced(tconfigs.get_arch(PHI3))
    model = build_model_for(ta, dtype=torch.float32, param_dtype=torch.float32,
                            device="cpu", seed=0, remat="none")
    cfg = tb.TrainConfig(param_dtype="float32", compute_dtype="float32", remat="none",
                         dp=tb.DPConfig(norm_strategy="materialize"))
    mesh = types.SimpleNamespace(axis_names=("data", "model"), shape=(2, 1))
    step = TrainStep(model, cfg)
    with FakeTensorMode():
        params = tree.tree_map(lambda p: torch.empty(p.shape).requires_grad_(True),
                               model.params)
        state = step.init_state(params, torch.device("cpu"))
        batch = {"tokens": torch.zeros((B, T + 1), dtype=torch.int32)}
        counter = tcosts.CostCounter()
        with counter, runtime.layout(mesh, ("data",)):
            step(state, batch, torch.Generator())
        grad_bytes = sum(4 * p.numel() for p in tree.leaves(params))
    recs = counter.costs.collectives
    reduces = [r for r in recs if r["kind"] == "all-reduce"]
    assert sum(r["bytes"] for r in reduces) == grad_bytes
    assert all(r["group"] == 2 for r in recs)
    wire = troof.collective_bytes(recs, 2)
    assert wire["all-reduce"] == pytest.approx(2 * (2 - 1) / 2 * grad_bytes)
    gathers = sum(r["bytes"] for r in recs if r["kind"] == "all-gather")
    assert gathers > 0 and wire["all-gather"] == pytest.approx(gathers / 2)
    assert wire["total"] == pytest.approx(wire["all-reduce"] + wire["all-gather"])
    # outside a trace the same layout has no group to sum over: it raises
    with pytest.raises(RuntimeError, match="no process group"):
        with runtime.layout(mesh, ("data",)):
            pass


def test_a_collective_meter_is_not_a_trace():
    """The launcher's byte meter (``runtime.metered``) records collectives
    and changes nothing else: a real step under a layout with no process
    group still raises inside it; only a cost trace (``runtime.traced``)
    runs such a layout, on ``TracedGroup``s."""
    from repro_torch.train.trainer import TrainStep
    ta = tconfigs.reduced(tconfigs.get_arch(PHI3))
    model = build_model_for(ta, dtype=torch.float32, param_dtype=torch.float32,
                            device="cpu", seed=0, remat="none")
    step = TrainStep(model, tb.TrainConfig(param_dtype="float32",
                                           compute_dtype="float32", remat="none"))
    state = step.init_state(model.params, torch.device("cpu"))
    batch = {"tokens": torch.zeros((B, T + 1), dtype=torch.int32)}
    mesh = types.SimpleNamespace(axis_names=("data", "model"), shape=(2, 1))
    with runtime.metered() as recs:
        with pytest.raises(RuntimeError, match="no process group"):
            with runtime.layout(mesh, ("data",)):
                step(state, batch, torch.Generator())
        assert recs == []
        with runtime.traced(), runtime.layout(mesh, ("data",)):
            group = runtime.batch_group()
            assert isinstance(group, runtime.TracedGroup) and group.size == 2
            runtime.all_reduce_([torch.ones(3)], group)
    assert recs == [{"kind": "all-reduce", "bytes": 12, "group": 2}]
    assert runtime.COLLECTIVE_SINKS == []


# ---------------------------------------------------------------------------
# whole steps against jaxpr_costs
# ---------------------------------------------------------------------------

def _jax_step(name, algo, strategy):
    ja = jreduced(JARCHS[name])
    cfg = JTrainConfig(arch=ja.name, param_dtype="float32", compute_dtype="float32",
                       remat="none", dp=JDPConfig(algo=algo, norm_strategy=strategy,
                                                  enabled=algo != "sgd"))
    model = jbuild(ja, param_dtype="float32", compute_dtype="float32", remat="none")
    state, key = abstract_step_args(model, cfg)
    return jcosts.jaxpr_costs(make_train_step(model, cfg), state, jbatch(ja, B, T), key)


_PORT_MODELS, _PORT_STEPS = {}, {}


def _port_step(name, algo, strategy, kernels=False):
    key = (name, algo, strategy, kernels)
    if key not in _PORT_STEPS:
        _PORT_STEPS[key] = _trace_port_step(*key)
    return _PORT_STEPS[key]


def _trace_port_step(name, algo, strategy, kernels):
    ta = tconfigs.reduced(tconfigs.get_arch(name))
    if name not in _PORT_MODELS:
        _PORT_MODELS[name] = build_model_for(ta, dtype=torch.float32,
                                             param_dtype=torch.float32, device="cpu",
                                             seed=0, remat="none")
    cfg = tb.TrainConfig(arch=ta.name, param_dtype="float32", compute_dtype="float32",
                         remat="none", dp=tb.DPConfig(algo=algo, norm_strategy=strategy,
                                                      use_kernels=kernels,
                                                      enabled=algo != "sgd"))
    return estimate_train_memory(_PORT_MODELS[name], cfg, abstract_batch(ta, B, T),
                                 costs=True)["costs"]


def _flash_recompute(ta, attn_backwards):
    """The flash backward's S = QKᵀ recompute, one a backward of a layer."""
    return collections.Counter({_key((B * ta.n_heads * T, ta.hd, T)):
                                ta.n_layers * attn_backwards})


def _attention_named(ta, attn_backwards, transposed=2):
    """(port only, reference only) attention records: the recompute, and
    dK and dV (``transposed`` of them), whose M the port's flash backward
    takes over (B·H, S) and a transposed dot over (B·KV, hd) (equal
    FLOPs): the reference's both, the port's plain attention backward (the
    autograd of its einsums) dK's alone."""
    H, KV, hd = ta.n_heads, ta.n_kv_heads, ta.hd
    n = transposed * ta.n_layers * attn_backwards
    port = _flash_recompute(ta, attn_backwards)
    port[_key((B * H * T, T, hd))] += n
    return port, collections.Counter({_key((B * KV * hd, H // KV * T, T)): n})


def _conv_named(ta, norm_pass: bool, backwards: int):
    """(port only, reference only) conv records: the padded input
    gradient against the SAME one, and the reference's patch extraction."""
    from repro_torch.models.cnn import iter_conv_sites
    port, ref = collections.Counter(), collections.Counter()
    for label, (xs, (kh, kw, cin, cout)), gy in iter_conv_sites(ta, batch=B):
        H, Ho = xs[1], gy[1]
        if norm_pass:
            ref[_key((B * Ho * Ho, kh * kw, cin * kh * kw))] += 1
        if label == "stem" or kh == 1:       # the images need no gradient
            continue
        stride = 1 if Ho == H else 2
        Hp = H + max((Ho - 1) * stride + kh - H, 0)
        ref[_key((B * H * H, kh * kw * cout, cin))] += backwards
        port[_key((B * Hp * Hp, kh * kw * cout, cin))] += backwards
    return port, ref


CELLS = [(PHI3, "sgd", "auto"), (PHI3, "dpsgd_r", "materialize"),
         (PHI3, "dpsgd_r", "gram"), (CNN, "sgd", "auto"),
         (CNN, "dpsgd_r", "materialize"), (CNN, "dpsgd_r", "gram")]


@pytest.mark.parametrize("name,algo,strategy", CELLS)
def test_step_costs_match_jaxpr_costs(name, algo, strategy):
    ta = tconfigs.reduced(tconfigs.get_arch(name))
    p, j = _port_step(name, algo, strategy), _jax_step(name, algo, strategy)
    backwards = 1 if algo == "sgd" else 2
    if ta.family == "cnn":
        port_only, ref_only = _conv_named(ta, algo != "sgd", backwards)
    else:
        port_only, ref_only = _attention_named(ta, backwards)
    P, J = _multiset(p["gemms"]), _multiset(j["gemms"])
    assert P - J == port_only and J - P == ref_only, (P - J, J - P)
    got = _flops(p) - _named_flops(port_only)
    want = _flops(j) - _named_flops(ref_only)
    assert abs(got - want) <= RTOL * want, (got, want)
    for key in ("elementwise_flops", "move_bytes"):
        assert within_tolerance(max(p[key], 1.0) / max(j[key], 1.0)), (key, p[key], j[key])


def test_dpsgd_step_flops_match_jaxpr_costs():
    """``dpsgd`` takes one ``autograd.grad`` per example where the
    reference vmaps: its records are B x (T, k, n) where the reference's
    are (B·T, k, n), by design; the FLOPs are equal once the flash
    backward's recompute (one a layer a per-example backward) is set
    aside."""
    ta = tconfigs.reduced(tconfigs.get_arch(PHI3))
    p, j = _port_step(PHI3, "dpsgd", "auto"), _jax_step(PHI3, "dpsgd", "auto")
    recompute = 2.0 * ta.n_heads * T * ta.hd * T * ta.n_layers * B
    assert abs(_flops(p) - recompute - _flops(j)) <= RTOL * _flops(j)
    assert max(m for m, *_ in p["gemms"]) < max(m for m, *_ in j["gemms"])
    for key in ("elementwise_flops", "move_bytes"):
        assert within_tolerance(p[key] / j[key]), (key, p[key], j[key])


# ---------------------------------------------------------------------------
# kernel routes
# ---------------------------------------------------------------------------

def _wrapper_calls(x, gy, w, g, c, q, k, o, lse, ids):
    return {
        "dense_bwd_norm": lambda: _fb.dense_bwd_norm(x, gy, w),
        "dense_dgrad": lambda: _fb.dense_dgrad(gy, w),
        "pegrad_norm": lambda: _pn.pegrad_norm(x, gy),
        "gram_norm": lambda: _gn.gram_norm(x, gy, ids),
        "gram_norm_embed": lambda: _gn.gram_norm(x, gy, ids, square=False),
        "clip_reduce": lambda: _cr.clip_reduce(g, c),
        "flash_attn_fwd": lambda: _fa.flash_attn_fwd(q, k, k, rep=2),
        "flash_attn_bwd": lambda: _fa.flash_attn_bwd(q, k, k, o, lse, o, rep=2),
    }


def test_wrapper_records_equal_on_fake_cuda_and_on_the_cpu():
    """A wrapper records its plain version's work whichever branch runs:
    its fake branch (fake CUDA tensors, the card's route in a trace) or its
    plain version (CPU tensors), and counts nothing it runs inside."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    bf = torch.bfloat16
    BG, Tk, di, do, S = 2, 96, 200, 136, 64
    specs = [((BG, Tk, di), bf), ((BG, Tk, do), bf), ((1, di, do), bf),
             ((3, 1000), bf), ((3,), torch.float32), ((4, Tk, 32), bf),
             ((2, S, 32), bf), ((4, Tk, 32), bf), ((4, Tk), torch.float32),
             ((BG, Tk), torch.int32)]
    records = {}
    for device in ("cuda", "cpu"):
        mode = FakeTensorMode()
        with mode:
            ts = [torch.empty(s, dtype=d, device=device) for s, d in specs]
        for name, fn in _wrapper_calls(*ts).items():
            counter = tcosts.CostCounter()
            with mode, counter:
                fn()
            records.setdefault(name, []).append(counter.costs.as_dict())
    for name, (cuda, cpu) in records.items():
        assert cuda == cpu, name
        (kernel, rec), = cuda["kernels"].items()
        assert rec["calls"] == 1 and rec["dot_flops"] == _flops(cuda) > 0
        assert cuda["move_bytes"] == rec["bytes"] > 0 and cuda["dot_bytes"] == 0
    # the embedding rule reads no x: its bytes are gy's, the ids' and the result's
    assert records["gram_norm_embed"][0]["move_bytes"] == (2 * BG * Tk * do + 4 * BG * Tk
                                                           + 4 * BG)


@pytest.mark.parametrize("strategy", ["fused", "materialize", "gram"])
def test_kernel_routes_cost_their_plain_routes_work(strategy):
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    ta = tconfigs.reduced(tconfigs.get_arch(PHI3))
    k = _port_step(PHI3, "dpsgd_r", strategy, kernels=True)
    p = _port_step(PHI3, "dpsgd_r", strategy)
    named = collections.Counter({_key((B * T, ta.d_model, T)): 1})   # the embedding Gram
    plain_only = collections.Counter()
    if strategy == "fused":       # pass 1's attention through the flash pair
        port, plain_only = _attention_named(ta, 1, transposed=1)
        named += port
    K, P = _multiset(k["gemms"]), _multiset(p["gemms"])
    assert K - P == named and P - K == plain_only, (K - P, P - K)
    assert _flops(k) == pytest.approx(
        _flops(p) + _named_flops(named) - _named_flops(plain_only), rel=RTOL)
    launches = chip_smoke.path_launches(strategy, ta.n_layers)
    assert {n: r["calls"] for n, r in k["kernels"].items()} == \
        {n: v for n, v in launches.items() if v}
