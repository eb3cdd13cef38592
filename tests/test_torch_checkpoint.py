"""The port's checkpoints (``repro_torch.train.checkpoint``) against the JAX
package's contracts (``tests/test_checkpoint_data.py``,
``tests/test_checkpoint_sharded.py``) and against its files: a reduced
phi3 ``TrainState`` written by one package is restored by the other, with
AdamW and with ``adam8bit``, float32 and bf16 params, every leaf compared
bit for bit (bf16 leaves by their raw bits).
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import OptimConfig as JOptimConfig
from repro.models.transformer import build_model
from repro.optim import make_optimizer as j_make_optimizer
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.state import TrainState as JTrainState
from repro_torch import interop, tree
from repro_torch.configs.base import OptimConfig
from repro_torch.optim import make_optimizer
from repro_torch.train import checkpoint as C
from repro_torch.train.checkpoint import CheckpointError, CheckpointManager
from repro_torch.train.state import TrainState


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 4, generator=g),
                       "b": torch.randn(4, generator=g).to(torch.bfloat16)},
            "q": torch.randint(-127, 128, (3, 16), generator=g).to(torch.int8),
            "step": 3}


def _zeros_like(state):
    return tree.tree_map(lambda t: torch.zeros_like(t)
                         if isinstance(t, torch.Tensor) else 0, state)


def _assert_same(a, b):
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def test_roundtrip_and_dtypes(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, use_async=False)
    st = _state()
    cm.save(st, 3)
    back = cm.restore(_zeros_like(st))
    _assert_same(st, back)
    with open(tmp_path / "step_3" / "manifest.json") as f:
        man = json.load(f)
    # leaves in jax.tree order: params/b, params/w, q, step
    assert [r["dtype"] for r in man["leaves"]] == ["bfloat16", "float32",
                                                   "int8", "int32"]
    # bf16 on disk as 2-byte raw bits, as np.load returns ml_dtypes bf16
    assert np.load(tmp_path / "step_3" / "0.0.npy").dtype == np.dtype("V2")


def test_keep_k_and_latest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, use_async=False)
    for s in (1, 2, 3, 4):
        cm.save(_state(), s)
    assert cm.steps() == [3, 4]
    assert cm.latest_step() == 4


def test_async_save_copies_before_returning(tmp_path):
    """``save`` returns once the host copy is made: the in-place update that
    follows does not reach the checkpoint being written."""
    cm = CheckpointManager(str(tmp_path), keep=3, use_async=True)
    st = _state()
    want = tree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                         else t, st)
    cm.save(st, 1)
    st["params"]["w"].add_(1.0)
    st["q"].zero_()
    cm.wait()
    assert cm.latest_step() == 1
    _assert_same(want, cm.restore(_zeros_like(st)))


def test_no_partial_checkpoints_visible(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3, use_async=False)
    cm.save(_state(), 5)
    os.makedirs(tmp_path / ".tmp_step_6")     # a crashed writer's leftovers
    assert cm.steps() == [5]


def _boom(*a, **kw):
    raise OSError(28, "No space left on device")


def test_async_write_failure_reraises(tmp_path, monkeypatch):
    cm = CheckpointManager(str(tmp_path), use_async=True)
    monkeypatch.setattr(C.np, "save", _boom)
    cm.save(_state(), step=1)
    with pytest.raises(CheckpointError, match="step 1.*NOT saved"):
        cm.wait()
    cm.wait()       # raised once, then cleared


def test_async_write_failure_reraises_from_next_save(tmp_path, monkeypatch):
    cm = CheckpointManager(str(tmp_path), use_async=True)
    orig = C.np.save
    monkeypatch.setattr(C.np, "save", _boom)
    cm.save(_state(), step=1)
    cm._thread.join()         # the failing write lands, unconsumed
    monkeypatch.setattr(C.np, "save", orig)
    with pytest.raises(CheckpointError, match="step 1"):
        cm.save(_state(), step=2)
    assert cm.steps() == []   # a failed write never shows a checkpoint


def test_orphaned_tmp_dirs_swept(tmp_path):
    cm = CheckpointManager(str(tmp_path), use_async=False)
    orphan = tmp_path / ".tmp_step_0"
    orphan.mkdir()
    (orphan / "0.0.npy").write_bytes(b"partial")
    cm.save(_state(), step=5)
    assert not orphan.exists()
    assert cm.steps() == [5]


def test_structure_drift_raises_naming_both_counts(tmp_path):
    cm = CheckpointManager(str(tmp_path), use_async=False)
    st = _state()
    cm.save(st, step=1)
    grown = dict(_zeros_like(st), extra_rider=torch.zeros(2))
    with pytest.raises(CheckpointError, match=r"4 leaves.*has 5"):
        cm.restore(grown)
    with pytest.raises(CheckpointError, match=r"4 leaves.*has 1"):
        cm.restore({"w": torch.zeros(8, 4)})
    with pytest.raises(CheckpointError, match=r"on-disk shape \(8, 4\)"):
        cm.restore(dict(_zeros_like(st), params={"b": torch.zeros(4),
                                                 "w": torch.zeros(4, 8)}))


def test_multi_shard_leaf_reassembles(tmp_path):
    """A leaf stored as 4 shard files (a 2 x 2 grid, as a mesh writes it)
    and a bf16 leaf in 2 row shards reassemble exactly."""
    full = np.arange(48, dtype=np.float32).reshape(8, 6)
    half = torch.randn(4, 3).to(torch.bfloat16)
    bits = half.view(torch.int16).numpy().view(np.dtype("V2"))
    d = tmp_path / "step_7"
    d.mkdir()
    rec = {"shape": [8, 6], "dtype": "float32", "shards": []}
    for si, (r0, r1) in enumerate([(0, 4), (4, 8)]):
        for sj, (c0, c1) in enumerate([(0, 3), (3, 6)]):
            fname = f"0.{si * 2 + sj}.npy"
            np.save(d / fname, full[r0:r1, c0:c1])
            rec["shards"].append({"file": fname, "start": [r0, c0], "stop": [r1, c1]})
    rec_b = {"shape": [4, 3], "dtype": "bfloat16", "shards": []}
    for k, (r0, r1) in enumerate([(0, 1), (1, 4)]):
        np.save(d / f"1.{k}.npy", bits[r0:r1])
        rec_b["shards"].append({"file": f"1.{k}.npy", "start": [r0, 0], "stop": [r1, 3]})
    (d / "manifest.json").write_text(json.dumps(
        {"format": "sharded-v1", "step": 7, "n_leaves": 2, "leaves": [rec, rec_b]}))
    got = CheckpointManager(str(tmp_path)).restore(
        [torch.zeros(8, 6), torch.zeros(4, 3, dtype=torch.bfloat16)])
    np.testing.assert_array_equal(got[0].numpy(), full)
    assert torch.equal(got[1], half)


def test_manifest_records_shard_bounds(tmp_path):
    cm = CheckpointManager(str(tmp_path), use_async=False)
    cm.save(_state(), step=2)
    with open(tmp_path / "step_2" / "manifest.json") as f:
        man = json.load(f)
    assert man["format"] == "sharded-v1" and man["n_leaves"] == 4
    for rec in man["leaves"]:
        (s,) = rec["shards"]
        assert s["start"] == [0] * len(rec["shape"]) and s["stop"] == rec["shape"]
        assert os.path.exists(tmp_path / "step_2" / s["file"])


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

ARCH = "phi3-mini-3.8b"


def _bits(a):
    """A leaf as comparable numpy bits: bf16 by its raw 16 bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@functools.lru_cache(maxsize=None)
def _jax_state(optim, dtype):
    """A reduced phi3 TrainState of the JAX package after one optimizer
    step on seeded gradients (so every moment and scale is nonzero)."""
    jm = build_model(jreduced(JARCHS[ARCH]), param_dtype=dtype,
                     compute_dtype=dtype, remat="none")
    params = jm.init(jax.random.PRNGKey(0))
    opt = j_make_optimizer(JOptimConfig(name=optim, lr=1e-2, block_size=64))
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape, dtype=np.float32)), params)
    params, opt_state = opt.apply(grads, opt.init(params), params, 0)
    return JTrainState(step=jnp.asarray(1, jnp.int32), params=params,
                       opt_state=opt_state)


def _port_state(jstate, optim):
    """The port's TrainState of the same structure, zeroed."""
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jstate.params),
                                       "cpu")
    for p in tree.leaves(params):
        p.zero_()
    opt = make_optimizer(OptimConfig(name=optim, block_size=64))
    return TrainState(step=0, params=params,
                      opt_state=opt.init(tree.leaves(params)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("optim", ["adamw", "adam8bit"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cross_package_restore(tmp_path, writer, optim, dtype):
    """One package writes, the other restores, every leaf bit for bit."""
    jstate = _jax_state(optim, dtype)
    tstate = _port_state(jstate, optim)
    want = [_bits(a) for a in jax.tree.leaves(jstate)]
    assert len(C.flatten(tstate)) == len(want)
    if writer == "jax":
        JCheckpointManager(str(tmp_path), use_async=False).save(jstate, 1)
        got = CheckpointManager(str(tmp_path)).restore(tstate)
        assert got.step == 1       # restored in place, into the same tensors
        assert all(a is b for a, b in zip(C.flatten(got)[1:], C.flatten(tstate)[1:]))
        got_leaves = C.flatten(got)[1:]
    else:
        # the port's leaves take the JAX state's values, then go to disk
        with torch.no_grad():
            for t, a in zip(C.flatten(tstate)[1:], jax.tree.leaves(jstate)[1:]):
                t.copy_(torch.from_numpy(np.array(_bits(a))).view(t.dtype))
        tstate.step = 1
        CheckpointManager(str(tmp_path), use_async=False).save(tstate, 1)
        like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jstate)
        back = JCheckpointManager(str(tmp_path)).restore(like)
        assert int(back.step) == 1
        got_leaves = jax.tree.leaves(back)[1:]
    for g, w in zip(got_leaves, want[1:]):
        g = _bits(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
