"""Checkpoints of the port.  Counterpart of ``repro/train/checkpoint.py``,
in the same ``sharded-v1`` layout, so each package restores the other's::

    <dir>/step_<k>/manifest.json
    <dir>/step_<k>/<leaf>.<shard>.npy

Leaves are in the JAX package's flattening order: a ``TrainState`` is its
step (an int32 scalar), then ``tree.leaves(params)``, then
``tree.leaves(opt_state)``; any other tree is ``tree.leaves`` of it.  Under
adaptive clipping the optimizer state is ``{"opt": ..., "clip":
{"clip_norm": C}}`` in both packages, so C, a float32 scalar, is the first
of its leaves (dict keys sorted, as ``jax.tree`` orders them).  The
port runs one process, so it writes one shard file per leaf; the reader
takes the multi-shard manifests the JAX package writes on a mesh and
reassembles each leaf from its shards.

bf16 leaves go to disk as their raw bits in a 2-byte void dtype, with the
manifest dtype ``"bfloat16"``, which is how ``np.load`` returns the JAX
package's ml_dtypes bf16 files and what its reader reinterprets bit for
bit (never ``uint16``, which it would convert by value).

Contracts as there: a save writes ``.tmp_step_<k>`` and renames it to
``step_<k>`` with ``os.replace``, so an interrupted save never shows a
partial checkpoint; the last ``keep`` are kept and orphaned tmp directories
swept; the disk write runs on a thread, and its failure is raised again
from the next ``wait()`` or ``save()`` as ``CheckpointError``.  ``save``
returns once the host copy of every leaf is made: the port's optimizer
updates params and state in place, so the next step may run while the
write goes on.  ``restore`` copies into the tensors of the tree it is
given, in place, converting by value where the types differ.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.train.state import TrainState

FORMAT = "sharded-v1"
_BF16_DISK = np.dtype("V2")


class CheckpointError(RuntimeError):
    """A checkpoint write or restore failed (possibly asynchronously)."""


def flatten(state) -> List[Any]:
    """The leaves of a ``TrainState`` (step first) or of any tree, in the
    JAX package's order."""
    if isinstance(state, TrainState):
        return ([state.step] + tree.leaves(state.params)
                + tree.leaves(state.opt_state))
    return tree.leaves(state)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf (a tensor, or the step as an int) and its
    manifest dtype."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(int(leaf), np.int32), "int32"
    h = leaf.detach().to("cpu", copy=True)
    if h.dtype == torch.bfloat16:
        return h.view(torch.int16).numpy().view(_BF16_DISK), "bfloat16"
    h = h.numpy()
    return h, str(h.dtype)


def _to_torch(h: np.ndarray, dtype: str) -> torch.Tensor:
    """A host array read from disk as a tensor of its manifest dtype; bf16
    bits (2-byte void records) are reinterpreted, not converted.  A 0-d
    leaf stays 0-d (``np.ascontiguousarray`` returns at least 1-d)."""
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(h).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(h.astype(np.dtype(dtype),
                                                           copy=False)))
    return t.reshape(h.shape)


def _read_leaf(directory: str, rec: dict) -> np.ndarray:
    """The whole leaf, reassembled from its shard files."""
    shape = tuple(rec["shape"])
    shards = rec["shards"]

    def load(fname):
        path = os.path.join(directory, fname)
        if not os.path.exists(path):
            raise CheckpointError(f"checkpoint shard file missing: {path} "
                                  f"(incomplete multi-process save?)")
        return np.load(path, mmap_mode="c")

    if len(shards) == 1 and list(shards[0]["start"]) == [0] * len(shape) \
            and tuple(shards[0]["stop"]) == shape:
        return load(shards[0]["file"])
    out = None
    for sm in shards:
        data = load(sm["file"])
        if out is None:
            out = np.empty(shape, dtype=data.dtype)
        out[tuple(slice(a, b) for a, b in zip(sm["start"], sm["stop"]))] = data
    return out


def _rebuild(like, values):
    """``like``'s structure with its leaves taken in order from ``values``
    (an iterator)."""
    if isinstance(like, TrainState):
        step = next(values)
        return TrainState(step=step, params=_rebuild(like.params, values),
                          opt_state=_rebuild(like.opt_state, values))
    if isinstance(like, dict):
        return {k: _rebuild(like[k], values) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(v, values) for v in like]
        return tuple(out) if isinstance(like, tuple) else out
    if like is None:
        return None
    return next(values)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, use_async: bool = True):
        self.dir = directory
        self.keep = keep
        self.use_async = use_async
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Tuple[int, BaseException]] = None
        self.write_seconds: Optional[float] = None   # the last good write's
        os.makedirs(directory, exist_ok=True)

    # -- save -------------------------------------------------------------
    def save(self, state, step: int, extra: Optional[dict] = None) -> None:
        """Host-copy every leaf of ``state``, then write them (on a thread
        when ``use_async``).  The caller may change ``state`` once this
        returns."""
        self.wait()   # serializes writes AND re-raises a pending failure
        payload, leaf_recs = [], []
        for i, leaf in enumerate(flatten(state)):
            h, dtype = _host(leaf)
            fname = f"{i}.0.npy"
            payload.append((fname, h))
            leaf_recs.append({"shape": list(h.shape), "dtype": dtype,
                              "shards": [{"file": fname, "start": [0] * h.ndim,
                                          "stop": list(h.shape)}]})
        manifest = {"format": FORMAT, "step": step, "n_leaves": len(leaf_recs),
                    "time": time.time(), "leaves": leaf_recs, **(extra or {})}
        if self.use_async:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(payload, manifest, step),
                daemon=True)
            self._thread.start()
        else:
            self._write_guarded(payload, manifest, step)
            self.wait()

    def _write_guarded(self, payload, manifest, step: int) -> None:
        """``_write`` with the exception kept for ``wait()``: a thread's
        traceback is otherwise lost and the checkpoint taken as written."""
        t0 = time.perf_counter()
        try:
            self._write(payload, manifest, step)
            self.write_seconds = time.perf_counter() - t0
        except BaseException as e:    # noqa: BLE001 — re-raised from wait()
            self._error = (step, e)

    def _write(self, payload, manifest, step: int) -> None:
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for fname, arr in payload:
            np.save(os.path.join(tmp, fname), arr)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._gc()

    def wait(self) -> None:
        """Block until the write in flight (if any) ends; raise if it, or
        an earlier one, failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            (step, err), self._error = self._error, None
            raise CheckpointError(
                f"async checkpoint write for step {step} failed; the "
                f"checkpoint was NOT saved") from err

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
        # an interrupted save leaves its .tmp_step_* behind; ours was renamed
        for name in os.listdir(self.dir):
            if name.startswith(".tmp_step_"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name.split("_", 1)[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like, step: Optional[int] = None):
        """Restore checkpoint ``step`` (default the latest) into ``like``: a
        ``TrainState`` or tree whose tensor leaves receive the values in
        place.  Returns ``like``'s structure with those tensors and the
        step (an int leaf) as read."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = flatten(like)
        n_disk = int(manifest["n_leaves"])
        if n_disk != len(leaves):
            raise CheckpointError(
                f"checkpoint structure drift: {d} holds {n_disk} leaves but "
                f"the target tree has {len(leaves)} — the train-state "
                f"structure changed since this checkpoint was written (e.g. "
                f"another optimizer); restore with the writing config or "
                f"discard the checkpoint")
        out = []
        for i, (leaf, rec) in enumerate(zip(leaves, manifest["leaves"])):
            shape = tuple(rec["shape"])
            want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
            if shape != want:
                raise CheckpointError(
                    f"checkpoint leaf {i}: on-disk shape {shape} != target "
                    f"shape {want} (dtype on disk: {rec['dtype']})")
            src = _to_torch(_read_leaf(d, rec), rec["dtype"])
            if isinstance(leaf, torch.Tensor):
                with torch.no_grad():
                    leaf.copy_(src)
                out.append(leaf)
            else:
                out.append(int(src.item()))
        return _rebuild(like, iter(out))
