"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` source compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so <name>.cu

The library's file name carries a hash of its source and of every shared
header (``csrc/*.cuh``), so an edited source or header rebuilds at its next
use and an unchanged one is loaded as built.  Sources
build in parallel, one ``nvcc`` each.  A failed build raises with the
compiler's output; a successful one keeps it beside the library
(``ptxas_log``: registers and spills per kernel).

``counted(plain)`` decorates each kernel wrapper: while a cost trace runs
(``launch/costs.py``), the call records the work of ``plain``, the
function the kernel computes, whichever branch the wrapper takes.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
# <repo>/build/repro_torch_kernels: <repo>/src/repro_torch/kernels/build.py
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}     # loaded once per process
# the active cost counters (launch/costs.py ``CostCounter``), innermost last
COST_SINKS: list = []


def counted(plain):
    """Decorator of a kernel wrapper: inside a cost trace, a call records
    ``plain(*args, **kwargs)``'s work (its plain version, taking the
    wrapper's arguments) with the innermost ``CostCounter``, and nothing
    the wrapper runs inside is counted again.  Outside one, the wrapper
    runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not COST_SINKS:
                return fn(*args, **kwargs)
            with COST_SINKS[-1].kernel(fn.__name__, plain, args, kwargs):
                return fn(*args, **kwargs)
        return wrapper
    return wrap


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor: ``launch/memory.py``'s trace of a
    step, shapes and dtypes on a device and no data.  A wrapper given one
    makes every allocation its launch makes, launches nothing and counts
    nothing."""
    from torch._subclasses.fake_tensor import is_fake as _is_fake
    return _is_fake(t)


def on_device(t):
    """The device context of a wrapper's launch on ``t``'s card; none for
    a fake tensor, which needs no card."""
    import torch
    return contextlib.nullcontext() if is_fake(t) else torch.cuda.device(t.device)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("repro_torch: nvcc not found (PATH, CUDA_HOME); the "
                       "CUDA kernels cannot be built")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: List[str] = None) -> Dict[str, str]:
    """Compile every named source (default: all) whose library is missing,
    all ``nvcc`` processes at once.  Returns name -> compiler output
    (``-Xptxas -v``: registers, spills) for each source compiled now."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: _target(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    procs, logs = {}, {}
    try:
        for n in todo:
            tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp)
        failed = []
        for n, (p, tmp) in procs.items():
            logs[n] = p.communicate()[0]
            if p.returncode != 0:
                failed.append(f"--- {n}.cu (nvcc exit {p.returncode})\n{logs[n]}")
            else:
                out[n].with_suffix(".log").write_text(logs[n])
                os.replace(tmp, out[n])   # atomic: a reader never sees half a file
    finally:
        for p, tmp in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("repro_torch kernel build failed:\n"
                           + "\n".join(failed))
    return logs


def ptxas_log(name: str) -> str:
    """The compiler output (``-Xptxas -v``) kept beside ``csrc/<name>.cu``'s
    library when it was built, "" if that build kept none."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
