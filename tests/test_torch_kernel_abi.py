"""Every C entry point of the port's CUDA sources against the ctypes
signature its Python wrapper declares.

A wrapper binds an entry point with ``build.load("<source>").<entry>`` and
sets ``argtypes``/``restype`` by hand; a mismatch (an int passed where the
C function takes a pointer, a missing argument) compiles, loads and then
crashes or corrupts memory on the card, and shows nowhere else.  Here
``build.load`` is replaced by a stand-in that records what each wrapper
sets, and that is held to the C signature parsed from ``csrc/*.cu``:
pointer <-> ``c_void_p``, ``int`` <-> ``c_int``, ``long long`` <->
``c_longlong``.  Runs on the CPU: nothing is compiled or launched.
"""
import ctypes
import importlib
import inspect
import re

import pytest

from repro_torch.kernels import build

C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong}


def _ctype(param: str):
    decl = " ".join(param.replace("const ", "").split())
    if "*" in decl:
        return ctypes.c_void_p
    return C_TYPES[decl.rsplit(" ", 1)[0]]


def c_entry_points():
    """entry point -> (source stem, return ctype, [argument ctypes])."""
    out = {}
    for f in sorted(build.CSRC.glob("*.cu")):
        for ret, name, params in re.findall(r'extern "C"\s+([\w ]+?)\s+(\w+)\s*\(([^)]*)\)',
                                            f.read_text()):
            out[name] = (f.stem, C_TYPES[ret],
                         [_ctype(p) for p in params.split(",") if p.strip()])
    return out


def wrapper_bindings():
    """(module, function, source stem, entry point) for every function of
    the kernels package that binds an entry point."""
    out = []
    for f in sorted(build.CSRC.parent.glob("*.py")):
        mod = importlib.import_module(f"repro_torch.kernels.{f.stem}")
        for fname, fn in inspect.getmembers(mod, inspect.isfunction):
            if fn.__module__ != mod.__name__:
                continue
            for lib, entry in re.findall(r'build\.load\("(\w+)"\)\.(\w+)',
                                         inspect.getsource(fn)):
                out.append((f.stem, fname, lib, entry))
    return out


ENTRY_POINTS = c_entry_points()
BINDINGS = wrapper_bindings()


class _Fn:
    argtypes = None
    restype = None


class _Lib:
    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, _Fn())


def test_sources_and_wrappers_were_found():
    assert len(ENTRY_POINTS) >= 9 and len(BINDINGS) >= 9
    assert {"repro_dense_dgrad_path", "repro_flash_attn_fwd_path",
            "repro_flash_attn_bwd_path", "repro_gram_norm_path",
            "repro_pegrad_norm_path"} <= set(ENTRY_POINTS)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_every_entry_point_has_one_wrapper(entry):
    src = ENTRY_POINTS[entry][0]
    found = [b for b in BINDINGS if b[3] == entry]
    assert len(found) == 1, (entry, found)
    assert found[0][2] == src, (entry, found[0], src)


@pytest.mark.parametrize("binding", BINDINGS, ids=lambda b: f"{b[0]}.{b[1]}")
def test_wrapper_argtypes_match_the_c_signature(monkeypatch, binding):
    module, fname, lib, entry = binding
    assert entry in ENTRY_POINTS, f"{module}.{fname} binds a missing {lib}.{entry}"
    libs = {}
    monkeypatch.setattr(build, "load", lambda name: libs.setdefault(name, _Lib()))
    fn = getattr(importlib.import_module(f"repro_torch.kernels.{module}"), fname)()
    assert fn is libs[lib].fns[entry]
    _, ret, args = ENTRY_POINTS[entry]
    assert list(fn.argtypes) == args, (entry, fn.argtypes, args)
    assert fn.restype is ret
