"""Device meshes over the process group.  Counterpart of
``repro/launch/mesh.py``: functions, so importing this module touches no
process group.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the world of
the default process group (one rank a device); its device type follows the
group's backend (``cuda`` under NCCL, ``cpu`` under gloo, which also
carries CUDA tensors, staged through the host: dist/runtime.py).  Like
``jax.make_mesh``, a shape whose product is not the world size raises.

A traced mesh (``traced_mesh``) is the axis names and sizes alone, with no
process group: the mesh of a fake-tensor trace of one rank's program
(launch/costs.py ``traced_rank``, launch/dryrun.py), on which
``dist/runtime.py``'s layout runs its collectives as ``TracedGroup``s,
recorded and not run.  The reference's dry-run builds its production
meshes over 512 fake devices; the port traces rank 0 of them.
"""
from __future__ import annotations

import math
import types

import torch.distributed as dist

# the production meshes: one pod of 16 x 16 devices, and two pods
PRODUCTION = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape, axes):
    """A mesh of ``shape`` with axes named ``axes`` over the world."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} ({math.prod(shape)} devices) "
                         f"does not match the {world} processes of the world")
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (16, 16) = 256 devices, axes (data, model).  Multi-pod:
    (2, 16, 16) = 512 devices, axes (pod, data, model)."""
    return make_mesh(*PRODUCTION["multi" if multi_pod else "single"])


def traced_mesh(shape, axes):
    """A mesh of ``shape`` with axes named ``axes`` and no process group
    (``axis_names``, ``shape`` and ``size``): the mesh of a trace of one
    rank's program, of any shape, whatever the world."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    return types.SimpleNamespace(axis_names=axes, shape=shape,
                                 size=math.prod(shape))



def make_host_mesh():
    """One ``data`` axis over the whole world."""
    return make_mesh((dist.get_world_size(),), ("data",))
