"""Device meshes over the process group.  Counterpart of
``repro/launch/mesh.py``: functions, so importing this module touches no
process group.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the world of
the default process group (one rank a device); its device type follows the
group's backend (``cuda`` under NCCL, ``cpu`` under gloo, which also
carries CUDA tensors, staged through the host: dist/runtime.py).  Like
``jax.make_mesh``, a shape whose product is not the world size raises.
"""
from __future__ import annotations

import math

import torch.distributed as dist


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
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh():
    """One ``data`` axis over the whole world."""
    return make_mesh((dist.get_world_size(),), ("data",))
