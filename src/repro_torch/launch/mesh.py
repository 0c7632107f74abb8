"""Mesh construction (the JAX package's ``launch/mesh.py``) over the
process group that is up: ``nccl`` on cards, ``gloo`` on the CPU, or a
``fake`` group of 256/512 ranks that traces one rank of the production
mesh. Each is a function, so importing this module touches no device
and no group."""

from __future__ import annotations

import torch.distributed as dist


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


_MESHES: dict = {}


def make_mesh(shape: tuple, axes: tuple):
    """A DeviceMesh of ``shape`` named ``axes`` over the world group
    (whose size must be the product of ``shape``), made once a group: a
    mesh freed while another over the same ranks is in use can stall
    that one's next collective (each rank frees it at its own time), so
    every mesh lives as long as its group."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.group.WORLD
    key = (id(world), tuple(shape), tuple(axes))
    if key not in _MESHES or _MESHES[key][0] is not world:
        _MESHES[key] = (world, init_device_mesh(
            _device_type(), tuple(shape), mesh_dim_names=tuple(axes)))
    return _MESHES[key][1]


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0):
    """A small mesh for the CPU rehearsal (gloo ranks)."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"))
    return make_mesh((data, model), ("data", "model"))


def mesh_chips(mesh) -> int:
    return mesh.size()


def mesh_label(mesh) -> str:
    return "x".join(str(mesh.size(i))
                    for i in range(len(mesh.mesh_dim_names)))
