"""Production mesh construction (after ``repro.launch.mesh``).

The reference targets TPU v5e-class pods: one pod is 256 chips as a
``(data=16, model=16)`` mesh, and the multi-pod configuration stacks a
leading ``pod`` axis (2 pods = 512 chips) whose traffic crosses the slower
inter-pod links.  Here a mesh is a ``torch.distributed`` DeviceMesh over the
ranks of the default process group, one GPU a rank (``device_type="cuda"``,
NCCL) unless the caller asks for ``"cpu"`` (gloo), as the tests do.

Defined as functions: importing this module starts no process group.  A
DeviceMesh needs one, so the caller starts it first
(``torch.distributed.init_process_group`` with its address, world size and
rank); the world must hold exactly the mesh's ranks.
"""
from __future__ import annotations

import math

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    """A DeviceMesh of ``shape`` with dims ``names`` over ranks 0 ..
    prod(shape) - 1 in row-major order (the counterpart of
    ``compat_make_mesh``)."""
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in length")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = MULTI_POD if multi_pod else SINGLE_POD
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, names, device_type)


def make_mesh_named(name: str, device_type: str = "cuda") -> DeviceMesh:
    if name == "single":
        return make_production_mesh(multi_pod=False, device_type=device_type)
    if name == "multi":
        return make_production_mesh(multi_pod=True, device_type=device_type)
    raise ValueError(f"unknown mesh {name!r} (want single|multi)")


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0,
                   device_type: str = "cuda") -> DeviceMesh:
    """A small mesh for tests: (data, model), or (pod, data, model)."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"), device_type)
    return make_mesh((data, model), ("data", "model"), device_type)


def device_count_required(name: str) -> int:
    return math.prod(MULTI_POD if name == "multi" else SINGLE_POD)
