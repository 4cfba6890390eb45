"""Production meshes (the JAX package's ``launch/mesh.py``).

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the ``pod`` axis is
data-parallel (the gradient all-reduce crosses it).

A mesh stands on a ``fake`` process group of its size, in which this
process is rank 0 and every collective returns at once without moving
data: the counterpart of the JAX package's
``xla_force_host_platform_device_count=512``, which lets one host lower
the sharded program of a 512-chip mesh.  What runs on such a mesh is
rank 0's partition; its collectives are placeholders.

``make_production_mesh`` and ``make_mesh`` are FUNCTIONS, so importing
this module touches no process-group state.  Moving to a mesh of
another size destroys the fake group and starts a new one; a real
(non-fake) group already in place is never replaced.  The mesh's device
type is ``cuda`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import math
from typing import Sequence

from ..utils import resolve_device

__all__ = ["make_production_mesh", "make_mesh", "release_mesh",
           "SINGLE_POD_DEVICES", "MULTI_POD_DEVICES"]

SINGLE_POD_DEVICES = 256
MULTI_POD_DEVICES = 512


def _fake_group(world: int) -> None:
    """A ``fake`` default process group of ``world`` ranks, this process
    rank 0 (the one in place when it already has that size)."""
    import torch.distributed as dist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group is in place; a "
                f"production mesh needs the fake group of its own size")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake group of
    its size, on the card (``device="cpu"`` for the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    _fake_group(math.prod(shape))
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def release_mesh() -> None:
    """End the fake process group a mesh stood on (no-op without one)."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()
