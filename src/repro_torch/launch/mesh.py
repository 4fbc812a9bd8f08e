"""Production and test meshes (counterpart of ``repro/launch/mesh.py``)
on ``torch.distributed``: one process a rank, the default process
group initialised by the caller (``torchrun``'s ``env://``, or a test's
``file://`` store).

Single pod: 16 x 16 = 256 ranks ('data', 'model'). Multi-pod: 2 x 16 x
16 = 512 ranks ('pod', 'data', 'model'); the 'pod' axis extends data
parallelism. A mesh's device type follows the default group's backend
(NCCL: "cuda"; gloo: "cpu", also when the ranks compute on a card: the
mesh only names the groups, the compute device is the caller's).

``fake_world(n)`` stands up torch's fake process group as the default
group at rank 0 of a world of n ranks, in one process: the dry run's
production mesh, whose collectives move nothing (``distributed
.collectives`` gives zeros for their results). It refuses to start
beside a real default group.
"""
from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as tdist

from repro_torch.distributed import collectives as C
from repro_torch.models.moe import DistContext


def world_size() -> int:
    """The default group's size, else ``WORLD_SIZE`` (1 outside
    torchrun)."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


@contextlib.contextmanager
def fake_world(n: int):
    """Rank 0 of a world of ``n`` ranks on torch's fake process group
    (``torch.testing._internal.distributed.fake_pg``), torn down on
    exit; the port's collectives send nothing meanwhile
    (``distributed.collectives.FAKE``). Raises when a default group is
    already up: a real job's collectives are never faked."""
    if tdist.is_initialized():
        raise RuntimeError(
            f"a default process group ({tdist.get_backend()}, world "
            f"{tdist.get_world_size()}) is already up: the dry run fakes "
            f"a world of its own and never a real job's collectives")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=n)
    C.FAKE = True
    try:
        yield
    finally:
        C.FAKE = False
        C.forget_groups()
        tdist.destroy_process_group()


def _mesh(shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    if world_size() != math.prod(shape):
        raise ValueError(f"a {' x '.join(map(str, shape))} mesh "
                         f"{axes} needs {math.prod(shape)} ranks; the world "
                         f"has {world_size()}")
    if not tdist.is_initialized():
        raise RuntimeError("initialise the default process group first "
                           "(torch.distributed.init_process_group)")
    kind = "cuda" if tdist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0):
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"))
    return _mesh((data, model), ("data", "model"))


def dist_for(mesh) -> DistContext:
    """The ``DistContext`` of ``mesh``; makes its multi-axis groups (a
    collective call: every rank calls it)."""
    axes = mesh.mesh_dim_names
    data_axes = ("pod", "data") if "pod" in axes else ("data",)
    dist = DistContext(mesh=mesh, data_axes=data_axes, model_axis="model")
    C.make_groups(dist)
    return dist


def set_mesh(mesh):
    """The reference scopes PartitionSpec resolution with the mesh; the
    port passes the ``DistContext`` explicitly, so this is a no-op
    context manager yielding the mesh."""
    return contextlib.nullcontext(mesh)


def rank_device(device=None) -> torch.device:
    """``device`` if given, else ``cuda:<LOCAL_RANK>`` (raises without
    CUDA, as every entry point of the port)."""
    from repro_torch.device import resolve_device
    if device is not None:
        return resolve_device(device)
    return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
