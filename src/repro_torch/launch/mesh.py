"""Meshes and process groups; port of ``repro.launch.mesh``.

The cooperative process group (``make_coop_mesh``'s counterpart):

JAX runs the PEs as one controller over a 1-D device mesh; the port runs
one process per PE in a ``torch.distributed`` process group, which the
caller starts (``torchrun --nproc-per-node=P``, or ``init_process_group``
with a rank and world size of its own).  The backend is the caller's
choice, made when the group is started: ``"nccl"`` for one rank per
card, ``"gloo"`` on the CPU (or for CUDA tensors staged through host
memory).  Nothing here starts or picks one.

The production meshes (:func:`make_production_mesh`,
:func:`make_host_mesh`) are ``DeviceMesh``es over the default process
group, which must hold one rank a mesh device.  The dry-run
(``repro_torch.launch.dryrun``) sizes 256 and 512-device meshes with no
such cluster: :func:`fake_process_group` starts PyTorch's fake backend,
whose collectives move nothing, for its trace and tears it down after.
A real run never uses it.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: the CPU if asked for, else
    ``cuda:{LOCAL_RANK % device_count}`` (``LOCAL_RANK`` as torchrun sets
    it, the global rank without it), so ranks share the cards in turn."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_coop_group(num_pes: int, backend: Optional[str] = None, device: DeviceLike = None):
    """``(group, device)`` for cooperative execution with one PE per rank.

    The default process group must be running with ``num_pes`` ranks;
    ``backend``, if given, must be the one it was started with (``None``
    accepts the caller's choice at ``init_process_group``).  NCCL needs a
    CUDA device.  Raises ``ValueError`` naming the launch command otherwise,
    as ``make_coop_mesh`` names the forced host device count.
    """
    hint = (f"start one process per PE, e.g. torchrun --nproc-per-node={num_pes} "
            f"(or torch.distributed.init_process_group with world_size={num_pes})")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"cooperative shard execution needs num_pes={num_pes} ranks, but no "
            f"torch.distributed process group is running; {hint}"
        )
    world = dist.get_world_size()
    if world != num_pes:
        raise ValueError(
            f"cooperative shard execution needs num_pes={num_pes} ranks, but the "
            f"process group has {world}; {hint}"
        )
    have = dist.get_backend()
    if backend is not None and backend != have:
        raise ValueError(f"the process group runs {have!r}, not the requested {backend!r}")
    if have not in BACKENDS:
        raise ValueError(f"backend {have!r} is not one of {BACKENDS}")
    dev = rank_device(device)
    if have == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend exchanges CUDA tensors; use gloo with device='cpu'")
    return dist.group.WORLD, dev


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 single-pod (256 devices) or 2x16x16 two-pod (512 devices) mesh.

    Dims: ``data`` carries the batch (and is the PE axis for the paper's
    cooperative minibatching), ``model`` carries tensor parallelism,
    ``pod`` is the outer data-parallel dim across fast-interconnect
    islands (the paper's cooperation domain is one such island).  The
    default process group must have 256 (512) ranks.
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(num_devices: Optional[int] = None, axis: str = "data",
                   device_type: str = "cuda"):
    """1-D mesh over the default process group's ranks (tests, one host)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = num_devices or dist.get_world_size()
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh dims that shard the batch dimension."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0):
    """Run the body as ``rank`` of a ``world_size``-rank process group on
    PyTorch's fake backend (``FakeStore``): collectives return at once and
    move nothing, which is all a trace of shapes needs.  Raises if a
    process group is already running; destroys the fake one on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already running; the fake group "
                           "is for a dry-run in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
