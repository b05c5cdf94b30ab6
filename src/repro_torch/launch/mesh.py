"""The cooperative process group (port of ``repro.launch.mesh.make_coop_mesh``).

JAX runs the PEs as one controller over a 1-D device mesh; the port runs
one process per PE in a ``torch.distributed`` process group, which the
caller starts (``torchrun --nproc-per-node=P``, or ``init_process_group``
with a rank and world size of its own).  The backend is the caller's
choice, made when the group is started: ``"nccl"`` for one rank per
card, ``"gloo"`` on the CPU (or for CUDA tensors staged through host
memory).  Nothing here starts or picks one.
"""
from __future__ import annotations

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
