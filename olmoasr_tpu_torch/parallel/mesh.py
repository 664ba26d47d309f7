"""The process group and the (data, fsdp) device mesh of multi-rank training.

Counterpart of ``olmoasr_tpu/parallel/mesh.py`` over ``torch.distributed``.
The JAX package lays its devices out as a ``Mesh`` with a ``data`` axis (data
parallelism, the reference's DDP) and an ``fsdp`` axis (parameter and
optimizer-state sharding, the reference's FSDP); this module builds the same
layout as a ``DeviceMesh`` over the ranks of the process group, which
``training.train.shard_train_state`` hands to DDP or FSDP2. The JAX
package's ``param_spec`` / ``param_shardings`` pick TPU layouts and are not
ported: FSDP2 shards dim 0 of every parameter, which computes the same
numbers.

The process group is joined from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), the
counterpart of the JAX launcher's ``jax.distributed.initialize()``: ``nccl``
for ``cuda`` devices, ``gloo`` for the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"


def launched() -> bool:
    """Whether this process was started by torchrun (or another launcher
    that sets its environment)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank() -> int:
    """This process's rank (``jax.process_index()``); 0 outside a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of ranks (``jax.process_count()``); 1 outside a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device) -> torch.device:
    """The device of this rank: a bare ``cuda`` becomes
    ``cuda:{LOCAL_RANK}``; any other device (``cpu``, ``cuda:0``) stays as
    the caller named it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def init_distributed(device) -> bool:
    """Join the process group from torchrun's environment, with ``nccl`` for
    a ``cuda`` device and ``gloo`` for the CPU. Returns True if this call
    created the group, False if a group already existed or the process was
    not launched by torchrun (one process, no group)."""
    if dist.is_initialized() or not launched():
        return False
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def make_mesh(n_data: Optional[int] = None, n_fsdp: int = 1, *, device_type: str = "cuda"):
    """A (data, fsdp) ``DeviceMesh`` over every rank of the process group,
    rank ``i * n_fsdp + j`` at (i, j), as the JAX ``make_mesh`` reshapes its
    devices. ``n_data`` defaults to the world size over ``n_fsdp``."""
    from torch.distributed.device_mesh import init_device_mesh

    world = world_size()
    if n_data is None:
        n_data = world // n_fsdp
    if n_data * n_fsdp != world:
        raise ValueError(f"mesh {n_data}x{n_fsdp} != {world} ranks")
    return init_device_mesh(device_type, (n_data, n_fsdp), mesh_dim_names=(DATA_AXIS, FSDP_AXIS))
