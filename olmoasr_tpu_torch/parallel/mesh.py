"""The process group and the (data, fsdp) device mesh of multi-rank training.

Counterpart of ``olmoasr_tpu/parallel/mesh.py`` over ``torch.distributed``.
The JAX package lays its devices out as a ``Mesh`` with a ``data`` axis (data
parallelism, the reference's DDP) and an ``fsdp`` axis (parameter and
optimizer-state sharding, the reference's FSDP); this module builds the same
layout as a ``DeviceMesh`` over the ranks of the process group, which
``training.train.shard_train_state`` hands to DDP or FSDP2, and over which
``decoding.set_infer_mesh`` splits a decode batch (``shard_ranks``,
``shard_index``); ``control_group`` carries the server's messages across
ranks (``serve.follow``). The JAX
package's ``param_spec`` / ``param_shardings`` pick TPU layouts and are not
ported: FSDP2 shards dim 0 of every parameter, which computes the same
numbers.

The process group is joined from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), the
counterpart of the JAX launcher's ``jax.distributed.initialize()``: ``nccl``
for ``cuda`` devices, ``gloo`` for the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"


def launched() -> bool:
    """Whether this process was started by torchrun (or another launcher
    that sets its environment)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


# what torchrun sets in each rank's environment (and TORCHELASTIC_*): a child
# process that inherits it would join the launcher's group
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK",
                "GROUP_WORLD_SIZE", "ROLE_RANK", "ROLE_NAME", "ROLE_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")


def without_launcher_env(env) -> dict:
    """A copy of ``env`` without torchrun's variables, for a child process
    that must run on its own."""
    return {k: v for k, v in env.items()
            if k not in LAUNCHER_ENV and not k.startswith("TORCHELASTIC_")}


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


# how long a rank waits for a control message: as long as a server may sit idle
CONTROL_TIMEOUT = datetime.timedelta(days=365)


def control_group():
    """A ``gloo`` group over every rank for messages a rank may wait on for
    as long as the sender is idle (the server's batches and its stop): its
    own group, so that an NCCL watchdog never aborts that wait, with a
    timeout of CONTROL_TIMEOUT. Every rank calls it, in the same order as
    its other group calls."""
    return dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)


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


def shard_ranks(mesh) -> List[int]:
    """The ranks of ``mesh`` in the order of the shards a batch split over
    every axis of it gets: its rank grid flattened in row-major order, as
    ``shard_map``'s ``P(axes)`` places the blocks of a batch over a JAX
    mesh. Shard ``i`` holds rows ``[i * B / n, (i + 1) * B / n)``."""
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def shard_count(mesh) -> int:
    """The number of shards ``mesh`` splits a batch into: its rank count."""
    return mesh.mesh.numel()


def shard_index(mesh) -> int:
    """This rank's shard of a batch split over every axis of ``mesh``: its
    coordinates on the mesh's axes read in row-major order (the JAX
    package's ``idx = idx * size + axis_index(axis)`` over the axes)."""
    coordinate = mesh.get_coordinate()
    if coordinate is None:
        raise ValueError(f"rank {rank()} is not in the mesh {shard_ranks(mesh)}")
    index = 0
    for c, size in zip(coordinate, mesh.mesh.shape):
        index = index * size + c
    return index
