"""What two ranks on one card can carry: ``python -m olmoasr_tpu_torch.perf.probe_ranks``.

The card's machine has one GPU, so multi-rank training there runs two ranks
on ``cuda:0`` (``chip_smoke.phase_training_distributed``). This probe starts
two such ranks under torchrun for each backend, ``nccl`` and ``gloo``, and
tries, each in its own torchrun so that a crash ends only its own stage:

- ``c10d``: ``all_reduce``, ``all_gather_into_tensor`` and
  ``reduce_scatter_tensor`` of CUDA tensors;
- ``ddp``: a forward and backward of a ``DistributedDataParallel`` layer;
- ``fsdp2``: ``fully_shard`` over a 1-D mesh, a forward, backward and AdamW
  step;
- ``full_tensor``: the same, then ``DTensor.full_tensor()`` of every
  parameter (DTensor's functional collectives, which the checkpoint's
  full-state gather uses).

Prints the torch, CUDA and NCCL versions, then per backend and stage
``ok`` or the exit code and the error's last lines. Needs one CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

STAGES = ("c10d", "ddp", "fsdp2", "full_tensor")


def _rank(backend: str, stage: str) -> None:
    """One rank: the stage on ``cuda:0``; prints ``RANK r ok`` and what it
    computed."""
    import torch.distributed as dist
    from torch import nn

    torch.cuda.set_device(0)
    dist.init_process_group(backend)
    rank = dist.get_rank()
    out = {}
    try:
        if stage == "c10d":
            t = torch.ones(4, device="cuda:0") * (rank + 1)
            dist.all_reduce(t)
            gathered = torch.empty(8, device="cuda:0")
            dist.all_gather_into_tensor(gathered, torch.ones(4, device="cuda:0") * (rank + 1))
            scattered = torch.empty(2, device="cuda:0")
            dist.reduce_scatter_tensor(scattered, torch.ones(4, device="cuda:0") * (rank + 1))
            out = {"all_reduce": t.tolist(), "all_gather": gathered.tolist(),
                   "reduce_scatter": scattered.tolist()}
        elif stage == "ddp":
            layer = nn.parallel.DistributedDataParallel(nn.Linear(64, 64).cuda(), device_ids=[0])
            layer(torch.randn(8, 64, device="cuda:0")).sum().backward()
            out = {"grad_sum": float(layer.module.weight.grad.sum())}
        else:
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.fsdp import fully_shard

            mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("fsdp",))
            model = nn.Sequential(nn.Linear(64, 128), nn.GELU(), nn.Linear(128, 64)).cuda()
            for layer in (model[0], model[2]):
                fully_shard(layer, mesh=mesh)
            fully_shard(model, mesh=mesh)
            opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
            model(torch.randn(8, 64, device="cuda:0")).square().sum().backward()
            opt.step()
            torch.cuda.synchronize()
            out = {"local_sum": float(sum(p.to_local().sum() for p in model.parameters()))}
            if stage == "full_tensor":
                out["full_sum"] = float(sum(p.full_tensor().sum() for p in model.parameters()))
        dist.barrier()
        print(f"RANK {rank} ok {json.dumps(out)}", flush=True)
    finally:
        dist.destroy_process_group()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("probe_ranks: no CUDA device")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nccl "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (root, env.get("PYTHONPATH"))))
    for backend in ("nccl", "gloo"):
        for stage in STAGES:
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node=2", "-m", "olmoasr_tpu_torch.perf.probe_ranks", backend,
                 stage], capture_output=True, text=True, timeout=300, env=env)
            ok = [line for line in proc.stdout.splitlines() if line.startswith("RANK")]
            if proc.returncode == 0:
                print(f"{backend} {stage}: ok; " + "; ".join(ok))
                continue
            lines = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
                     if ("Error" in line or "Signal" in line or "Duplicate" in line)
                     and "ChildFailedError" not in line]
            print(f"{backend} {stage}: exit {proc.returncode}; "
                  + " | ".join(list(dict.fromkeys(lines))[:4]))


if __name__ == "__main__":
    if len(sys.argv) == 3:
        _rank(*sys.argv[1:])
    else:
        main()
