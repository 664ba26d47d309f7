"""One rank of the multi-rank training tests (``tests/test_torch_distributed.py``).

Under torchrun, ``tests/torch_dist_worker.py loop JSON`` calls
``train_loop.main(**JSON)`` with ``variant`` the ``ModelDimensions`` of
JSON's ``dims`` (the CLI takes only a variant's name).

Run as ``python tests/torch_dist_worker.py JOB RANK WORLD INIT_FILE``: joins a
``gloo`` process group through the ``file://`` rendezvous ``INIT_FILE``, then
for each run of the job builds the port's model from the job's state dict,
spreads it over a (world / fsdp_size, fsdp_size) mesh with
``train.shard_train_state`` and takes the job's steps, each on this rank's
rows of the global batch (rank r holds rows r * m to (r + 1) * m of each
micro-batch, as the JAX package's batch sharding places them). Rank 0 writes
every run's metrics, gathered parameters and last gradients to ``JOB.out``. Imports
torch and the port only, never JAX.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import torch
import torch.distributed as dist

from olmoasr_tpu_torch.models import whisper as model_mod
from olmoasr_tpu_torch.models.dims import ModelDimensions
from olmoasr_tpu_torch.parallel import mesh as mesh_mod
from olmoasr_tpu_torch.training import checkpoint as ckpt_mod
from olmoasr_tpu_torch.training import train as train_mod


def run(job: dict, rank: int, world: int) -> dict:
    dims = ModelDimensions(**job["dims"])
    config = train_mod.TrainConfig(**job["config"], compute_dtype=torch.float32)
    out = {}
    for name, fsdp_size, zero2, attention in job["runs"]:
        cfg = dataclasses.replace(config, attention=attention)
        model = model_mod.empty_model(dims, include_padding_token=True)
        model.load_state_dict(job["state_dict"])
        model.train()
        state = train_mod.TrainState(model, train_mod.make_optimizer(cfg, model.parameters()))
        mesh = mesh_mod.make_mesh(world // fsdp_size, fsdp_size, device_type="cpu")
        state = train_mod.shard_train_state(state, mesh, cfg, zero2=zero2)
        step = train_mod.make_train_step(dims, cfg, mesh)
        metrics = []
        for batch in job["batches"]:
            m = batch["mel"].shape[1] // world
            mine = {k: v[:, rank * m:(rank + 1) * m] for k, v in batch.items()}
            state, got = step(state, mine)
            metrics.append({k: float(v) for k, v in got.items()})
        # the last step's clipped gradients, whole on every rank
        grads = {k: (p.grad.full_tensor() if hasattr(p.grad, "full_tensor") else p.grad).clone()
                 for k, p in train_mod.unwrap(state.model).named_parameters()}
        out[name] = {"metrics": metrics, "params": ckpt_mod.model_state_dict(state),
                     "grads": grads}
    return out


def main(argv) -> None:
    if argv[0] == "loop":
        from olmoasr_tpu_torch.training import train_loop

        kwargs = json.loads(argv[1])
        dims = ModelDimensions(**kwargs.pop("dims"))
        train_loop.main(**kwargs, variant=dims)
        return
    job_path, rank, world, init_file = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        out = run(torch.load(job_path, weights_only=False), rank, world)
        if rank == 0:
            torch.save(out, f"{job_path}.out")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
