"""One rank of the multi-rank tests (``tests/test_torch_distributed.py``,
``tests/test_torch_decoding_mesh.py``).

Under torchrun, ``tests/torch_dist_worker.py loop JSON`` calls
``train_loop.main(**JSON)`` with ``variant`` the ``ModelDimensions`` of
JSON's ``dims`` (the CLI takes only a variant's name), and
``tests/torch_dist_worker.py cli JSON`` calls ``transcribe.cli(JSON["argv"])``,
each ``{rank}`` in it this rank's, with every decode at fp32 and
``JSON["sample_len"]`` tokens (the CLI has no flag for either), and
``tests/torch_dist_worker.py serve JSON`` calls ``serve.main(JSON["argv"])``
alike, then writes ``JSON["out"]<rank>`` once ``main`` has returned.

Run as ``python tests/torch_dist_worker.py JOB RANK WORLD INIT_FILE``: joins a
``gloo`` process group through the ``file://`` rendezvous ``INIT_FILE``, then
for each run of the job builds the port's model from the job's state dict,
spreads it over a (world / fsdp_size, fsdp_size) mesh with
``train.shard_train_state`` and takes the job's steps, each on this rank's
rows of the global batch (rank r holds rows r * m to (r + 1) * m of each
micro-batch, as the JAX package's batch sharding places them). Rank 0 writes
every run's metrics, gathered parameters and last gradients to ``JOB.out``. A
job whose ``kind`` is ``"decode"`` instead registers an inference mesh over the
job's rank grid and decodes each of its cases (``run_decode``), then runs the
eval harness's command line on the job's eval set; every rank writes its own
``JOB.out<rank>``. A job whose ``kind`` is ``"serve"`` registers a mesh over
every rank and makes the control group; rank 0 submits each of the job's
rounds of requests to a ``serve.BatchingService`` over that group and stops
it, every other rank runs ``serve.follow`` (``run_serve``). A job whose
``kind`` is ``"load"`` loads released names through ``api.load_model`` as
every rank of a CLI does (``run_load``). Imports torch and the port only,
never JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
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


@contextlib.contextmanager
def counted_gathers():
    """A list that gets one entry for each ``dist.all_gather`` call made
    inside the block."""
    gathers = []
    all_gather = dist.all_gather

    def counted(*args, **kwargs):
        gathers.append(1)
        return all_gather(*args, **kwargs)

    dist.all_gather = counted
    try:
        yield gathers
    finally:
        dist.all_gather = all_gather


def fp32_decode(module, sample_len: int) -> None:
    """Every ``DecodingOptions`` that ``module`` builds decodes at fp32 and
    ``sample_len`` tokens."""
    from olmoasr_tpu_torch.decoding import DecodingOptions

    module.DecodingOptions = lambda **kw: DecodingOptions(
        **{**kw, "fp16": False, "sample_len": sample_len})


def run_decode(job: dict, rank: int, world: int) -> dict:
    """With an inference mesh over the rank grid ``job["layout"]``: each
    case's results of ``decode`` (tokens, avg_logprob, no_speech_prob, the
    audio features) and the collectives it issued; then, if the job has an
    ``eval`` entry, ``eval.harness.main`` with its arguments (fp32 decodes,
    this rank's ``out_dir``)."""
    from torch.distributed.device_mesh import DeviceMesh

    from olmoasr_tpu_torch import decoding
    from olmoasr_tpu_torch.api import _new_model

    dims = ModelDimensions(**job["dims"])
    model = _new_model(dims, False, "cpu", torch.float32)
    model.load_state_dict(job["state_dict"])
    mesh = DeviceMesh("cpu", torch.tensor(job["layout"]), mesh_dim_names=("data", "fsdp"))
    out = {"shard_index": mesh_mod.shard_index(mesh), "cases": {}}
    try:
        with counted_gathers() as gathers:
            for name, (mel, options, registered) in job["cases"].items():
                decoding.set_infer_mesh(mesh if registered else None)
                gathers.clear()
                results = decoding.decode(model, mel, decoding.DecodingOptions(**options))
                out["cases"][name] = {
                    "tokens": [r.tokens for r in results],
                    "avg_logprob": [r.avg_logprob for r in results],
                    "no_speech_prob": [r.no_speech_prob for r in results],
                    "audio_features": torch.stack([r.audio_features for r in results]),
                    "gathers": len(gathers)}
    finally:
        decoding.set_infer_mesh(None)
    if "eval" in job:
        from olmoasr_tpu_torch.eval import harness

        fp32_decode(harness, job["sample_len"])
        harness.main([*job["eval"], "--out_dir", f"{job['eval_out']}{rank}"])
    return out


def run_serve(job: dict, rank: int, world: int) -> dict:
    """Rank 0: each of ``job["rounds"]`` (lists of (audio, options)) submitted
    at once to a ``BatchingService`` over the control group, every outcome
    ``("ok", result)`` or ``("error", "Type: message")``, then ``stop`` and the
    service's stats. The other ranks: what ``serve.follow`` returns. Each
    rank also counts the ``all_gather`` calls it made."""
    from olmoasr_tpu_torch import decoding, serve
    from olmoasr_tpu_torch.api import _new_model

    model = _new_model(ModelDimensions(**job["dims"]), False, "cpu", torch.float32)
    model.load_state_dict(job["state_dict"])
    decoding.set_infer_mesh(mesh_mod.make_mesh(device_type="cpu"))
    group = mesh_mod.control_group()
    try:
        with counted_gathers() as gathers:
            if rank > 0:
                return {"follow": serve.follow(model, group), "gathers": len(gathers)}
            service = serve.BatchingService(model, group=group, **job["service"])
            out = {"rounds": []}
            for requests in job["rounds"]:
                futures = [service.submit(audio, **options) for audio, options in requests]
                outcomes = []
                for f in futures:
                    try:
                        outcomes.append(("ok", f.result(timeout=300)))
                    except Exception as e:  # noqa: BLE001 -- the test reads the error
                        outcomes.append(("error", f"{type(e).__name__}: {e}"))
                out["rounds"].append(outcomes)
            service.stop()
            out["stats"] = dict(service.stats)
            out["gathers"] = len(gathers)
            return out
    finally:
        decoding.set_infer_mesh(None)


def run_load(job: dict, rank: int, world: int) -> list:
    """``api.load_model`` of the released name ``job["name"]`` with each of
    ``job["links"]`` as its ``MODEL2LINK`` URL, into ``job["root"]``: per
    link, the URLs this rank opened and its error (``"Type: message"``), or
    the loaded state dict. Rank 0's reads are slowed (``job["read_delay"]``
    seconds a read), so that a rank that did not wait would find the file
    in the making."""
    import time
    import urllib.request

    import olmoasr_tpu_torch
    from olmoasr_tpu_torch import api

    urlopen = urllib.request.urlopen
    opened = []

    def slow_urlopen(url):
        opened.append(url)
        source = urlopen(url)
        if rank == 0:
            read = source.read
            source.read = lambda n: time.sleep(job["read_delay"]) or read(n)
        return source

    urllib.request.urlopen = slow_urlopen
    out = []
    try:
        for link in job["links"]:
            olmoasr_tpu_torch.MODEL2LINK[job["name"]] = link
            opened.clear()
            try:
                model = api.load_model(job["name"], device="cpu", download_root=job["root"])
                got = {"state_dict": model.state_dict()}
            except Exception as e:  # noqa: BLE001 -- the test reads the error
                got = {"error": f"{type(e).__name__}: {e}"}
            out.append({**got, "opened": list(opened)})
    finally:
        urllib.request.urlopen = urlopen
    return out


def main(argv) -> None:
    if argv[0] == "loop":
        from olmoasr_tpu_torch.training import train_loop

        kwargs = json.loads(argv[1])
        dims = ModelDimensions(**kwargs.pop("dims"))
        train_loop.main(**kwargs, variant=dims)
        return
    if argv[0] == "cli":
        from olmoasr_tpu_torch import transcribe

        job = json.loads(argv[1])
        fp32_decode(transcribe, job["sample_len"])
        transcribe.cli([a.replace("{rank}", os.environ["RANK"]) for a in job["argv"]])
        return
    if argv[0] == "serve":
        from olmoasr_tpu_torch import serve, transcribe

        job = json.loads(argv[1])
        fp32_decode(transcribe, job["sample_len"])
        serve.main(job["argv"])
        with open(f"{job['out']}{os.environ['RANK']}", "w") as f:
            f.write("returned\n")
        return
    job_path, rank, world, init_file = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        job = torch.load(job_path, weights_only=False)
        if job.get("kind") in ("decode", "serve", "load"):
            run_job = {"decode": run_decode, "serve": run_serve, "load": run_load}[job["kind"]]
            torch.save(run_job(job, rank, world), f"{job_path}.out{rank}")
            return
        out = run(job, rank, world)
        if rank == 0:
            torch.save(out, f"{job_path}.out")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
