"""Main training entry: ``python -m olmoasr_tpu_torch.training.train_loop`` on
one GPU, or under torchrun on several (``python -m torch.distributed.run
--standalone --nproc_per_node=R -m olmoasr_tpu_torch.training.train_loop``).

Counterpart of ``olmoasr_tpu/training/train_loop.py`` (the reference's
train_timestamps.py main/train orchestration):

  * data: JSONL shards -> AudioTextDataset -> BatchLoader (prefetch thread)
  * model/optimizer: the reference recipe (TrainConfig), bf16 compute over
    fp32 parameters, gradient accumulation, remat, clip 1.0
  * ranks: under torchrun the process group is joined (``nccl`` on
    ``cuda:{LOCAL_RANK}``, ``gloo`` on the CPU) and the state spread over a
    (world / fsdp_size, fsdp_size) mesh (``train.shard_train_state``): DDP
    when ``fsdp_size`` is 1, FSDP2 when it is the world (``fsdp_strategy``
    ``full`` = FULL_SHARD, ``grad_op`` = SHARD_GRAD_OP), hybrid in between;
    each rank reads its strided share of the shards
  * checkpoints: periodic ``step_<N>/`` pruned to the latest, resume by
    experiment name; NaN alert with the offending step
  * metrics: the same train/* and efficiency/* names as the JAX loop
  * evaluation every ``eval_every`` steps: ``sync`` decodes the eval set in
    this process (greedy short-form WER, ``best.npz`` on a new best; on one
    rank only), ``async`` saves ``eval_<step>.npz`` and spawns the port's
    eval harness on it from rank 0 (train_timestamps.py:1835-2089)
  * ``profile_dir``: a ``torch.profiler`` trace of rank 0's steps
    ``profile_steps[0]`` to ``profile_steps[1]`` of this run, with the
    port's ``olmoasr.train.*`` spans (``tracing``)

Runs on ``cuda`` unless the caller asks for another device (the tests run it
on the CPU at micro dims). ``device_mel`` ships each sample's 30 s PCM
instead of its log-mel and computes the log-mel in the train step on the
device (``train.loss_fn``). ``mu_dtype`` / ``nu_dtype`` store Adam's moments
in another dtype (``train.CastMomentAdamW``).
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from olmoasr_tpu_torch.models.dims import VARIANT_TO_DIMS, ModelDimensions
from olmoasr_tpu_torch.parallel import mesh as mesh_mod
from olmoasr_tpu_torch.training import checkpoint as ckpt_mod
from olmoasr_tpu_torch.training import train as train_mod
from olmoasr_tpu_torch.training.dataset import AudioTextDataset, BatchLoader, load_jsonl_samples
from olmoasr_tpu_torch.training.logging_utils import MetricsLogger, StepTimer
from olmoasr_tpu_torch.tracing import span


def run_async_eval(eval_ckpt_path: str, eval_set: str, eval_dir: str, out_dir: str,
                   device: str = "cuda") -> subprocess.Popen:
    """Spawn the port's eval harness on ``eval_ckpt_path``
    (train_timestamps.py:2013-2089), on ``device``. The JAX package sends
    this process to the host CPU because a TPU cannot be shared between
    processes; a GPU can, so it evaluates on the trainer's own device. The
    child gets the trainer's environment without torchrun's variables: it
    runs on its own and does not join the trainer's process group."""
    cmd = [
        sys.executable, "-m", "olmoasr_tpu_torch.eval.harness",
        "--eval_set", eval_set, "--eval_dir", eval_dir,
        "--ckpt", eval_ckpt_path, "--out_dir", out_dir, "--device", str(device),
    ]
    env = mesh_mod.without_launcher_env(os.environ)
    # the harness of the checkout this trainer runs from
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (root, env.get("PYTHONPATH"))))
    return subprocess.Popen(cmd, env=env)


def run_sync_eval(state: "train_mod.TrainState", dims: ModelDimensions, eval_set: str,
                  eval_dir: str, *, batch_size: int = 16,
                  max_samples: Optional[int] = None) -> float:
    """Synchronous in-loop eval with real ``model.decode`` (the reference's
    ``evaluate()``, train_timestamps.py:1835-2089): batched greedy
    short-form WER of an inference model built from the current weights
    (the padding row stripped), on the training device. Returns the corpus
    WER (fraction)."""
    from olmoasr_tpu_torch.api import _new_model
    from olmoasr_tpu_torch.eval.harness import short_form_eval
    from olmoasr_tpu_torch.models import convert as convert_mod

    device = next(state.model.parameters()).device
    model = _new_model(dims, False, device, torch.float32)
    with torch.no_grad():
        model.load_state_dict(convert_mod.strip_padding_row(ckpt_mod.model_state_dict(state)))
    result = short_form_eval(model.eval(), eval_set, eval_dir, batch_size=batch_size,
                             max_samples=max_samples)
    return float(result.wer)


def _dtype(name):
    """A dtype from its torch name (``"bfloat16"``), as the CLI passes it."""
    return getattr(torch, name) if isinstance(name, str) else name


def _stop_profile(prof, profile_dir: str, steps: Tuple[int, int]) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, f"trace_steps_{steps[0]}_{steps[1]}.json"))


def main(
    *,
    variant: str = "medium.en",
    train_shards: str = "data/*.jsonl.gz",
    exp_name: Optional[str] = None,
    train_steps: int = 524_288,
    eff_batch_size: int = 512,
    micro_batch_size: int = 8,
    peak_lr: float = 1.5e-3,
    fsdp_size: int = 1,
    fsdp_strategy: str = "full",  # full=FULL_SHARD | grad_op=SHARD_GRAD_OP
    remat: bool = True,
    ckpt_dir: str = "checkpoints",
    ckpt_every: int = 1000,
    log_every: int = 20,
    eval_every: int = 0,
    eval_mode: str = "async",  # "async" subprocess | "sync" in-loop decode
    eval_set: str = "librispeech_clean",
    eval_dir: str = "eval_data",
    eval_max_samples: Optional[int] = None,
    seed: int = 42,
    device_mel: bool = False,
    max_steps_this_run: Optional[int] = None,
    profile_dir: Optional[str] = None,
    profile_steps: Tuple[int, int] = (10, 15),
    device: str = "cuda",
    attention: str = "kernel",
    mu_dtype: Optional[str] = None,
    nu_dtype: Optional[str] = None,
) -> Dict[str, Any]:
    """Train an OLMoASR variant. Returns the last logged metrics and
    ``global_step``. ``attention`` is ``TrainConfig.attention``: the
    attention kernels, ``"kernel"`` or ``"flash"``; ``mu_dtype`` /
    ``nu_dtype`` are ``TrainConfig``'s, a torch dtype or its name
    (``"bfloat16"``). The profiler traces rank 0 from step ``start +
    profile_steps[0]`` up to ``start + profile_steps[1]`` (or the run's end)
    and writes a Chrome trace into ``profile_dir``.

    Under torchrun (or in a process group the caller made) the run is
    multi-rank: ``micro_batch_size`` is each rank's, ``fsdp_size`` must
    divide the world size, and a bare ``device="cuda"`` is each rank's
    ``cuda:{LOCAL_RANK}``. A group that ``main`` joined it also leaves."""
    if fsdp_strategy not in ("full", "grad_op"):
        raise ValueError(f"fsdp_strategy must be 'full' or 'grad_op', got {fsdp_strategy!r}")
    created = mesh_mod.init_distributed(device)
    try:
        rank_device = mesh_mod.rank_device(device)
        zero2 = fsdp_strategy == "grad_op"
        world, rank = mesh_mod.world_size(), mesh_mod.rank()
        if fsdp_size < 1 or world % fsdp_size:
            raise ValueError(f"fsdp_size {fsdp_size} does not divide the world size {world}")
        exp_name = exp_name or f"{variant.replace('.', '_')}_bs{eff_batch_size}"
        dims = VARIANT_TO_DIMS[variant] if isinstance(variant, str) else variant

        # accumulation_steps = eff_bs // (ranks * micro_bs)
        # (prepare_sched, train_timestamps.py:764-769)
        accum_steps = max(eff_batch_size // (world * micro_batch_size), 1)
        config = train_mod.TrainConfig(
            train_steps=train_steps, eff_batch_size=eff_batch_size,
            micro_batch_size=micro_batch_size, peak_lr=peak_lr, remat=remat,
            attention=attention, mu_dtype=_dtype(mu_dtype), nu_dtype=_dtype(nu_dtype),
        )
        # the (data, fsdp) mesh of a process group, even of one rank (DDP)
        mesh = None
        if torch.distributed.is_initialized():
            mesh = mesh_mod.make_mesh(world // fsdp_size, fsdp_size,
                                      device_type=rank_device.type)

        def init_state():
            state = train_mod.init_train_state(seed, dims, config, device=rank_device)
            if mesh is None:
                return state
            return train_mod.shard_train_state(state, mesh, config, zero2=zero2)

        state, meta, manager = ckpt_mod.resume_or_init(os.path.join(ckpt_dir, exp_name), init_state)
        start_step = int(meta.get("global_step", 0))
        best_eval_wer = meta.get("best_eval_wer")
        step_fn = train_mod.make_train_step(dims, config, mesh)

        shard_paths = sorted(glob.glob(train_shards))
        samples = load_jsonl_samples(shard_paths) if shard_paths else []
        if not samples:
            raise FileNotFoundError(f"no training samples under {train_shards}")
        dataset = AudioTextDataset(samples, dims.n_text_ctx, seed=seed, device_mel=device_mel)
        loader = BatchLoader(dataset, micro_batch_size=micro_batch_size, accum_steps=accum_steps,
                             seed=seed, shard_id=rank, num_shards=world,
                             num_workers=min(8, os.cpu_count() or 1))

        logger = MetricsLogger(exp_name) if rank == 0 else None
        timer = StepTimer(micro_batch_size * accum_steps * 30.0)
        global_step = start_step
        epoch = int(meta.get("epoch", 0))
        final_metrics: Dict[str, Any] = {}
        eval_proc: Optional[subprocess.Popen] = None
        prof = None
        stop = False
        while global_step < train_steps and not stop:
            loader.set_epoch(epoch)
            timer.start("dataloader")
            for batch in loader:
                timer.stop("dataloader")
                if profile_dir and rank == 0 and global_step == start_step + profile_steps[0]:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if rank_device.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    prof = torch.profiler.profile(activities=activities)
                    prof.start()
                if prof is not None and global_step == start_step + profile_steps[1]:
                    _stop_profile(prof, profile_dir, profile_steps)
                    prof = None
                timer.start("step")
                with span("train.h2d"):
                    batch = {k: torch.from_numpy(v).to(rank_device) for k, v in batch.items()}
                state, metrics = step_fn(state, batch)
                # no per-step host read: metrics are fetched (and NaN-checked) once
                # per log window, so the host queues the next step meanwhile
                timer.stop("step")
                global_step += 1

                if global_step % log_every == 0:
                    loss = float(metrics["loss"])  # device sync, once per window
                    window = timer.metrics()  # the window's wall ends at that sync
                    if not np.isfinite(loss) and logger:
                        logger.alert("NaN loss", f"step {global_step}: loss={loss}")
                    final_metrics = {
                        "train/loss": loss,
                        "train/accuracy": float(metrics["accuracy"]),
                        "train/grad_norm": float(metrics["grad_norm"]),
                        "train/lr": float(metrics["lr"]),
                        "train/epoch": epoch,
                        **window,
                    }
                    if logger:
                        logger.log(final_metrics, step=global_step)

                if ckpt_every and global_step % ckpt_every == 0:
                    manager.save(global_step, state, dims, epoch=epoch, best_eval_wer=best_eval_wer)

                if eval_every and global_step % eval_every == 0:
                    if eval_mode == "sync" and world > 1:
                        # one rank's decode cannot see the others' shards, as in
                        # the JAX loop: async eval serves multi-rank runs
                        if logger:
                            logger.alert("sync eval unsupported multihost",
                                         "use eval_mode='async' (subprocess) instead")
                    elif eval_mode == "sync":
                        # in-loop model.decode WER with best-checkpoint gating
                        # (train_timestamps.py:1835-2089); a failed eval (missing
                        # eval data, say) is reported and does not stop the run
                        wer = None
                        try:
                            wer = run_sync_eval(state, dims, eval_set, eval_dir,
                                                max_samples=eval_max_samples)
                        except Exception as e:
                            logger.alert("sync eval failed", str(e))
                        if wer is not None:
                            logger.log({"eval/wer": wer}, step=global_step)
                            final_metrics["eval/wer"] = wer
                            if best_eval_wer is None or wer < best_eval_wer:
                                best_eval_wer = wer
                                ckpt_mod.save_eval_checkpoint(
                                    os.path.join(ckpt_dir, exp_name, "best.npz"), state, dims)
                    else:
                        eval_ckpt = os.path.join(ckpt_dir, exp_name, f"eval_{global_step}.npz")
                        ckpt_mod.save_eval_checkpoint(eval_ckpt, state, dims)  # every rank gathers
                        if rank == 0 and (eval_proc is None or eval_proc.poll() is not None):
                            eval_proc = run_async_eval(eval_ckpt, eval_set, eval_dir,
                                                       os.path.join("eval_results", exp_name),
                                                       device)

                if max_steps_this_run and global_step - start_step >= max_steps_this_run:
                    stop = True
                    break
                if global_step >= train_steps:
                    stop = True
                    break
                timer.start("dataloader")
            else:
                epoch += 1
                continue

        if prof is not None:  # the run ended inside the traced steps
            _stop_profile(prof, profile_dir, profile_steps)
        manager.save(global_step, state, dims, epoch=epoch, best_eval_wer=best_eval_wer)
        if logger:
            logger.close()
        final_metrics["global_step"] = global_step
        return final_metrics

    finally:
        if created:
            torch.distributed.destroy_process_group()


def build_cli_parser():
    """Flags from the main() signature, as the JAX loop's CLI builds them
    (``profile_steps``, a tuple, is left at its default)."""
    import argparse
    import inspect

    parser = argparse.ArgumentParser(description="OLMoASR training on one GPU or, under "
                                                 "torchrun, on several")
    for name, p in inspect.signature(main).parameters.items():
        if isinstance(p.default, tuple):
            continue  # not expressible as one flag
        if isinstance(p.default, bool):
            parser.add_argument(f"--{name}", type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=p.default)
        elif p.default is not None:
            parser.add_argument(f"--{name}", type=type(p.default), default=p.default)
        else:
            # Optional[...] defaults: the inner type from the annotation
            ann = str(p.annotation)
            kind = int if "int" in ann else float if "float" in ann else str
            parser.add_argument(f"--{name}", type=kind, default=None)
    return parser


if __name__ == "__main__":
    print(main(**vars(build_cli_parser().parse_args())))
