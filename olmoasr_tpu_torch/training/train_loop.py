"""Main training entry on one GPU: ``python -m olmoasr_tpu_torch.training.train_loop``.

Counterpart of ``olmoasr_tpu/training/train_loop.py`` (the reference's
train_timestamps.py main/train orchestration):

  * data: JSONL shards -> AudioTextDataset -> BatchLoader (prefetch thread)
  * model/optimizer: the reference recipe (TrainConfig), bf16 compute over
    fp32 parameters, gradient accumulation, remat, clip 1.0, on one device
  * checkpoints: periodic ``step_<N>/`` pruned to the latest, resume by
    experiment name; NaN alert with the offending step
  * metrics: the same train/* and efficiency/* names as the JAX loop

Runs on ``cuda`` unless the caller asks for another device (the tests run it
on the CPU at micro dims). Not ported yet, and raising: FSDP
(``fsdp_size != 1``), in-loop evaluation (``eval_every > 0``), the
``device_mel`` transport and profiling (``profile_dir``).
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from olmoasr_tpu_torch.models.dims import VARIANT_TO_DIMS
from olmoasr_tpu_torch.training import checkpoint as ckpt_mod
from olmoasr_tpu_torch.training import train as train_mod
from olmoasr_tpu_torch.training.dataset import AudioTextDataset, BatchLoader, load_jsonl_samples
from olmoasr_tpu_torch.training.logging_utils import MetricsLogger, StepTimer


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
    remat: bool = True,
    ckpt_dir: str = "checkpoints",
    ckpt_every: int = 1000,
    log_every: int = 20,
    eval_every: int = 0,
    seed: int = 42,
    device_mel: bool = False,
    max_steps_this_run: Optional[int] = None,
    profile_dir: Optional[str] = None,
    device: str = "cuda",
) -> Dict[str, Any]:
    """Train an OLMoASR variant. Returns the last logged metrics and
    ``global_step``."""
    for unported, what in ((fsdp_size != 1, "fsdp_size != 1 (FSDP)"),
                           (eval_every > 0, "eval_every > 0 (in-loop evaluation)"),
                           (device_mel, "device_mel"), (profile_dir, "profile_dir")):
        if unported:
            raise NotImplementedError(f"{what} is not ported to the GPU trainer yet")
    exp_name = exp_name or f"{variant.replace('.', '_')}_bs{eff_batch_size}"
    dims = VARIANT_TO_DIMS[variant] if isinstance(variant, str) else variant

    # accumulation_steps = eff_bs // micro_bs on one device
    # (prepare_sched, train_timestamps.py:764-769)
    accum_steps = max(eff_batch_size // micro_batch_size, 1)
    config = train_mod.TrainConfig(
        train_steps=train_steps, eff_batch_size=eff_batch_size,
        micro_batch_size=micro_batch_size, peak_lr=peak_lr, remat=remat,
    )
    state, meta, manager = ckpt_mod.resume_or_init(
        os.path.join(ckpt_dir, exp_name),
        lambda: train_mod.init_train_state(seed, dims, config, device=device),
    )
    start_step = int(meta.get("global_step", 0))
    best_eval_wer = meta.get("best_eval_wer")
    step_fn = train_mod.make_train_step(dims, config)

    shard_paths = sorted(glob.glob(train_shards))
    samples = load_jsonl_samples(shard_paths) if shard_paths else []
    if not samples:
        raise FileNotFoundError(f"no training samples under {train_shards}")
    dataset = AudioTextDataset(samples, dims.n_text_ctx, seed=seed)
    loader = BatchLoader(dataset, micro_batch_size=micro_batch_size, accum_steps=accum_steps,
                         seed=seed, num_workers=min(8, os.cpu_count() or 1))

    logger = MetricsLogger(exp_name)
    timer = StepTimer(micro_batch_size * accum_steps * 30.0)
    global_step = start_step
    epoch = int(meta.get("epoch", 0))
    final_metrics: Dict[str, Any] = {}
    stop = False
    while global_step < train_steps and not stop:
        loader.set_epoch(epoch)
        timer.start("dataloader")
        for batch in loader:
            timer.stop("dataloader")
            timer.start("step")
            state, metrics = step_fn(
                state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
            # no per-step host read: metrics are fetched (and NaN-checked) once
            # per log window, so the host queues the next step meanwhile
            timer.stop("step")
            global_step += 1

            if global_step % log_every == 0:
                loss = float(metrics["loss"])  # device sync, once per window
                if not np.isfinite(loss):
                    logger.alert("NaN loss", f"step {global_step}: loss={loss}")
                final_metrics = {
                    "train/loss": loss,
                    "train/accuracy": float(metrics["accuracy"]),
                    "train/grad_norm": float(metrics["grad_norm"]),
                    "train/lr": float(metrics["lr"]),
                    "train/epoch": epoch,
                    **timer.metrics(),
                }
                logger.log(final_metrics, step=global_step)

            if ckpt_every and global_step % ckpt_every == 0:
                manager.save(global_step, state, dims, epoch=epoch, best_eval_wer=best_eval_wer)

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

    manager.save(global_step, state, dims, epoch=epoch, best_eval_wer=best_eval_wer)
    logger.close()
    final_metrics["global_step"] = global_step
    return final_metrics


def build_cli_parser():
    """Flags from the main() signature, as the JAX loop's CLI builds them."""
    import argparse
    import inspect

    parser = argparse.ArgumentParser(description="OLMoASR training on one GPU")
    for name, p in inspect.signature(main).parameters.items():
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
