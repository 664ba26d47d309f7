"""Checkpoint / resume for training.

Counterpart of ``olmoasr_tpu/training/checkpoint.py`` over ``torch.save``:
periodic ``step_<N>/`` directories pruned to the latest ``max_to_keep``, each
with ``state.pt`` (the model's and the optimizer's full state dicts, keyed by
parameter name, and the step) and ``meta.json`` (dims, epoch, global_step,
best_eval_wer); plus the eval-ready ``.npz`` inference checkpoint in the JAX
package's format.

The state dicts go through ``torch.distributed.checkpoint.state_dict``, so
one file serves every layout: a multi-rank run (DDP or FSDP2) gathers the
full state on every rank, rank 0 writes it, and every rank loads the whole
file into its own layout, so a checkpoint of R ranks resumes on one device
and one of one device on R ranks. Every rank calls the gather (a
collective); only the write is rank 0's.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.checkpoint.state_dict import (
    StateDictOptions,
    get_model_state_dict,
    get_optimizer_state_dict,
    set_model_state_dict,
    set_optimizer_state_dict,
)

from olmoasr_tpu_torch.models import convert
from olmoasr_tpu_torch.models.dims import ModelDimensions
from olmoasr_tpu_torch.parallel.mesh import rank
from olmoasr_tpu_torch.training.train import TrainState

_STEP_DIR = re.compile(r"step_(\d+)$")
# whole tensors on the host (rank 0's; other ranks get empty dicts)
_GATHER = StateDictOptions(full_state_dict=True, cpu_offload=True)


def model_state_dict(state: TrainState) -> Dict[str, torch.Tensor]:
    """The model's full state dict on the host, under the Whisper's own
    names, whatever wraps or shards it; on rank 0 (other ranks get an empty
    dict). Every rank must call it."""
    return get_model_state_dict(state.model, options=_GATHER)


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


class CheckpointManager:
    """Directory layout::

        <ckpt_dir>/
          step_<N>/   state.pt + meta.json, written whole or not at all
    """

    def __init__(self, ckpt_dir: str, *, max_to_keep: int = 1):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def _steps(self):
        found = (_STEP_DIR.match(name) for name in os.listdir(self.ckpt_dir))
        return sorted(int(m.group(1)) for m in found
                      if m and os.path.isfile(os.path.join(self.ckpt_dir, m.group(0), "meta.json")))

    def save(self, step: int, state: TrainState, dims: ModelDimensions, *, epoch: int = 0,
             best_eval_wer: Optional[float] = None) -> None:
        """Write ``step_<step>/`` (synchronously): every rank gathers, rank 0
        writes, every rank waits for the write."""
        model_sd = model_state_dict(state)
        optim_sd = get_optimizer_state_dict(state.model, state.optimizer, options=_GATHER)
        if rank() == 0:
            final = os.path.join(self.ckpt_dir, f"step_{step}")
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save({"model": model_sd, "optimizer": optim_sd, "step": state.step},
                       os.path.join(tmp, "state.pt"))
            meta = {"dims": dims.to_dict(), "epoch": epoch, "global_step": step,
                    "best_eval_wer": best_eval_wer}
            with open(os.path.join(tmp, "meta.json"), "w", encoding="utf-8") as f:
                json.dump(meta, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)  # a reader sees the whole directory or none
            for old in self._steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{old}"))
        _barrier()

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state_template: TrainState,
                step: Optional[int] = None) -> Tuple[TrainState, Dict[str, Any]]:
        """Load a checkpoint into the template's model and optimizer, each
        rank reading the whole file into its own layout (its shards under
        FSDP2) on the model's device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.ckpt_dir}")
        d = os.path.join(self.ckpt_dir, f"step_{step}")
        saved = torch.load(os.path.join(d, "state.pt"), map_location="cpu", weights_only=True)
        full = StateDictOptions(full_state_dict=True)
        model, optimizer = state_template.model, state_template.optimizer
        set_model_state_dict(model, saved["model"], options=full)
        set_optimizer_state_dict(model, optimizer, saved["optimizer"], options=full)
        state_template.step = int(saved["step"])
        with open(os.path.join(d, "meta.json"), encoding="utf-8") as f:
            return state_template, json.load(f)


def save_eval_checkpoint(path: str, state: TrainState, dims: ModelDimensions) -> None:
    """Inference-ready ``.npz`` (the JAX package's format): the padding row
    stripped, as gen_inf_ckpt.py does. Every rank gathers, rank 0 writes,
    every rank waits for the write."""
    sd = model_state_dict(state)
    if rank() == 0:
        convert.save_npz_checkpoint(path, convert.strip_padding_row(sd), dims)
    _barrier()


def resume_or_init(ckpt_dir: str, init_fn):
    """Run-id style resume (train_timestamps.py:2196-2205): restore the latest
    checkpoint into a fresh state if one exists, else start fresh. Returns
    (state, meta, manager)."""
    mgr = CheckpointManager(ckpt_dir)
    template = init_fn()
    if mgr.latest_step() is not None:
        state, meta = mgr.restore(template)
        return state, meta, mgr
    return template, {"epoch": 0, "global_step": 0, "best_eval_wer": None}, mgr
