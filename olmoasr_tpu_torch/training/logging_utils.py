"""Observability: wandb-gated metric logging + step timing.

Rebuild of the reference's wandb backbone and manual wall-clock tracing
(``scripts/training/train_timestamps.py:786-891,1402-1541``
``scripts/training/for_logging.py``): same metric names (``train/*``,
``efficiency/*``) including the throughput north-star
``audio_min_per_GPU_second`` (1525-1538; per-chip here), resumable run ids
persisted to ``run_ids/<exp>.txt`` (2196-2205), NaN alerts (1484-1490).
wandb is optional — everything degrades to JSONL lines on disk.

A copy of ``olmoasr_tpu/training/logging_utils.py`` (the port imports nothing
of the JAX package), but for ``StepTimer``'s step time: the log window's
wall, not the host's call of an asynchronous step.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Dict, Optional

# wandb table schemas (scripts/training/for_logging.py:1-44)
TRAIN_TABLE_COLS = [
    "global_step", "audio_file", "transcript_file", "audio", "pred", "target",
    "wer", "loss",
]
VAL_TABLE_COLS = ["global_step", "dataset", "audio", "pred", "target", "wer", "loss"]
EVAL_TABLE_COLS = ["global_step", "eval_set", "audio", "pred", "target", "wer"]


class MetricsLogger:
    """wandb when available+configured; always mirrors to a local JSONL."""

    def __init__(
        self,
        exp_name: str,
        log_dir: str = "logs",
        use_wandb: Optional[bool] = None,
        wandb_project: str = "olmoasr-tpu",
        run_id_dir: str = "run_ids",
    ):
        self.exp_name = exp_name
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, f"{exp_name}_metrics.jsonl")
        self._fh = open(self.jsonl_path, "a", encoding="utf-8")
        self.wandb = None

        if use_wandb is None:
            use_wandb = os.environ.get("WANDB_API_KEY") is not None
        if use_wandb:
            try:
                import wandb

                os.makedirs(run_id_dir, exist_ok=True)
                run_id_file = os.path.join(run_id_dir, f"{exp_name}.txt")
                # resumable run id (train_timestamps.py:2196-2205)
                if os.path.isfile(run_id_file):
                    run_id = open(run_id_file).read().strip()
                else:
                    run_id = uuid.uuid4().hex[:8]
                    with open(run_id_file, "w") as f:
                        f.write(run_id)
                self.wandb = wandb.init(
                    project=wandb_project, name=exp_name, id=run_id, resume="allow"
                )
            except Exception as e:  # offline / unconfigured
                print(f"wandb unavailable ({e}); logging to {self.jsonl_path}")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        record = {"step": step, "time": time.time(), **metrics}
        self._fh.write(json.dumps(record, default=float) + "\n")
        self._fh.flush()
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def log_table(
        self,
        name: str,
        columns: list,
        rows: list,
        step: Optional[int] = None,
        audio_cols: Optional[list] = None,
    ):
        """Example tables (train/val/eval) with optional embedded audio —
        the reference's rich wandb tables (train_timestamps.py:1199-1277).
        Rows with numpy audio in ``audio_cols`` are wrapped as wandb.Audio;
        offline they are logged as JSONL without the waveforms."""
        if self.wandb is not None:
            try:
                import wandb

                wrapped = []
                for row in rows:
                    out = []
                    for col, val in zip(columns, row):
                        if audio_cols and col in audio_cols and val is not None:
                            out.append(wandb.Audio(val, sample_rate=16000))
                        else:
                            out.append(val)
                    wrapped.append(out)
                self.wandb.log(
                    {name: wandb.Table(columns=columns, data=wrapped)}, step=step
                )
                return
            except Exception:
                pass
        slim = [
            [v for c, v in zip(columns, row) if not (audio_cols and c in audio_cols)]
            for row in rows
        ]
        self.log({f"table/{name}": {"columns": columns, "rows": slim}}, step=step)

    def alert(self, title: str, text: str):
        """NaN-loss style alerts (train_timestamps.py:1484-1490)."""
        self.log({"alert": title, "alert_text": text})
        if self.wandb is not None:
            try:
                import wandb

                wandb.alert(title=title, text=text)
            except Exception:
                pass

    def close(self):
        self._fh.close()
        if self.wandb is not None:
            self.wandb.finish()


class StepTimer:
    """Wall-clock phase timing -> efficiency/* metrics
    (train_timestamps.py:1402-1541).

    ``efficiency/step_time`` is the log window's wall over its steps: from
    the first step's start, or from the last :meth:`metrics` call, to this
    one. The loop calls :meth:`metrics` right after it reads the window's
    loss, its one wait for the device, so that the time is the device's
    steps and not the host's asynchronous calls that queue them. Every other
    phase (``dataloader``) reads the host's time in it on the last step."""

    def __init__(self, batch_seconds_of_audio: float):
        self.batch_audio_s = batch_seconds_of_audio
        self._t: Dict[str, float] = {}
        self._acc: Dict[str, float] = {}
        self._window_t0: Optional[float] = None
        self._steps = 0

    def start(self, phase: str):
        self._t[phase] = time.perf_counter()
        if phase == "step" and self._window_t0 is None:
            self._window_t0 = self._t[phase]

    def stop(self, phase: str):
        elapsed = time.perf_counter() - self._t.pop(phase)
        if phase == "step":
            self._steps += 1
        else:
            self._acc[phase] = elapsed

    def metrics(self) -> Dict[str, float]:
        now = time.perf_counter()
        out = {f"efficiency/{k}_time": v for k, v in self._acc.items()}
        if self._steps:
            step_time = (now - self._window_t0) / self._steps
            out["efficiency/step_time"] = step_time
            # audio minutes processed per chip-second (reference's
            # audio_min_per_GPU_second, train_timestamps.py:1525-1538)
            out["efficiency/audio_min_per_chip_second"] = (
                self.batch_audio_s / 60.0
            ) / step_time
        self._acc = {}
        self._window_t0, self._steps = now, 0
        return out
