"""Short-form and long-form WER evaluation loops on one GPU, or split across
the ranks of a torchrun launch (``main``).

Counterpart of ``olmoasr_tpu/eval/harness.py`` (the reference's
``scripts/eval/eval.py:1648-2294``):

  * ``short_form_eval``: batched greedy ``decode`` (language=en, no
    timestamps) over <=30 s utterances -> EnglishTextNormalizer -> corpus WER
    with substitution/insertion/deletion counts (eval.py:1648-1903).
  * ``long_form_eval``: ``transcribe_many`` with beam_size=5, best_of=5 and
    timestamps (eval.py:1906-2139, options at 2077-2084).
  * results written as text + json; per-sample WER rows for bootstrap CIs
    (eval.py:1870-1881, 2250-2254).

The model is the port's ``OLMoASR`` on its device (``cuda`` unless the caller
loads it elsewhere). Short-form computes each batch's log-mel on that device
(``audio.log_mel_spectrogram`` of the (B, 480000) padded waveforms); only the
waveforms go up and only the token ids come back. ``tests/test_torch_eval.py``
holds every function here to the JAX package's at fp32 on the CPU.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from olmoasr_tpu_torch.audio import SAMPLE_RATE, load_audio, log_mel_spectrogram, pad_or_trim
from olmoasr_tpu_torch.decoding import DecodingOptions
from olmoasr_tpu_torch.eval.datasets import DatasetFactory, EvalItem
from olmoasr_tpu_torch.eval.wer import compute_measures
from olmoasr_tpu_torch.normalizers import EnglishTextNormalizer


@dataclass
class EvalResult:
    eval_set: str
    wer: float
    substitutions: int
    insertions: int
    deletions: int
    n_samples: int
    audio_seconds: float
    wall_seconds: float
    per_sample: List[Dict]

    @property
    def rtfx(self) -> float:
        return self.audio_seconds / max(self.wall_seconds, 1e-9)

    def to_dict(self) -> Dict:
        return {
            "eval_set": self.eval_set,
            "wer": self.wer,
            "substitutions": self.substitutions,
            "insertions": self.insertions,
            "deletions": self.deletions,
            "n_samples": self.n_samples,
            "rtfx": self.rtfx,
        }


def _item_waveform(item: EvalItem) -> np.ndarray:
    if isinstance(item.audio, np.ndarray):
        wav = item.audio
    elif hasattr(item.audio, "load"):  # lazy decoder (HFDatasetLoader)
        wav = item.audio.load()
    else:
        wav = load_audio(item.audio)
    if item.start is not None:
        s = int(item.start * SAMPLE_RATE)
        e = int((item.end if item.end is not None else item.start + 30) * SAMPLE_RATE)
        wav = wav[s:e]
    return wav


def _load_items(eval_set: str, eval_dir: str, max_samples: Optional[int]) -> List[EvalItem]:
    items = DatasetFactory.create_loader(eval_set, eval_dir).load()
    if max_samples:
        items = items[:max_samples]
    if not items:
        raise FileNotFoundError(f"no items for {eval_set} under {eval_dir}")
    return items


def _result(eval_set, refs, hyps, per_sample, audio_seconds, wall) -> EvalResult:
    m = compute_measures(refs, hyps)
    return EvalResult(
        eval_set=eval_set, wer=m.wer, substitutions=m.substitutions,
        insertions=m.insertions, deletions=m.deletions, n_samples=len(refs),
        audio_seconds=audio_seconds, wall_seconds=wall, per_sample=per_sample,
    )


def short_form_eval(
    model,
    eval_set: str,
    eval_dir: str,
    *,
    batch_size: int = 16,
    max_samples: Optional[int] = None,
    normalizer=None,
    kv_quant: bool = False,
    verbose: bool = False,
) -> EvalResult:
    """Batched greedy short-form evaluation (eval.py:1648-1903).

    The ragged last batch decodes at its own size. (The JAX package pads it
    to ``batch_size`` so that one XLA program serves every batch; the port
    compiles nothing per shape.) At fp32 on the CPU a window's greedy result
    does not depend on the other rows of its batch. On the card the decode
    kernels choose their split of the work by the row count (the cross
    attention's cluster size, for one), so a ragged batch sums in another
    order than the padded one would, and in bf16 a near-tied argmax may
    differ: its hypotheses equal a padded batch's only to that rounding."""
    normalizer = normalizer or EnglishTextNormalizer()
    items = _load_items(eval_set, eval_dir, max_samples)
    options = DecodingOptions(
        language="en", without_timestamps=True, fp16=True, kv_quant=kv_quant
    )

    refs: List[str] = []
    hyps: List[str] = []
    per_sample: List[Dict] = []
    audio_seconds = 0.0
    t0 = time.perf_counter()

    for i in range(0, len(items), batch_size):
        chunk = items[i : i + batch_size]
        wavs = []
        for item in chunk:
            wav = _item_waveform(item)
            audio_seconds += len(wav) / SAMPLE_RATE
            wavs.append(pad_or_trim(np.asarray(wav, np.float32)))
        batch = torch.from_numpy(np.stack(wavs)).to(model.device)
        results = model.decode(log_mel_spectrogram(batch, model.dims.n_mels), options)
        for item, res in zip(chunk, results):
            ref = normalizer(item.text)
            hyp = normalizer(res.text)
            if not ref.strip():
                continue
            refs.append(ref)
            hyps.append(hyp)
            m = compute_measures(ref, hyp)
            per_sample.append({"id": item.id, "ref": ref, "hyp": hyp, "wer": m.wer})
            if verbose:
                print(f"[{len(refs)}] wer={m.wer:.3f} hyp={hyp[:60]!r}")

    return _result(eval_set, refs, hyps, per_sample, audio_seconds, time.perf_counter() - t0)


def long_form_eval(
    model,
    eval_set: str,
    eval_dir: str,
    *,
    max_samples: Optional[int] = None,
    normalizer=None,
    beam_size: int = 5,
    best_of: int = 5,
    batch_size: int = 8,
    verbose: bool = False,
) -> EvalResult:
    """Long-form transcribe evaluation with beam search (eval.py:1906-2139).

    Files are transcribed ``batch_size`` at a time through
    ``transcribe_many`` (each decode call batches the current windows of all
    active files; only the windows that fail the fallback gates decode
    again); the reference loops ``model.transcribe`` one file at a time."""
    from olmoasr_tpu_torch.transcribe import transcribe_many

    normalizer = normalizer or EnglishTextNormalizer()
    items = _load_items(eval_set, eval_dir, max_samples)

    refs, hyps, per_sample = [], [], []
    audio_seconds = 0.0
    t0 = time.perf_counter()
    for i in range(0, len(items), batch_size):
        chunk = items[i : i + batch_size]
        wavs = [_item_waveform(item) for item in chunk]
        audio_seconds += sum(len(w) for w in wavs) / SAMPLE_RATE
        outs = transcribe_many(
            model, wavs, batch_size=batch_size,
            beam_size=beam_size, best_of=best_of, verbose=None,
        )
        for item, out in zip(chunk, outs):
            ref = normalizer(item.text)
            hyp = normalizer(out["text"])
            if not ref.strip():
                continue
            refs.append(ref)
            hyps.append(hyp)
            m = compute_measures(ref, hyp)
            per_sample.append({"id": item.id, "ref": ref, "hyp": hyp, "wer": m.wer})
            if verbose:
                print(f"wer={m.wer:.3f} {str(item.audio)[-40:]}")

    return _result(eval_set, refs, hyps, per_sample, audio_seconds, time.perf_counter() - t0)


def long_form_eval_single(
    model, audio_path: str, ref_path: Optional[str] = None, *, normalizer=None
) -> float:
    """Transcribe ONE long-form file with the reference's eval config
    (beam_size=5, best_of=5, timestamps on; eval.py:2077-2084) and return WER
    against the reference transcript (0.0 when no reference is given)."""
    normalizer = normalizer or EnglishTextNormalizer()
    out = model.transcribe(audio_path, beam_size=5, best_of=5, verbose=None)
    if not ref_path:
        print(out["text"][:2000])
        return 0.0
    with open(ref_path, encoding="utf-8") as f:
        ref = normalizer(f.read())
    hyp = normalizer(out["text"])
    return compute_measures(ref, hyp).wer


def write_results(result: EvalResult, out_dir: str, ckpt_name: str = "model"):
    """Text + json + per-sample CSV (bootstrap input), like eval.py:2179-2285."""
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, f"{result.eval_set}_{ckpt_name}")
    with open(base + ".txt", "w") as f:
        f.write(
            f"eval_set={result.eval_set}\nwer={result.wer * 100:.2f}\n"
            f"subs={result.substitutions} ins={result.insertions} "
            f"dels={result.deletions}\nn={result.n_samples}\n"
            f"rtfx={result.rtfx:.1f}\n"
        )
    with open(base + ".json", "w") as f:
        json.dump(result.to_dict(), f)
    with open(base + "_per_sample.csv", "w") as f:
        f.write("id,wer,ref,hyp\n")
        for row in result.per_sample:
            ref = str(row["ref"]).replace('"', "'")
            hyp = str(row["hyp"]).replace('"', "'")
            f.write(f'{row["id"]},{row["wer"]:.4f},"{ref}","{hyp}"\n')


def bootstrap_ci(
    per_sample_wers: Sequence[float], n_boot: int = 1000, seed: int = 0
) -> Tuple[float, float]:
    """Percentile bootstrap 95% CI over per-sample WERs
    (notebooks/gen_error_bars.py analog)."""
    rng = np.random.default_rng(seed)
    wers = np.asarray(per_sample_wers)
    if len(wers) == 0:
        return (0.0, 0.0)
    means = np.array([
        rng.choice(wers, size=len(wers), replace=True).mean()
        for _ in range(n_boot)
    ])
    return float(np.percentile(means, 2.5)), float(np.percentile(means, 97.5))


def main(argv: Optional[List[str]] = None):
    """CLI: ``python -m olmoasr_tpu_torch.eval.harness --eval_set ... --ckpt ...``;
    the JAX CLI's flags and defaults plus ``--device`` (the card unless the
    caller asks for the CPU). Prints the result's json as its last line.

    Under torchrun every rank joins the group and each decode batch is split
    across the ranks (``decoding.join_infer_mesh``; a ragged last batch
    decodes whole on every rank); a bare ``--device cuda`` is each rank's
    ``cuda:{LOCAL_RANK}``. Every rank computes; rank 0 alone prints, writes
    the results and logs."""
    import argparse

    from olmoasr_tpu_torch.api import load_model
    from olmoasr_tpu_torch.decoding import join_infer_mesh, leave_infer_mesh
    from olmoasr_tpu_torch.parallel import mesh as mesh_mod

    p = argparse.ArgumentParser()
    p.add_argument("--eval_set", required=True)
    p.add_argument("--eval_dir", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--long_form", action="store_true")
    p.add_argument("--out_dir", default="eval_results")
    p.add_argument("--kv_quant", action="store_true")
    p.add_argument("--wandb", action="store_true",
                   help="log metrics + per-sample table to wandb "
                   "(reference WandBLogger, eval.py:1463-1645)")
    p.add_argument("--device", default="cuda", help="device to evaluate on")
    args = p.parse_args(argv)

    created = join_infer_mesh(args.device)
    try:
        writes = mesh_mod.rank() == 0
        device = mesh_mod.rank_device(args.device) if mesh_mod.world_size() > 1 else args.device
        model = load_model(args.ckpt, device=device, inference=True)
        if args.long_form:
            result = long_form_eval(
                model, args.eval_set, args.eval_dir, max_samples=args.max_samples,
                verbose=writes,
            )
        else:
            result = short_form_eval(
                model, args.eval_set, args.eval_dir, batch_size=args.batch_size,
                max_samples=args.max_samples, kv_quant=args.kv_quant, verbose=writes,
            )
    finally:
        leave_infer_mesh(created)
    if not writes:
        return
    write_results(result, args.out_dir, os.path.basename(args.ckpt))
    if args.wandb:
        from olmoasr_tpu_torch.training.logging_utils import EVAL_TABLE_COLS, MetricsLogger

        logger = MetricsLogger(f"eval_{args.eval_set}")
        logger.log(
            {
                f"eval/{args.eval_set}/wer": result.wer,
                f"eval/{args.eval_set}/substitutions": result.substitutions,
                f"eval/{args.eval_set}/insertions": result.insertions,
                f"eval/{args.eval_set}/deletions": result.deletions,
                f"eval/{args.eval_set}/n_samples": result.n_samples,
                f"eval/{args.eval_set}/rtfx": result.rtfx,
            }
        )
        logger.log_table(
            f"eval/{args.eval_set}/samples",
            EVAL_TABLE_COLS,  # [global_step, eval_set, audio, pred, target, wer]
            [
                [0, args.eval_set, r["id"], r["hyp"], r["ref"], r["wer"]]
                for r in result.per_sample
            ],
        )
        logger.close()
    print(json.dumps(result.to_dict()))


if __name__ == "__main__":
    main()
