"""In-loop validation: teacher-forced loss + argmax-decode WER on held-out sets.

Counterpart of ``olmoasr_tpu/training/validate.py`` (the FSDP trainer's
validation, ``scripts/training/train_fsdp_timestamps.py:1925-2309``, and the
DDP trainer's in-loop train-WER, ``train_timestamps.py:1077-1196``): run the
training forward on validation batches, report the loss and the WER of the
greedy argmax predictions against the teacher-forced targets. One forward a
batch, on the model's device under ``torch.no_grad()``; only the loss and
the (B, T) argmax ids come back to the host.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from olmoasr_tpu_torch.eval.wer import compute_measures
from olmoasr_tpu_torch.models.whisper import PADDING_TOKEN
from olmoasr_tpu_torch.normalizers import EnglishTextNormalizer
from olmoasr_tpu_torch.tokenizer import get_tokenizer
from olmoasr_tpu_torch.training.train import loss_fn


def argmax_wer(
    logits: np.ndarray,  # (B, T, V) logits, or (B, T) precomputed argmax ids
    targets: np.ndarray,  # (B, T) with PADDING_TOKEN beyond the sequence
    tokenizer=None,
    normalizer=None,
) -> Tuple[float, List[Dict[str, str]]]:
    """Teacher-forced argmax WER (train_timestamps.py:1077-1196): decode the
    argmax prediction and the target, normalize, corpus WER. Pass the (B, T)
    argmax when it was computed on the device."""
    tokenizer = tokenizer or get_tokenizer(False)
    normalizer = normalizer or EnglishTextNormalizer()
    preds = logits if logits.ndim == 2 else logits.argmax(-1)
    refs, hyps, rows = [], [], []
    for b in range(targets.shape[0]):
        valid = targets[b] != PADDING_TOKEN
        ref = normalizer(tokenizer.decode(targets[b][valid].tolist()))
        hyp = normalizer(tokenizer.decode(preds[b][valid].tolist()))
        if not ref.strip():
            continue
        refs.append(ref)
        hyps.append(hyp)
        rows.append({"pred": hyp, "target": ref})
    if not refs:
        return 0.0, rows
    return compute_measures(refs, hyps).wer, rows


@torch.no_grad()
def validate(
    model,
    batches: Iterable[Dict[str, np.ndarray]],
    *,
    compute_dtype=torch.bfloat16,
    max_batches: Optional[int] = None,
) -> Dict[str, float]:
    """Validation loop: mean teacher-forced loss + corpus argmax WER over
    batches shaped like training micro-batches {mel, text_input,
    text_target[, padding_mask]} (numpy arrays or tensors), on the model's
    device. ``loss_fn`` runs once a batch (``remat=False,
    return_pred=True``)."""
    device = next(model.parameters()).device
    losses: List[float] = []
    all_refs: List[str] = []
    all_hyps: List[str] = []
    tokenizer = get_tokenizer(False)
    normalizer = EnglishTextNormalizer()

    def put(x):
        return None if x is None else torch.as_tensor(x).to(device)

    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        loss, aux = loss_fn(
            model, put(batch["mel"]), put(batch["text_input"]), put(batch["text_target"]),
            put(batch.get("padding_mask")), compute_dtype=compute_dtype, remat=False,
            return_pred=True,
        )
        losses.append(float(loss))
        targets = torch.as_tensor(batch["text_target"]).cpu().numpy()
        _, rows = argmax_wer(aux["pred"].cpu().numpy(), targets, tokenizer, normalizer)
        for r in rows:
            all_refs.append(r["target"])
            all_hyps.append(r["pred"])

    corpus = compute_measures(all_refs, all_hyps) if all_refs else None
    return {
        "val/loss": float(np.mean(losses)) if losses else float("nan"),
        "val/wer": corpus.wer if corpus else float("nan"),
        "val/n_batches": float(len(losses)),
    }
