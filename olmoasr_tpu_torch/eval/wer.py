"""Word error rate: jiwer-equivalent corpus WER with substitution/insertion/
deletion counts.

The reference computes WER via jiwer (``scripts/eval/eval.py:1883-1885``,
``olmoasr/utils.py:376-388``, ``olmoasr/preprocess.py`` seg_edit_dist). This is
a dependency-free Levenshtein implementation with the same semantics:
whitespace tokenization, corpus-level aggregation (sum of edits / sum of
reference words).

A copy of ``olmoasr_tpu/eval/wer.py``: the port imports nothing of the JAX
package, and ``tests/test_torch_eval.py`` pins the copy to the original.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np


@dataclass(frozen=True)
class WERMeasures:
    wer: float
    substitutions: int
    insertions: int
    deletions: int
    hits: int
    ref_words: int
    hyp_words: int

    @property
    def mer(self) -> float:
        denom = self.hits + self.substitutions + self.insertions + self.deletions
        return (self.substitutions + self.insertions + self.deletions) / max(denom, 1)


def _edit_ops(ref: List[str], hyp: List[str]) -> Tuple[int, int, int, int]:
    """Levenshtein alignment; returns (subs, ins, dels, hits)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return 0, m, 0, 0
    if m == 0:
        return 0, 0, n, 0

    # dp over costs, vectorized across the hyp axis per ref row
    prev = np.arange(m + 1, dtype=np.int32)
    # backtrace matrix: 0=match,1=sub,2=ins,3=del
    ops = np.zeros((n + 1, m + 1), np.int8)
    ops[0, 1:] = 2
    ops[1:, 0] = 3
    hyp_arr = np.array(hyp)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, np.int32)
        cur[0] = i
        match = hyp_arr == ref[i - 1]
        for j in range(1, m + 1):
            sub_cost = prev[j - 1] + (0 if match[j - 1] else 1)
            ins_cost = cur[j - 1] + 1
            del_cost = prev[j] + 1
            best = min(sub_cost, ins_cost, del_cost)
            cur[j] = best
            if best == sub_cost:
                ops[i, j] = 0 if match[j - 1] else 1
            elif best == ins_cost:
                ops[i, j] = 2
            else:
                ops[i, j] = 3
        prev = cur

    # backtrace counts
    subs = ins = dels = hits = 0
    i, j = n, m
    while i > 0 or j > 0:
        op = ops[i, j]
        if i > 0 and j > 0 and op in (0, 1):
            if op == 0:
                hits += 1
            else:
                subs += 1
            i -= 1
            j -= 1
        elif j > 0 and op == 2:
            ins += 1
            j -= 1
        else:
            dels += 1
            i -= 1
    return subs, ins, dels, hits


def compute_measures(
    truth: Union[str, Sequence[str]],
    hypothesis: Union[str, Sequence[str]],
) -> WERMeasures:
    """Corpus-level measures (jiwer.compute_measures semantics)."""
    truths = [truth] if isinstance(truth, str) else list(truth)
    hyps = [hypothesis] if isinstance(hypothesis, str) else list(hypothesis)
    assert len(truths) == len(hyps), "truth/hypothesis count mismatch"

    total = dict(subs=0, ins=0, dels=0, hits=0, ref=0, hyp=0)
    for t, h in zip(truths, hyps):
        ref_words = t.split()
        hyp_words = h.split()
        s, i, d, hits = _edit_ops(ref_words, hyp_words)
        total["subs"] += s
        total["ins"] += i
        total["dels"] += d
        total["hits"] += hits
        total["ref"] += len(ref_words)
        total["hyp"] += len(hyp_words)

    denom = max(total["ref"], 1)
    return WERMeasures(
        wer=(total["subs"] + total["ins"] + total["dels"]) / denom,
        substitutions=total["subs"],
        insertions=total["ins"],
        deletions=total["dels"],
        hits=total["hits"],
        ref_words=total["ref"],
        hyp_words=total["hyp"],
    )


def wer(truth, hypothesis) -> float:
    return compute_measures(truth, hypothesis).wer


def calculate_wer(pairs: Sequence[Tuple[str, str]]) -> float:
    """olmoasr/utils.py:376-388 parity: list of (ref, hyp) -> corpus WER."""
    if not pairs:
        return 0.0
    refs, hyps = zip(*pairs)
    return wer(list(refs), list(hyps))
