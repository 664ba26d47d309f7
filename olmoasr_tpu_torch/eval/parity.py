"""One-command real-weights WER parity harness.

Counterpart of ``olmoasr_tpu/eval/parity.py``. Given a released checkpoint
(by name, downloaded by ``load_model``) or a local ``.pt`` / ``.npz``, and
optionally the real ``gpt2.tiktoken`` rank file, it runs everything between
"weights appear" and "WER against the published baseline":

  1. points the tokenizer at the rank file, so that it uses GPT-2's BPE;
  2. checks the tokenizer against known GPT-2 ids;
  3. loads the checkpoint onto ``--device`` (the card unless the caller asks
     for the CPU);
  4. short-form evaluation (batched greedy, ``eval.harness.short_form_eval``);
  5. one long-form file (beam 5 / best_of 5, ``long_form_eval_single``);
  6. with the real tokenizer, freezes the token sequences of the first N
     utterances as a fixture for regression tests;
  7. prints the WER beside the published row for the variant.

    python -m olmoasr_tpu_torch.eval.parity --ckpt medium.en
    python -m olmoasr_tpu_torch.eval.parity --ckpt /path/medium.en.pt \\
        --ranks /path/gpt2.tiktoken --eval_dir eval_data \\
        --eval_set librispeech_clean --long_audio talk.wav --long_ref talk.txt
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# published short-form LibriSpeech test-clean/other WER (%) per variant
# (BASELINE.md, from the reference's README)
PUBLISHED_WER = {
    "tiny.en": {"librispeech_clean": 5.1, "librispeech_other": 12.3},
    "base.en": {"librispeech_clean": 3.7, "librispeech_other": 9.0},
    "small.en": {"librispeech_clean": 3.0, "librispeech_other": 7.0},
    "medium.en": {"librispeech_clean": 3.5, "librispeech_other": 5.7},
    "large.en": {"librispeech_clean": 2.6, "librispeech_other": 5.9},
    "large.en-v2": {"librispeech_clean": 2.7, "librispeech_other": 5.6},
}

# spot ids from the real GPT-2 vocabulary: a rank file must give these before
# any WER computed with it is trusted
GPT2_KNOWN_IDS = {
    " the": [262],
    " hello": [23748],
    "The": [464],
    " world": [995],
    "a": [64],
}


def check_tokenizer(strict: bool) -> bool:
    """True when the tokenizer runs on real GPT-2 ranks that give the known
    ids; False (with a warning) on the byte fallback unless ``strict``, which
    exits. Ranks that give other ids exit."""
    from olmoasr_tpu_torch.tokenizer import get_encoding

    enc = get_encoding()
    real = type(enc).__name__ == "BytePairEncoder"
    if not real:
        msg = ("no gpt2.tiktoken rank file found -> byte-fallback tokenizer; "
               "WER is NOT comparable to the baseline")
        if strict:
            raise SystemExit(f"parity: {msg}")
        print(f"parity: WARNING: {msg}")
        return False
    bad = {t: enc.encode(t) for t, ids in GPT2_KNOWN_IDS.items() if enc.encode(t) != ids}
    if bad:
        raise SystemExit(f"parity: rank file present but ids do not match GPT-2: {bad}")
    print("parity: tokenizer = real GPT-2 BPE (spot ids verified)")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help="released model name (downloads) or local .pt/.npz")
    ap.add_argument("--variant", default=None,
                    help="variant name for the baseline row (inferred from "
                    "--ckpt when it is a released name)")
    ap.add_argument("--ranks", default=None, help="path to gpt2.tiktoken")
    ap.add_argument("--eval_set", default="librispeech_clean")
    ap.add_argument("--eval_dir", default="eval_data")
    ap.add_argument("--max_samples", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--long_audio", default=None, help="one long-form file")
    ap.add_argument("--long_ref", default=None, help="its reference transcript")
    ap.add_argument("--out_dir", default="parity_out")
    ap.add_argument("--golden_n", type=int, default=8,
                    help="freeze token sequences for the first N utterances")
    ap.add_argument("--allow_fallback_tokenizer", action="store_true")
    ap.add_argument("--device", default="cuda", help="device to evaluate on")
    args = ap.parse_args(argv)

    if args.ranks:
        os.environ["OLMOASR_TIKTOKEN"] = args.ranks
    real_tok = check_tokenizer(strict=not args.allow_fallback_tokenizer)

    from olmoasr_tpu_torch.api import load_model
    from olmoasr_tpu_torch.eval.harness import (
        long_form_eval_single,
        short_form_eval,
        write_results,
    )

    model = load_model(args.ckpt, device=args.device, inference=True)
    variant = args.variant or (args.ckpt if not os.path.isfile(args.ckpt) else "?")
    os.makedirs(args.out_dir, exist_ok=True)

    # ---- short-form WER ----------------------------------------------------
    result = short_form_eval(
        model, args.eval_set, args.eval_dir,
        batch_size=args.batch_size, max_samples=args.max_samples,
    )
    write_results(result, args.out_dir, ckpt_name=str(variant).replace("/", "_"))
    published = PUBLISHED_WER.get(variant, {}).get(args.eval_set)
    line = (f"parity: short-form {args.eval_set}: WER {result.wer * 100:.2f}% "
            f"({result.n_samples} utts, RTFx {result.rtfx:.0f})")
    if published is not None:
        delta = result.wer * 100 - published
        line += f" | published {published:.1f}% | delta {delta:+.2f}"
    print(line)

    # ---- golden token fixtures ----------------------------------------------
    if args.golden_n and real_tok:
        import numpy as np
        import torch

        from olmoasr_tpu_torch.audio import log_mel_spectrogram_np, pad_or_trim
        from olmoasr_tpu_torch.decoding import DecodingOptions
        from olmoasr_tpu_torch.eval.datasets import DatasetFactory
        from olmoasr_tpu_torch.eval.harness import _item_waveform

        items = DatasetFactory.create_loader(args.eval_set, args.eval_dir).load()[: args.golden_n]
        mels = np.stack([log_mel_spectrogram_np(pad_or_trim(_item_waveform(it)))
                         for it in items])
        res = model.decode(torch.from_numpy(mels).to(model.device),
                           DecodingOptions(language="en", without_timestamps=True))
        golden = {it.id: {"tokens": r.tokens, "text": r.text} for it, r in zip(items, res)}
        gpath = os.path.join(args.out_dir, f"golden_{variant}.json")
        with open(gpath, "w") as f:
            json.dump(golden, f, indent=1)
        print(f"parity: froze {len(golden)} golden sequences -> {gpath} "
              f"(copy into tests/fixtures/ to pin)")

    # ---- long-form ----------------------------------------------------------
    if args.long_audio:
        wer = long_form_eval_single(model, args.long_audio, args.long_ref)
        print(f"parity: long-form {os.path.basename(args.long_audio)}: "
              f"WER {wer * 100:.2f}% (beam_size=5, best_of=5, timestamps)")

    return 0


if __name__ == "__main__":
    sys.exit(main())
