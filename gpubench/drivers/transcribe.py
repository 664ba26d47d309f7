"""Short-form batch transcription: batches of 30 s windows, back to back, by
one client (an offline job or an eval), through ``OLMoASR.decode``.

Traffic parameters: ``batch`` windows a batch; ``pool_batches`` distinct
batches of PCM (cycled), each window Gaussian noise at a gain drawn from
``gain``, made on the card from the seed and kept in pinned host memory;
``decode``: the ``DecodingOptions`` (greedy, ``sample_len``, no timestamps,
bf16, ``kv_quant``); ``warmup_units``; ``trace_units``; ``check_windows``
windows compared with the reference. Each unit copies its batch's PCM to
the card, takes ``audio.log_mel_spectrogram`` there and decodes.

The check (after the window, the program freed): the reference's fp32
log-mel, encoder and teacher-forced decoder over the prompt and each
sampled window's served tokens (its end of text when it stopped early);
for each served token, how far its reference logit lies below the best
reference logit among the tokens the decoder's filters allow there.
``gap_max`` is the widest over the sample (the mean goes to standard
error).

A control of the traffic's ``controls`` puts the reference in a lower
precision in the program's place (``reference``): at each position of the
same prompts and served tokens the token that the lower precision puts
first is read against the reference. The reference draws the seed's
weights again: it takes nothing from the program's model."""

from __future__ import annotations

import gc
import json
import os
import sys
from typing import Any, Dict, List

import numpy as np
import torch

from gpubench.weights import make_state_dict, norm_seed

TOKENS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "reference", "tokens.json")


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic

    def end_to_end(self, window_s: float, counts: Dict[str, Any]) -> Dict[str, float]:
        """The end-to-end values of the measured window, by metric name."""
        return {"audio_s_per_s": counts["audio_s"] / window_s}

    def _weights(self) -> Dict[str, torch.Tensor]:
        return make_state_dict(self.ctx.dims, self.ctx.seed, self.ctx.device, torch.bfloat16)

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        import time

        t0 = time.perf_counter()
        from olmoasr_tpu_torch import audio as audio_mod
        from olmoasr_tpu_torch import decoding
        from olmoasr_tpu_torch.api import OLMoASR
        from olmoasr_tpu_torch.models import whisper as model_mod
        from olmoasr_tpu_torch.models.dims import ModelDimensions

        ctx, t = self.ctx, self.t
        self.audio_mod, self.model_mod = audio_mod, model_mod
        dev = ctx.device
        marks = [("imports", time.perf_counter())]
        model = OLMoASR(ModelDimensions(**ctx.dims), False, device="meta", dtype=torch.bfloat16)
        model.load_state_dict(self._weights(), assign=True)
        self.model = model.eval()
        self.options = decoding.DecodingOptions(**t["decode"])
        B, nb = t["batch"], t["pool_batches"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(norm_seed(ctx.seed) ^ 0x5EED)
        lo, hi = t["gain"]
        gains = lo + (hi - lo) * torch.rand(nb * B, 1, generator=gen, device=dev)
        pcm = torch.randn(nb * B, audio_mod.N_SAMPLES, generator=gen, device=dev) * gains
        pin = dev.startswith("cuda")
        self.pool = torch.empty(pcm.shape, dtype=torch.float32, pin_memory=pin)
        self.pool.copy_(pcm)
        del pcm, gains
        marks.append(("weights and inputs", time.perf_counter()))
        self.n_batches = 0
        scratch: Dict[str, Any] = {}
        for _ in range(t["warmup_units"]):
            self.unit(scratch)
        self.finish()
        self.n_batches = 0
        marks.append(("warm-up", time.perf_counter()))
        self.setup_phases = {k: b - a for (_, a), (k, b) in zip([("", t0)] + marks, marks)}

    # -- the timed path -------------------------------------------------------

    def unit(self, counts: Dict[str, Any]) -> None:
        ctx, B = self.ctx, self.t["batch"]
        b = self.n_batches % self.t["pool_batches"]
        self.n_batches += 1
        spans = ctx.spans
        with spans("h2d"):
            pcm = self.pool[b * B:(b + 1) * B].to(ctx.device, non_blocking=True)
        with spans("log_mel"):
            mel = self.audio_mod.log_mel_spectrogram(pcm)
        steps0 = self.model_mod.decode_step.single_steps
        with spans("decode"):
            results = self.model.decode(mel, self.options)
        steps = self.model_mod.decode_step.single_steps - steps0
        counts["units"] = counts.get("units", 0) + 1
        counts["attempted"] = counts.get("attempted", 0) + B
        counts["audio_s"] = counts.get("audio_s", 0.0) + 30.0 * B
        counts.setdefault("batches", []).append({"rows": B, "steps": steps})
        counts.setdefault("served", []).extend(
            (b * B + i, list(r.tokens)) for i, r in enumerate(results))

    def finish(self) -> None:
        if self.ctx.device.startswith("cuda"):
            torch.cuda.synchronize()

    # -- the check ------------------------------------------------------------

    def _sample(self, served: List) -> List:
        """The windows compared: the one with the most served tokens and
        ``check_windows - 1`` more drawn from the seed."""
        rng = np.random.default_rng((norm_seed(self.ctx.seed), 7))
        longest = max(range(len(served)), key=lambda i: len(served[i][1]))
        rest = [i for i in range(len(served)) if i != longest]
        k = min(self.t["check_windows"] - 1, len(rest))
        picked = [longest] + [rest[i] for i in rng.choice(len(rest), size=k, replace=False)]
        return [served[i] for i in picked]

    def check(self) -> Dict[str, float]:
        from gpubench.reference import whisper_ref as ref

        ctx = self.ctx
        sample = self._sample(ctx.window["counts"]["served"])
        del self.model
        gc.collect()
        if ctx.device.startswith("cuda"):
            torch.cuda.empty_cache()
        ref.strict_fp32()
        with open(TOKENS) as f:
            tk = json.load(f)
        V = ctx.dims["n_vocab"]
        allowed = torch.ones(V, dtype=torch.bool, device=ctx.device)
        for a, b in tk["blocked"]:
            allowed[a:b + 1] = False
        allowed_first = allowed.clone()
        allowed_first[tk["blocked_first"]] = False
        ref_prec = ref.Precision(**self.t["reference"])
        controls = [self.t["controls"][c]["reference"] for c in ctx.control]
        ctrl_prec = ref.Precision(**{**self.t["reference"], **controls[0]}) if controls else None
        p = {k: v.float() for k, v in self._weights().items()}
        gaps = []
        sample_len = self.t["decode"]["sample_len"]
        with torch.no_grad():
            for index, served in sample:
                pcm = self.pool[index:index + 1].to(ctx.device)
                audio = ref.encode(p, ctx.dims, ref.log_mel(pcm))
                fed = list(served) + ([tk["eot"]] if len(served) < sample_len else [])
                toks = torch.tensor([tk["prompt"] + fed[:-1]], device=ctx.device)
                first = len(tk["prompt"]) - 1
                logits = ref.decode(p, ctx.dims, toks, audio, prec=ref_prec)[0, first:]
                mask = torch.stack([allowed_first] + [allowed] * (len(fed) - 1))
                best = logits.masked_fill(~mask, float("-inf")).amax(dim=-1)
                if ctrl_prec is None:
                    chosen = torch.tensor(fed, device=ctx.device)
                else:  # the token that the lower precision puts first
                    low = ref.decode(p, ctx.dims, toks, ref.encode(p, ctx.dims, ref.log_mel(pcm),
                                                                   ctrl_prec), prec=ctrl_prec)
                    chosen = low[0, first:].masked_fill(~mask, float("-inf")).argmax(dim=-1)
                gaps.append(best - logits.gather(1, chosen[:, None])[:, 0])
        gaps = torch.cat(gaps)
        print(f"gpubench: {gaps.numel()} served tokens compared, mean gap {float(gaps.mean())!r}",
              file=sys.stderr)
        return {"gap_max": float(gaps.max())}
