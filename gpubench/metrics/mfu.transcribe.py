"""The measured window's model FLOPs over its seconds, as a share of the
card's dense bf16 peak: per window the encoder and the cross K/V
projections, per token row the prompt's positions and each decode step's
(``cost.decoder_flops_per_token`` at its position)."""

import json
import os

from gpubench import cost

_TOKENS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "reference", "tokens.json")


def read(ctx):
    batches = ctx.window.get("counts", {}).get("batches", [])
    if ctx.peak is None or not batches:
        return None
    with open(_TOKENS) as f:
        prompt = len(json.load(f)["prompt"])
    d = ctx.dims
    per_window = cost.encoder_flops_per_window(d) + cost.cross_kv_flops_per_window(d)
    flops = 0.0
    for b in batches:
        positions = range(prompt + b["steps"])
        flops += b["rows"] * (per_window + sum(cost.decoder_flops_per_token(d, p)
                                                for p in positions))
    return 100.0 * flops / (ctx.window["seconds"] * ctx.peak["bf16_flops_per_s"])
