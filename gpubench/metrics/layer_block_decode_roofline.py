"""Row 7 ("sc": ``layer_block_decode`` -> ``csrc/decode_layer.cu``'s
``decode_layer_kernel``): the least time of its work in the traced window
(every decode step at its ring position, every layer; int8 cross K/V and
scales, the rings' valid positions, the weights; ``cost.layer_block_call``)
over the device time of that kernel."""

import json
import os

from gpubench import cost

KERNELS = r"decode_layer_kernel"
_TOKENS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "reference", "tokens.json")


def read(ctx):
    if ctx.trace is None or ctx.peak is None:
        return None
    n, secs = ctx.trace.kernel_seconds(KERNELS)
    batches = ctx.traced.get("batches", [])
    if n == 0 or secs <= 0 or not batches:
        return None
    with open(_TOKENS) as f:
        prompt = len(json.load(f)["prompt"])
    least = 0.0
    for b in batches:
        for i in range(b["steps"]):
            call = cost.layer_block_call(ctx.dims, b["rows"], prompt + i)
            least += ctx.dims["n_text_layer"] * cost.least_time_s(call["ops"], call["bytes"],
                                                                  ctx.peak)
    return 100.0 * least / secs
