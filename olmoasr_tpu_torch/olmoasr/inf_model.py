"""``olmoasr.inf_model`` on the port (the reference's inference-model
module): the KV-cached decoding surface is ``KVCache``, ``init_cache`` and
``decode_step`` of ``olmoasr_tpu_torch.models.whisper``."""

from olmoasr_tpu_torch.api import OLMoASR
from olmoasr_tpu_torch.models.dims import ModelDimensions
from olmoasr_tpu_torch.models.whisper import KVCache, decode_step, init_cache

__all__ = ["ModelDimensions", "OLMoASR", "KVCache", "decode_step", "init_cache"]
