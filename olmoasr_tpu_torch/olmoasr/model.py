"""``olmoasr.model`` on the port (the reference's training-model module):
``ModelDimensions``, ``OLMoASR`` and the model's functions of
``olmoasr_tpu_torch.models.whisper``."""

from olmoasr_tpu_torch.api import OLMoASR
from olmoasr_tpu_torch.models.dims import ModelDimensions
from olmoasr_tpu_torch.models.whisper import (
    forward_train,
    init_params,
    layer_norm,
    sdpa,
    sinusoids,
)

__all__ = [
    "ModelDimensions", "OLMoASR", "forward_train", "init_params",
    "layer_norm", "sdpa", "sinusoids",
]
