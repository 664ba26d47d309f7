"""``import olmoasr`` for the port: the reference's public surface
(``olmoasr.load_model(name, device=..., inference=...).transcribe(...)``,
``olmoasr.utils``, ``olmoasr.preprocess``) on ``olmoasr_tpu_torch``.

Counterpart of the top-level ``olmoasr`` shim, which is bound to the JAX
package: the same modules and names (``__all__`` module by module), each
mapped onto the port. Use it as ``from olmoasr_tpu_torch import olmoasr``.
Every import here goes through ``olmoasr_tpu_torch.olmoasr``: inside this
subpackage a bare ``olmoasr`` would be the JAX shim.
"""

from olmoasr_tpu_torch import MODEL2LINK, available_models
from olmoasr_tpu_torch.api import OLMoASR, load_model
from olmoasr_tpu_torch.models.dims import VARIANT_TO_DIMS, ModelDimensions
from olmoasr_tpu_torch.transcribe import transcribe

# module-form imports, as the shim (and the reference package) offer them
from olmoasr_tpu_torch.olmoasr import inf_model, model, preprocess, utils  # noqa: E402,F401

__all__ = [
    "MODEL2LINK",
    "ModelDimensions",
    "OLMoASR",
    "VARIANT_TO_DIMS",
    "available_models",
    "load_model",
    "transcribe",
]
