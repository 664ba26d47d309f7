"""olmoasr_tpu_torch: the PyTorch/CUDA port of olmoasr_tpu for NVIDIA Hopper.

Counterpart of ``olmoasr_tpu/__init__.py``. It imports ``torch`` and never
``jax``; framework-free code (model dimensions, tokenizer, text utilities) is
shared with the JAX package, whose ``__init__`` imports nothing of jax.
Hand-written CUDA kernels live in ``csrc/`` and build at first use
(``ops/_build.py``).
"""

from olmoasr_tpu.models.dims import VARIANT_TO_DIMS, ModelDimensions
from olmoasr_tpu.version import __version__

__all__ = ["ModelDimensions", "VARIANT_TO_DIMS", "load_model", "build_model",
           "transcribe_many", "__version__"]


def load_model(*args, **kwargs):
    from olmoasr_tpu_torch.api import load_model as _load_model

    return _load_model(*args, **kwargs)


def build_model(*args, **kwargs):
    from olmoasr_tpu_torch.api import build_model as _build_model

    return _build_model(*args, **kwargs)


def transcribe_many(*args, **kwargs):
    from olmoasr_tpu_torch.transcribe import transcribe_many as _transcribe_many

    return _transcribe_many(*args, **kwargs)
