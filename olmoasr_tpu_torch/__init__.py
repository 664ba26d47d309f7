"""olmoasr_tpu_torch: the PyTorch/CUDA port of olmoasr_tpu for NVIDIA Hopper.

Counterpart of ``olmoasr_tpu/__init__.py``. It imports ``torch`` and never
``jax``, and nothing of the JAX package: the framework-free code it needs
(model dimensions, tokenizer, text utilities, writers, transcript parsing) is
copied here, each copy pinned to its original by ``tests/test_torch_copies.py``.
Hand-written CUDA kernels live in ``csrc/`` and build at first use
(``ops/_build.py``).
"""

from olmoasr_tpu_torch.models.dims import VARIANT_TO_DIMS, ModelDimensions
from olmoasr_tpu_torch.version import __version__

__all__ = ["ModelDimensions", "VARIANT_TO_DIMS", "load_model", "available_models", "build_model",
           "transcribe_many", "__version__"]

# Released OLMoASR checkpoints (olmoasr/__init__.py:23-30). The port does not
# download: ``load_model`` reads the file a download would leave in its cache.
MODEL2LINK = {
    "tiny.en": "https://huggingface.co/allenai/OLMoASR/resolve/main/models/OLMoASR-tiny.en.pt",
    "base.en": "https://huggingface.co/allenai/OLMoASR/resolve/main/models/OLMoASR-base.en.pt",
    "small.en": "https://huggingface.co/allenai/OLMoASR/resolve/main/models/OLMoASR-small.en.pt",
    "medium.en": "https://huggingface.co/allenai/OLMoASR/resolve/main/models/OLMoASR-medium.en.pt",
    "large.en": "https://huggingface.co/allenai/OLMoASR/resolve/main/models/OLMoASR-large.en.pt",
    "large.en-v2": "https://huggingface.co/allenai/OLMoASR/resolve/main/models/OLMoASR-large.en-v2.pt",
}


def available_models():
    return list(MODEL2LINK)


def load_model(*args, **kwargs):
    from olmoasr_tpu_torch.api import load_model as _load_model

    return _load_model(*args, **kwargs)


def build_model(*args, **kwargs):
    from olmoasr_tpu_torch.api import build_model as _build_model

    return _build_model(*args, **kwargs)


def transcribe_many(*args, **kwargs):
    from olmoasr_tpu_torch.transcribe import transcribe_many as _transcribe_many

    return _transcribe_many(*args, **kwargs)
