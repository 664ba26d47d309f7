"""Public API: ``load_model``, ``build_model`` and the ``OLMoASR`` model.

Counterpart of ``olmoasr_tpu/api.py``. ``OLMoASR`` is the torch module itself
(the reference's module tree and state-dict names) with the inference entry
points bound to it. ``load_model`` takes a released name or a local ``.pt``
or ``.npz``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from olmoasr_tpu_torch.models.dims import VARIANT_TO_DIMS
from olmoasr_tpu_torch.models import convert as convert_mod
from olmoasr_tpu_torch.models import whisper as model_mod


class OLMoASR(model_mod.Whisper):
    """Whisper-architecture model with ``transcribe``, ``decode``,
    ``detect_language``, ``embed_audio``, ``logits`` and ``forward``
    (reference ``OLMoASR`` API); ``forward``, ``device`` and ``dtype`` are
    the ``Whisper`` module's."""

    @property
    def is_multilingual(self) -> bool:
        return self.dims.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return self.dims.n_vocab - 51765 - int(self.is_multilingual)

    def num_params(self) -> int:
        """Elements of the parameters: the leaves of the JAX package's param
        tree. The encoder's sinusoidal ``positional_embedding`` is a buffer
        here and a constant there, so neither counts it."""
        return sum(p.numel() for p in self.parameters())

    def astype(self, dtype: torch.dtype) -> "OLMoASR":
        """The weights cast to ``dtype`` in place; returns the model."""
        return self.to(dtype)

    def half(self) -> "OLMoASR":
        """The weights cast to bf16 in place, as the JAX package's ``half``."""
        return self.astype(torch.bfloat16)

    @torch.no_grad()
    def embed_audio(self, mel: torch.Tensor) -> torch.Tensor:
        return model_mod.encode_audio(self, mel)

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, audio_features: torch.Tensor) -> torch.Tensor:
        """Full-sequence decoder logits (B, T, n_vocab) in fp32."""
        cache = model_mod.init_cache(self, audio_features, max_len=tokens.shape[1])
        return model_mod.decode_step(self, tokens.to(audio_features.device), cache)

    def decode(self, mel, options=None, **kwargs):
        """``decoding.decode``: in bf16 when ``options.fp16`` (the default),
        else in fp32, whatever the weights' dtype."""
        from olmoasr_tpu_torch import decoding

        if options is None:
            options = decoding.DecodingOptions(**kwargs)
        return decoding.decode(self, mel, options)

    def transcribe(self, audio, **kwargs):
        """Long-form ``transcribe.transcribe`` of one file or waveform."""
        from olmoasr_tpu_torch import transcribe as transcribe_mod

        return transcribe_mod.transcribe(self, audio, **kwargs)

    def detect_language(self, mel):
        """``decoding.detect_language``: (language ids, {code: probability})
        of a window or of a batch of windows."""
        from olmoasr_tpu_torch import decoding

        return decoding.detect_language(self, mel)


def _new_model(dims, include_padding_token, device, dtype) -> OLMoASR:
    return model_mod.empty_model(dims, include_padding_token, device, dtype, cls=OLMoASR)


def _released_path(name: str, download_root: Optional[str]) -> str:
    """Where the JAX package's ``_download`` leaves a released checkpoint:
    the URL's file name under ``download_root``, by default
    ``$XDG_CACHE_HOME/olmoasr`` (``~/.cache/olmoasr``)."""
    from olmoasr_tpu_torch import MODEL2LINK

    if download_root is None:
        default = os.path.join(os.path.expanduser("~"), ".cache")
        download_root = os.path.join(os.getenv("XDG_CACHE_HOME", default), "olmoasr")
    return os.path.join(download_root, os.path.basename(MODEL2LINK[name]))


def load_model(name: str, device="cuda", download_root: Optional[str] = None,
               inference: bool = True, in_memory: bool = False, *,
               dtype: Optional[torch.dtype] = None) -> OLMoASR:
    """Load a released checkpoint by name (``available_models()``), a local
    reference ``.pt`` or the JAX package's ``.npz`` onto ``device`` (the card
    unless the caller asks for the CPU; no fallback). The signature is the
    JAX package's and the reference's, with ``dtype`` after it.

    A released name reads the file that a download leaves under
    ``download_root`` (see :func:`_released_path`); the port does not
    download, so a missing file raises FileNotFoundError with its URL. A
    name that is neither a released model nor a file raises RuntimeError,
    as in the JAX package. ``inference`` drops the training vocabulary's
    padding row. ``in_memory`` is accepted and ignored, as the JAX package
    does: the weights are read into memory either way. ``dtype`` defaults to
    the checkpoint's."""
    from olmoasr_tpu_torch import MODEL2LINK

    path = name
    if name in MODEL2LINK:
        path = _released_path(name, download_root)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{path}: released model {name} is not in the cache; fetch "
                f"{MODEL2LINK[name]} there (the port does not download)")
    elif not os.path.isfile(path):
        raise RuntimeError(f"Model {name} not found; available models = {list(MODEL2LINK)}")
    if path.endswith(".npz"):
        sd, dims = convert_mod.load_npz_checkpoint(path)
    else:
        sd, dims = convert_mod.load_torch_checkpoint(path)
    if inference:
        sd = convert_mod.strip_padding_row(sd)
    emb = sd["decoder.token_embedding.weight"]
    dtype = dtype or emb.dtype
    model = _new_model(dims, emb.shape[0] > dims.n_vocab, device, dtype)
    missing, _ = model.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"{path}: checkpoint lacks {missing}")
    return model.eval()


def build_model(variant: str, *, seed: int = 0, device="cuda",
                dtype: torch.dtype = torch.float32, inference: bool = True) -> OLMoASR:
    """Random-init model by variant name (``small.en``, ...), weights drawn
    from a ``torch.Generator`` seeded with ``seed``, on ``device`` (the card
    unless the caller asks for the CPU; no fallback)."""
    dims = VARIANT_TO_DIMS[variant]
    model = _new_model(dims, not inference, device, dtype)
    generator = torch.Generator().manual_seed(seed)
    model_mod.init_params(model, generator, include_padding_token=not inference)
    return model.eval()
