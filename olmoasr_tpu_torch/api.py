"""Public API: ``load_model``, ``build_model`` and the ``OLMoASR`` model.

Counterpart of ``olmoasr_tpu/api.py``. ``OLMoASR`` is the torch module itself
(the reference's module tree and state-dict names) with the inference entry
points bound to it. ``load_model`` takes a local ``.pt`` or ``.npz``; released
names need a download and come with the full API port.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from olmoasr_tpu.models.dims import VARIANT_TO_DIMS
from olmoasr_tpu_torch.models import convert as convert_mod
from olmoasr_tpu_torch.models import whisper as model_mod


class OLMoASR(model_mod.Whisper):
    """Whisper-architecture model with ``transcribe``, ``decode``,
    ``embed_audio`` and ``logits`` (reference ``OLMoASR`` API)."""

    @property
    def is_multilingual(self) -> bool:
        return self.dims.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return self.dims.n_vocab - 51765 - int(self.is_multilingual)

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


def _new_model(dims, include_padding_token, device, dtype) -> OLMoASR:
    return model_mod.empty_model(dims, include_padding_token, device, dtype, cls=OLMoASR)


def load_model(path: str, device="cpu", inference: bool = True,
               dtype: Optional[torch.dtype] = None) -> OLMoASR:
    """Load a local reference ``.pt`` or the JAX package's ``.npz``.

    ``inference`` drops the training vocabulary's padding row. ``dtype``
    defaults to the checkpoint's."""
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path}: load_model takes a local .pt or .npz (released names need "
            "a download, which comes with the full API port)"
        )
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


def build_model(variant: str, *, seed: int = 0, device="cpu",
                dtype: torch.dtype = torch.float32, inference: bool = True) -> OLMoASR:
    """Random-init model by variant name (``small.en``, ...), weights drawn
    from a ``torch.Generator`` seeded with ``seed``."""
    dims = VARIANT_TO_DIMS[variant]
    model = _new_model(dims, not inference, device, dtype)
    generator = torch.Generator().manual_seed(seed)
    model_mod.init_params(model, generator, include_padding_token=not inference)
    return model.eval()
