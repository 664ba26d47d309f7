"""Public API: ``load_model``, ``build_model`` and the ``OLMoASR`` model.

Counterpart of ``olmoasr_tpu/api.py``. ``OLMoASR`` is the torch module itself
(the reference's module tree and state-dict names) with the inference entry
points bound to it. ``load_model`` takes a released name or a local ``.pt``
or ``.npz``.
"""

from __future__ import annotations

import os
import urllib.request
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


def _download(url: str, root: str) -> str:
    """``url``'s file under ``root`` (the JAX package's ``_download``): a file
    already there is used as it is, else it is fetched in 8 KiB reads. No
    checksum is checked, as there. The bytes go to a file of this process's
    own beside the target, moved into place once whole, so that no reader
    ever sees a part of the file and a cut download leaves no target."""
    os.makedirs(root, exist_ok=True)
    target = os.path.join(root, os.path.basename(url))
    if os.path.isfile(target):
        return target
    part = f"{target}.{os.getpid()}.part"
    try:
        with urllib.request.urlopen(url) as source, open(part, "wb") as output:
            while True:
                buffer = source.read(8192)
                if not buffer:
                    break
                output.write(buffer)
        os.replace(part, target)
    finally:
        if os.path.exists(part):
            os.remove(part)
    return target


def _download_released(url: str, root: str) -> str:
    """:func:`_download` of a released checkpoint. Under a process group of
    more than one rank (every rank loads the model), rank 0 downloads while
    the others wait, then learn whether it succeeded (rank 0 raises its
    error, the others a RuntimeError that names it); a rank that still
    finds no file (a ``root`` of its own host) downloads it itself. The wait
    is on a ``gloo`` group of its own with the server's control timeout,
    since a download may outlast a collective's."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return _download(url, root)
    from olmoasr_tpu_torch.parallel.mesh import CONTROL_TIMEOUT

    group = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
    failed, error = None, [None]
    try:
        if dist.get_rank() == 0:
            try:
                _download(url, root)
            except Exception as e:  # raised here once the others know
                failed, error = e, [f"{type(e).__name__}: {e}"]
        dist.broadcast_object_list(error, src=0, group=group)
    finally:
        dist.destroy_process_group(group)
    if failed is not None:
        raise failed
    if error[0] is not None:
        raise RuntimeError(f"rank 0 could not download {url}: {error[0]}")
    return _download(url, root)


def _new_model(dims, include_padding_token, device, dtype) -> OLMoASR:
    return model_mod.empty_model(dims, include_padding_token, device, dtype, cls=OLMoASR)


def _released_path(name: str, download_root: Optional[str]) -> str:
    """Where :func:`_download` leaves a released checkpoint: the URL's file
    name under ``download_root``, by default ``$XDG_CACHE_HOME/olmoasr``
    (``~/.cache/olmoasr``)."""
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

    A released name is downloaded from its ``MODEL2LINK`` URL into
    ``download_root`` (see :func:`_released_path`) unless the file is
    already there, as in the JAX package; under a process group rank 0
    downloads it and the others wait (:func:`_download_released`). A name
    that is neither a released model nor a file raises RuntimeError.
    ``inference`` drops the training vocabulary's padding row. ``in_memory``
    is accepted and ignored, as the JAX package does: the weights are read
    into memory either way. ``dtype`` defaults to the checkpoint's."""
    from olmoasr_tpu_torch import MODEL2LINK

    path = name
    if name in MODEL2LINK:
        path = _download_released(MODEL2LINK[name],
                                  os.path.dirname(_released_path(name, download_root)))
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
