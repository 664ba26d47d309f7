"""Model dimensions for the OLMoASR/Whisper family.

A copy of ``olmoasr_tpu/models/dims.py``: the port imports nothing of the JAX package, and
``tests/test_torch_copies.py`` pins the copy to the original.

Mirrors ``olmoasr/config/model_dims.py:4-89`` (same field names so
checkpoints' ``dims`` dicts round-trip) and adds the ``.en`` aliases the loader
accepts (``olmoasr/__init__.py:23-30``).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict


@dataclass(frozen=True)
class ModelDimensions:
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int

    def to_dict(self) -> Dict[str, int]:
        return asdict(self)


def _dims(state: int, head: int, layer: int) -> ModelDimensions:
    return ModelDimensions(
        n_mels=80,
        n_audio_ctx=1500,
        n_audio_state=state,
        n_audio_head=head,
        n_audio_layer=layer,
        n_vocab=51864,
        n_text_ctx=448,
        n_text_state=state,
        n_text_head=head,
        n_text_layer=layer,
    )


VARIANT_TO_DIMS: Dict[str, ModelDimensions] = {
    "tiny": _dims(384, 6, 4),
    "base": _dims(512, 8, 6),
    "small": _dims(768, 12, 12),
    "medium": _dims(1024, 16, 24),
    "large": _dims(1280, 20, 32),
}
# .en aliases (all OLMoASR models are English-only)
for _name in list(VARIANT_TO_DIMS):
    VARIANT_TO_DIMS[f"{_name}.en"] = VARIANT_TO_DIMS[_name]
VARIANT_TO_DIMS["large.en-v2"] = VARIANT_TO_DIMS["large"]


def param_count(dims: ModelDimensions, include_padding_token: bool = False) -> int:
    """Approximate parameter count (matches the reference's reported 39M→1.5B)."""
    d, v = dims.n_audio_state, dims.n_vocab + (1 if include_padding_token else 0)
    per_block = 4 * d * d + 3 * d + 2 * d + (8 * d * d + 5 * d) + 2 * d
    enc = (3 * dims.n_mels * d + d) + (3 * d * d + d) + dims.n_audio_layer * per_block + 2 * d
    cross = dims.n_text_layer * (4 * d * d + 3 * d + 2 * d)
    dec = v * d + dims.n_text_ctx * d + dims.n_text_layer * per_block + cross + 2 * d
    return enc + dec
