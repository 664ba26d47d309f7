"""Export to HuggingFace transformers (``WhisperForConditionalGeneration``).

Counterpart of ``olmoasr_tpu/integrations/hf.py`` (the reference's
``demo/convert_openai_to_hf.py``): the port's state dict (the reference's
names) becomes an HF Whisper state dict and model directory, so that HF
pipelines can run OLMoASR checkpoints. ``transformers`` is imported only by
the functions that build the HF model.

    python -m olmoasr_tpu_torch.integrations.hf --ckpt model.pt --out_dir hf_model
"""

from __future__ import annotations

from typing import Dict

import torch

from olmoasr_tpu_torch.models.dims import ModelDimensions
from olmoasr_tpu_torch.models.whisper import PADDING_TOKEN, sinusoids

# a residual block's entries: reference name -> HF name
_SELF = {
    "attn_ln": "self_attn_layer_norm", "attn.query": "self_attn.q_proj",
    "attn.key": "self_attn.k_proj", "attn.value": "self_attn.v_proj",
    "attn.out": "self_attn.out_proj",
}
_CROSS = {
    "cross_attn_ln": "encoder_attn_layer_norm", "cross_attn.query": "encoder_attn.q_proj",
    "cross_attn.key": "encoder_attn.k_proj", "cross_attn.value": "encoder_attn.v_proj",
    "cross_attn.out": "encoder_attn.out_proj",
}
_MLP = {"mlp_ln": "final_layer_norm", "mlp.0": "fc1", "mlp.2": "fc2"}
# the block entries in the JAX export's order, each with its parameters (the
# key projections have no bias)
_ORDER = (("attn_ln", "wb"), ("attn.query", "wb"), ("attn.key", "w"), ("attn.value", "wb"),
          ("attn.out", "wb"))
_CROSS_ORDER = (("cross_attn_ln", "wb"), ("cross_attn.query", "wb"), ("cross_attn.key", "w"),
                ("cross_attn.value", "wb"), ("cross_attn.out", "wb"))
_MLP_ORDER = (("mlp_ln", "wb"), ("mlp.0", "wb"), ("mlp.2", "wb"))


def params_to_hf_state_dict(sd: Dict[str, torch.Tensor],
                            dims: ModelDimensions) -> Dict[str, torch.Tensor]:
    """The port's state dict -> an HF ``WhisperForConditionalGeneration``
    state dict of fp32 CPU tensors, key for key the JAX export's (its
    ``params_to_hf_state_dict``); the token embedding without the training
    vocabulary's padding row, tied to ``proj_out``."""
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, t) -> None:
        t = torch.from_numpy(t) if not torch.is_tensor(t) else t
        out[name] = t.detach().to("cpu", torch.float32).contiguous()

    put("model.encoder.conv1.weight", sd["encoder.conv1.weight"])
    put("model.encoder.conv1.bias", sd["encoder.conv1.bias"])
    put("model.encoder.conv2.weight", sd["encoder.conv2.weight"])
    put("model.encoder.conv2.bias", sd["encoder.conv2.bias"])
    put("model.encoder.embed_positions.weight", sinusoids(dims.n_audio_ctx, dims.n_audio_state))
    put("model.encoder.layer_norm.weight", sd["encoder.ln_post.weight"])
    put("model.encoder.layer_norm.bias", sd["encoder.ln_post.bias"])

    def write_blocks(side: str, n_layer: int, cross: bool) -> None:
        order = _ORDER + (_CROSS_ORDER if cross else ()) + _MLP_ORDER
        names = {**_SELF, **_CROSS, **_MLP}
        for i in range(n_layer):
            src, dst = f"{side}.blocks.{i}", f"model.{side}.layers.{i}"
            for entry, params in order:
                put(f"{dst}.{names[entry]}.weight", sd[f"{src}.{entry}.weight"])
                if params == "wb":
                    put(f"{dst}.{names[entry]}.bias", sd[f"{src}.{entry}.bias"])

    write_blocks("encoder", dims.n_audio_layer, cross=False)
    write_blocks("decoder", dims.n_text_layer, cross=True)

    emb = sd["decoder.token_embedding.weight"]
    if emb.shape[0] == PADDING_TOKEN + 1:
        emb = emb[:PADDING_TOKEN]  # HF's vocabulary is the inference one
    put("model.decoder.embed_tokens.weight", emb)
    put("model.decoder.embed_positions.weight", sd["decoder.positional_embedding"])
    put("model.decoder.layer_norm.weight", sd["decoder.ln.weight"])
    put("model.decoder.layer_norm.bias", sd["decoder.ln.bias"])
    put("proj_out.weight", emb)  # tied
    return out


def make_hf_config(dims: ModelDimensions):
    """The HF ``WhisperConfig`` of ``dims``, with the JAX export's special
    token ids."""
    from transformers import WhisperConfig

    return WhisperConfig(
        vocab_size=dims.n_vocab,
        num_mel_bins=dims.n_mels,
        d_model=dims.n_audio_state,
        encoder_layers=dims.n_audio_layer,
        encoder_attention_heads=dims.n_audio_head,
        decoder_layers=dims.n_text_layer,
        decoder_attention_heads=dims.n_text_head,
        encoder_ffn_dim=dims.n_audio_state * 4,
        decoder_ffn_dim=dims.n_text_state * 4,
        max_source_positions=dims.n_audio_ctx,
        max_target_positions=dims.n_text_ctx,
        bos_token_id=50256,
        eos_token_id=50256,
        pad_token_id=50256,
        decoder_start_token_id=50257,  # <|startoftranscript|>
    )


def export_to_hf(sd: Dict[str, torch.Tensor], dims: ModelDimensions, out_dir: str) -> str:
    """Write a loadable HF model directory from the port's state dict;
    raises ValueError if the HF model lacks or does not know a key."""
    from transformers import WhisperForConditionalGeneration

    model = WhisperForConditionalGeneration(make_hf_config(dims))
    missing, unexpected = model.load_state_dict(params_to_hf_state_dict(sd, dims), strict=False)
    # the encoder's embed_positions is a registered buffer in some versions
    real_missing = [m for m in missing if "embed_positions" not in m]
    if real_missing or unexpected:
        raise ValueError(f"HF export mismatch: missing={real_missing} unexpected={unexpected}")
    model.save_pretrained(out_dir)
    return out_dir


def convert_checkpoint_to_hf(ckpt_path: str, out_dir: str) -> str:
    """A reference ``.pt`` or an ``.npz`` checkpoint -> an HF directory."""
    from olmoasr_tpu_torch.models.convert import (
        load_npz_checkpoint,
        load_torch_checkpoint,
        strip_padding_row,
    )

    if ckpt_path.endswith(".npz"):
        sd, dims = load_npz_checkpoint(ckpt_path)
    else:
        sd, dims = load_torch_checkpoint(ckpt_path)
        sd = strip_padding_row(sd)
    return export_to_hf(sd, dims, out_dir)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out_dir", required=True)
    a = p.parse_args()
    convert_checkpoint_to_hf(a.ckpt, a.out_dir)
