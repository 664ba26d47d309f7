"""Gradio demo of the port: file transcription, a comparison with an HF
pipeline, and live microphone transcription.

Counterpart of ``olmoasr_tpu/demo/demo.py`` (the reference's ``demo/demo.py``
and ``demo/live_demo.py``). The transcription behind its tabs is
``transcribe_file`` and ``transcribe_mic``, module functions that run
without gradio. The checkpoint flow mirrors the reference demo's start:
``ensure_checkpoint`` downloads the released checkpoint from the HF hub
(``huggingface_hub``, imported when called; None offline) and
``export_hf`` converts one to an HF model directory
(``integrations/hf.py``), which ``_hf_pipeline`` serves as the Compare
tab's baseline. ``build_demo`` and ``main`` need gradio, imported when they
are called.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from olmoasr_tpu_torch.audio import SAMPLE_RATE, resample_poly

#: the reference demo's checkpoint source
OLMOASR_REPO = "olmoasr/OLMoASR-small.en"
CHECKPOINT_FILENAME = (
    "latesttrain_00524288_small_ddp-train_grad-acc_fp16_non_ddp_inf.pt"
)


def ensure_checkpoint(
    local_dir: str = "checkpoints",
    repo_id: str = OLMOASR_REPO,
    filename: str = CHECKPOINT_FILENAME,
) -> Optional[str]:
    """The released checkpoint's local path: ``local_dir/filename`` when it
    is there, else downloaded from the HF hub; None when that fails
    (offline, or no ``huggingface_hub``)."""
    path = os.path.join(local_dir, filename)
    if os.path.exists(path):
        return path
    try:
        from huggingface_hub import hf_hub_download  # only the download needs it

        os.makedirs(local_dir, exist_ok=True)
        return hf_hub_download(repo_id=repo_id, filename=filename, local_dir=local_dir)
    except Exception as e:  # offline / missing hub
        print(f"checkpoint download unavailable: {e}")
        return None


def export_hf(ckpt_path: str, out_dir: str) -> Optional[str]:
    """A ``.pt`` or ``.npz`` checkpoint as an HF
    ``WhisperForConditionalGeneration`` directory (``integrations/hf.py``);
    an existing export is reused; None when the export fails (no
    ``transformers``)."""
    if os.path.exists(os.path.join(out_dir, "config.json")):
        return out_dir
    try:
        from olmoasr_tpu_torch.integrations.hf import convert_checkpoint_to_hf

        return convert_checkpoint_to_hf(ckpt_path, out_dir)
    except Exception as e:
        print(f"HF export unavailable: {e}")
        return None


def _hf_pipeline(hf_model: str):
    """The HF speech-recognition pipeline of the Compare tab, or None when
    transformers or the model is not available."""
    try:
        from transformers import pipeline

        return pipeline("automatic-speech-recognition", model=hf_model, framework="pt")
    except Exception as e:
        print(f"HF pipeline unavailable: {e}")
        return None


def transcribe_file(model, audio_path: str, beam: bool, **options) -> str:
    """The File tab: ``model.transcribe`` of ``audio_path``, with
    ``beam_size=5, best_of=5`` when ``beam``; the text, then a line a
    segment, ``[start -> end] text``. ``options`` go to ``transcribe``."""
    kwargs = {"beam_size": 5, "best_of": 5} if beam else {}
    result = model.transcribe(audio_path, **kwargs, **options)
    lines = [f"[{s['start']:7.2f} -> {s['end']:7.2f}] {s['text']}" for s in result["segments"]]
    return result["text"].strip() + "\n\n" + "\n".join(lines)


def transcribe_mic(model, state: Optional[np.ndarray], new_chunk: Tuple[int, np.ndarray],
                   **options) -> Tuple[np.ndarray, str]:
    """The Live tab (live_demo.py's streaming semantics): ``new_chunk`` is
    gradio's ``(sample_rate, int16 samples)``, mono or (n, channels). The
    chunk is scaled to [-1, 1), downmixed, resampled to 16 kHz and appended
    to the rolling buffer ``state`` (None at the start), and the whole
    buffer is transcribed again. Returns the buffer and its text."""
    sr, chunk = new_chunk
    chunk = chunk.astype(np.float32) / 32768.0
    if chunk.ndim == 2:
        chunk = chunk.mean(axis=1)
    if sr != SAMPLE_RATE:
        chunk = resample_poly(chunk, SAMPLE_RATE, sr)
    stream = chunk if state is None else np.concatenate([state, chunk])
    return stream, model.transcribe(stream, **options)["text"]


def build_demo(model_name: str = "tiny.en", download_root: Optional[str] = None,
               hf_baseline: str = "openai/whisper-tiny.en", device: str = "cuda"):
    """The gradio app over the port's model: a File tab, a Compare tab (the
    model beside ``hf_baseline``'s HF pipeline, made at the first
    comparison) and a Live tab."""
    import gradio as gr  # only the UI needs it

    from olmoasr_tpu_torch.api import load_model

    model = load_model(model_name, device=device, download_root=download_root, inference=True)
    hf_pipe = None

    def compare(audio_path: str):
        nonlocal hf_pipe
        ours = model.transcribe(audio_path)["text"].strip()
        if hf_pipe is None:
            hf_pipe = _hf_pipeline(hf_baseline)
        if hf_pipe is None:
            return ours, "(HF baseline unavailable offline)"
        theirs = hf_pipe(audio_path, return_timestamps=True)["text"].strip()
        return ours, theirs

    with gr.Blocks(title="OLMoASR") as demo:
        gr.Markdown(f"# OLMoASR demo ({model_name})")
        with gr.Tab("File"):
            audio_in = gr.Audio(type="filepath", label="Audio file")
            beam = gr.Checkbox(label="Beam search (beam=5, best_of=5)")
            out = gr.Textbox(label="Transcript", lines=12)
            gr.Button("Transcribe").click(
                lambda path, b: transcribe_file(model, path, b), [audio_in, beam], out)
        with gr.Tab("Compare"):
            cmp_in = gr.Audio(type="filepath", label="Audio file")
            with gr.Row():
                ours_out = gr.Textbox(label=f"OLMoASR ({model_name})", lines=10)
                hf_out = gr.Textbox(label=f"HF pipeline ({hf_baseline})", lines=10)
            gr.Button("Compare").click(compare, [cmp_in], [ours_out, hf_out])
        with gr.Tab("Live"):
            state = gr.State()
            mic = gr.Audio(sources=["microphone"], streaming=True)
            live_out = gr.Textbox(label="Live transcript")
            mic.stream(lambda s, c: transcribe_mic(model, s, c), [state, mic], [state, live_out])
    return demo


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--model", default="tiny.en")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    build_demo(args.model, device=args.device).launch(server_port=args.port)


if __name__ == "__main__":
    main()
