"""Gradio demo of the port: file transcription and live microphone
transcription.

Counterpart of ``olmoasr_tpu/demo/demo.py`` (the reference's ``demo/demo.py``
and ``demo/live_demo.py``). The transcription behind its tabs is
``transcribe_file`` and ``transcribe_mic``, module functions that run
without gradio; ``build_demo`` and ``main`` need gradio, imported when they
are called. Left out: the JAX demo's Compare tab (an HF ``transformers``
pipeline beside the model), ``ensure_checkpoint`` (a download from the HF
hub; the port reads local checkpoints only) and ``export_hf`` (its
``integrations/hf`` converter is not ported).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from olmoasr_tpu_torch.audio import SAMPLE_RATE, resample_poly


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
               device: str = "cuda"):
    """The gradio app: a File tab and a Live tab over the port's model."""
    import gradio as gr  # only the UI needs it

    from olmoasr_tpu_torch.api import load_model

    model = load_model(model_name, device=device, download_root=download_root, inference=True)

    with gr.Blocks(title="OLMoASR") as demo:
        gr.Markdown(f"# OLMoASR demo ({model_name})")
        with gr.Tab("File"):
            audio_in = gr.Audio(type="filepath", label="Audio file")
            beam = gr.Checkbox(label="Beam search (beam=5, best_of=5)")
            out = gr.Textbox(label="Transcript", lines=12)
            gr.Button("Transcribe").click(
                lambda path, b: transcribe_file(model, path, b), [audio_in, beam], out)
        with gr.Tab("Live"):
            state = gr.State()
            mic = gr.Audio(sources=["microphone"], streaming=True)
            live_out = gr.Textbox(label="Live transcript")
            mic.stream(lambda s, c: transcribe_mic(model, s, c), [state, mic], [state, live_out])
    return demo


def main():
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--model", default="tiny.en")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    build_demo(args.model, device=args.device).launch(server_port=args.port)


if __name__ == "__main__":
    main()
