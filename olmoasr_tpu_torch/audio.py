"""Audio frontend: 16 kHz log-mel spectrogram with the Whisper contract.

Counterpart of ``olmoasr_tpu/audio.py``. That module imports jax at its top,
so the constants, ``mel_filters_np``, ``pad_or_trim`` and ``load_audio`` are
copied here (tests pin them against the originals); ``log_mel_spectrogram``
runs in torch on the input tensor's device.

Contract: sample rate 16000, n_fft 400, hop 160, periodic Hann window,
centered reflect-padded frames, |stft|^2 with the last frame dropped, Slaney
mel filterbank, log10(max(mel, 1e-10)) floored at (max - 8), then (x + 4) / 4.
"""

from __future__ import annotations

import functools
from typing import Union

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480,000 samples in a 30-second chunk
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000 frames in a mel spectrogram input

N_SAMPLES_PER_TOKEN = HOP_LENGTH * 2  # initial convolutions has stride 2
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH  # 100 mel frames per second
TOKENS_PER_SECOND = SAMPLE_RATE // N_SAMPLES_PER_TOKEN  # 50 tokens per second


def _hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freq >= min_log_hz
    return np.where(
        log_t, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels
    )


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@functools.lru_cache(maxsize=None)
def mel_filters_np(n_mels: int = 80, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, float32 (n_mels, n_fft//2 + 1)."""
    fmax = sr / 2.0
    fft_freqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel_slaney(0.0), _hz_to_mel_slaney(fmax), n_mels + 2)
    mel_f = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f.reshape(-1, 1) - fft_freqs.reshape(1, -1)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm.reshape(-1, 1)
    return weights.astype(np.float32)


def pad_or_trim(array, length: int = N_SAMPLES, *, axis: int = -1):
    """Zero-pad or trim ``array`` (numpy or torch) to ``length`` along ``axis``."""
    if array.shape[axis] > length:
        sl = [slice(None)] * array.ndim
        sl[axis] = slice(0, length)
        array = array[tuple(sl)]
    if array.shape[axis] < length:
        if torch.is_tensor(array):
            ax = axis % array.ndim
            pad = [0, 0] * (array.ndim - 1 - ax) + [0, length - array.shape[axis]]
            array = torch.nn.functional.pad(array, pad)
        else:
            pad_widths = [(0, 0)] * array.ndim
            pad_widths[axis] = (0, length - array.shape[axis])
            array = np.pad(array, pad_widths)
    return array


def log_mel_spectrogram(
    audio: Union[str, np.ndarray, torch.Tensor],
    n_mels: int = 80,
    padding: int = 0,
    device=None,
) -> torch.Tensor:
    """Log-mel of a path, a 1-D waveform or a (B, samples) batch, on
    ``device`` (default: the tensor's own). int16 PCM is rescaled by 1/32768.
    Returns (n_mels, n_frames), or (B, n_mels, n_frames) for a batch."""
    if isinstance(audio, str):
        audio = load_audio(audio)
    if not torch.is_tensor(audio):
        audio = torch.from_numpy(np.asarray(audio))
    if device is not None:
        audio = audio.to(device)
    if audio.dtype == torch.int16:
        audio = audio.float() / 32768.0
    audio = audio.float()
    squeeze = audio.ndim == 1
    if squeeze:
        audio = audio[None]
    if padding > 0:
        audio = torch.nn.functional.pad(audio, (0, padding))
    window = torch.hann_window(N_FFT, device=audio.device)
    stft = torch.stft(audio, N_FFT, HOP_LENGTH, window=window, return_complex=True)
    magnitudes = stft[..., :-1].abs() ** 2  # (B, n_fft//2 + 1, frames)
    filters = torch.from_numpy(mel_filters_np(n_mels)).to(audio.device)
    mel_spec = filters @ magnitudes
    log_spec = torch.clamp(mel_spec, min=1e-10).log10()
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec[0] if squeeze else log_spec


def load_audio(path: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Load an audio file as float32 mono PCM at ``sr`` (wav/npy natively,
    other containers through the ffmpeg CLI when it is installed)."""
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.dtype == np.int16:
            return arr.astype(np.float32) / 32768.0
        return arr.astype(np.float32)
    if path.endswith(".wav"):
        import scipy.io.wavfile as wavfile

        rate, data = wavfile.read(path)
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            data = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32)
        if data.ndim == 2:
            data = data.mean(axis=1)
        if rate != sr:
            data = resample_poly(data, sr, rate)
        return data
    return _load_audio_ffmpeg(path, sr)


def resample_poly(x: np.ndarray, target_sr: int, source_sr: int) -> np.ndarray:
    """Polyphase resampling via scipy (host-side)."""
    from math import gcd

    from scipy.signal import resample_poly as _rp

    g = gcd(target_sr, source_sr)
    return _rp(x, target_sr // g, source_sr // g).astype(np.float32)


def _load_audio_ffmpeg(path: str, sr: int) -> np.ndarray:
    import shutil
    import subprocess

    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            f"cannot decode {path!r}: ffmpeg not available and file is not wav/npy"
        )
    cmd = [
        "ffmpeg", "-nostdin", "-threads", "0", "-i", path,
        "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le", "-ar", str(sr), "-",
    ]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, np.int16).flatten().astype(np.float32) / 32768.0
