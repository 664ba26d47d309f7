"""The log-mel of the ``device_mel`` transport: a loader batch of 30 s int16
PCM through the port's ``audio.log_mel_spectrogram``, as ``train.loss_fn``
calls it, against the host's ``log_mel_spectrogram_np`` on the same samples
rescaled by 1/32768, to MEL_TOL. Each row's floor (its max - 8) is its own,
so a batch gives each row what that row gives alone. On the CPU here, and
on the card (``gpu``); the file imports no jax, so the card's machine runs
it with ``--noconftest``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from olmoasr_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram, log_mel_spectrogram_np

MEL_TOL = 1e-4  # log10 units / 4; the CPU's torch.stft agrees to about 2e-6


def _pcm(rows: int = 2) -> np.ndarray:
    rng = np.random.default_rng(11)
    pcm = rng.standard_normal((rows, N_SAMPLES)) * 3000
    pcm[1, : N_SAMPLES // 2] = 0  # digital silence: this row's floor binds
    pcm[1] *= 4  # and its max is the batch's
    return pcm.astype(np.int16)


def _check(device: str) -> None:
    pcm = _pcm()
    want = log_mel_spectrogram_np(pcm.astype(np.float32) / 32768.0)
    got = log_mel_spectrogram(torch.from_numpy(pcm).to(device), 80)
    assert got.dtype == torch.float32 and got.device.type == device
    assert got.shape == want.shape == (2, 80, 3000)
    err = float(np.abs(got.cpu().numpy() - want).max())
    assert err <= MEL_TOL, err
    alone = log_mel_spectrogram(torch.from_numpy(pcm[1]).to(device), 80)
    np.testing.assert_allclose(alone.cpu().numpy(), got[1].cpu().numpy(), atol=1e-5, rtol=0)
    # the floor is max - 8 in log10, (max - 2) after the scaling, per row
    lo, hi = got.amin(dim=(1, 2)), got.amax(dim=(1, 2))
    assert abs(float(lo[1] - (hi[1] - 2))) < 1e-5 and float(lo[0]) > float(hi[0] - 2)
    assert float(hi[1]) > float(hi[0])


def test_batch_log_mel_from_int16_matches_host_cpu():
    _check("cpu")


@pytest.mark.gpu
def test_batch_log_mel_from_int16_matches_host_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _check("cuda")
