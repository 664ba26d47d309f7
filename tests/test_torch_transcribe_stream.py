"""The port's streamed long-form transport (``_StreamedMelGroup``,
``_gather_windows_norm``, ``audio.log_mel_chunk_unnorm``) on the CPU.

Each test of ``tests/test_transcribe_stream.py`` runs here on the port: the
chunked unnormalized log-mel equals the whole-row log-mel bit for bit, int16
and f32 rows; the int16 rescale; the chunk builder's int16 transport and its
f32 fallback; ``transcribe_many`` equal to ``transcribe`` of each file, with
digital silence, with f32 audio that is not int16-exact, and with the
stale-max guard forced (``poll`` disabled), which re-runs exactly the
affected file (``transcribe_many.stale_max_reruns``).

Then the port against the JAX package on the same numpy inputs: the copied
chunk builders bit-equal; ``log_mel_chunk_unnorm`` normalized with the same
max within the log-mel tolerance (atol 1e-4, as tests/test_torch_decoding.py
holds the whole-row log-mel); ``_gather_windows_norm`` on one unnormalized
buffer within 1e-6, its window minima and maxes equal. Every window a
``transcribe_many`` round gathers is bit-equal to the window of the file's
whole-file log-mel, the path ``transcribe`` takes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch

from olmoasr_tpu import audio as jaudio
from olmoasr_tpu import transcribe as jtr
from olmoasr_tpu_torch import transcribe as tr
from olmoasr_tpu_torch.api import _new_model
from olmoasr_tpu_torch.audio import (
    HOP_LENGTH,
    N_FFT,
    N_FRAMES,
    N_SAMPLES,
    log_mel_chunk_unnorm,
    log_mel_spectrogram,
)
from olmoasr_tpu_torch.models import whisper as tm
from olmoasr_tpu_torch.models.dims import ModelDimensions

MEL_TOL = 1e-4  # the port's log-mel against the JAX package's (test_torch_decoding.py)
GATHER_TOL = 1e-6  # the same normalization of the same buffer, two libraries

KW = dict(
    temperature=0.0, compression_ratio_threshold=None, logprob_threshold=None,
    no_speech_threshold=None, without_timestamps=True, beam_size=None, best_of=None,
    sample_len=12, fp16=False,
)


def _noise(sec, seed=0, scale=0.05):
    """Seeded noise whose samples are exact int16 PCM values."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(16000 * sec) * scale * 32768
    return np.round(w).clip(-32768, 32767).astype(np.float32) / 32768.0


def _raw(sec, seed):
    """Seeded f32 noise that is not int16-exact."""
    return (np.random.default_rng(seed).standard_normal(16000 * sec) * 0.05).astype(np.float32)


def _group(n_real: int) -> tr._StreamedMelGroup:
    """A group with only what the chunk builders read, int16 transport on
    (the JAX package's, and the CPU's)."""
    grp = tr._StreamedMelGroup.__new__(tr._StreamedMelGroup)
    grp.n_real = n_real
    grp._int16 = True
    return grp


@pytest.fixture(scope="module")
def model():
    dims = ModelDimensions(
        n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=1,
        n_vocab=51864, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=1,
    )
    m = _new_model(dims, False, "cpu", torch.float32)
    tm.init_params(m, torch.Generator().manual_seed(0))
    return m.eval()


def _same_as_transcribe(model, outs, wavs):
    for i, o in enumerate(outs):
        s = tr.transcribe(model, wavs[i], **KW)
        assert o["text"] == s["text"], i
        assert [g["tokens"] for g in o["segments"]] == [g["tokens"] for g in s["segments"]], i
        assert [g["seek"] for g in o["segments"]] == [g["seek"] for g in s["segments"]], i


# ---------------------------------------------------------------------------
# the chunked log-mel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,scale", [(np.int16, 32768.0), (np.float32, 1.0)])
def test_slice_chunks_match_whole_row(dtype, scale):
    """Chunked unnormalized log-mel == whole-row log-mel, bit for bit, for
    int16 and f32 rows (the same window, framing and filterbank)."""
    rng = np.random.default_rng(3)
    max_len = 2 * N_SAMPLES
    pcm = (rng.standard_normal((2, max_len)) * 0.05 * scale).astype(dtype)
    whole = log_mel_spectrogram(torch.from_numpy(pcm), 80, padding=N_SAMPLES).numpy()

    # the streaming decomposition: reflect head + per-slice halo chunks + zero tail
    f32 = pcm.astype(np.float32) / (scale if dtype == np.int16 else 1)
    padded = np.pad(f32, [(0, 0), (0, N_SAMPLES)])
    padded = np.pad(padded, [(0, 0), (N_FFT // 2, N_FFT // 2)], "reflect")
    n_real = max_len // N_SAMPLES
    logs, mx = [], np.full((2,), -1e30, np.float32)
    for s in range(n_real + 1):
        n_sl = 1 if s < n_real else 2
        chunk = padded[:, s * N_SAMPLES: (s + n_sl) * N_SAMPLES + tr._CHUNK_HALO]
        ls, m = log_mel_chunk_unnorm(torch.from_numpy(np.ascontiguousarray(chunk)), 80)
        logs.append(ls.numpy())
        mx = np.maximum(mx, m.numpy())
    unnorm = np.concatenate(logs, axis=2)
    norm = (np.maximum(unnorm, mx[:, None, None] - 8.0) + 4.0) / 4.0
    np.testing.assert_array_equal(norm[:, :, :whole.shape[2]], whole)


def test_int16_chunk_rescale_matches_f32():
    pcm = np.array([[0, 100, -32768, 32767] * 200 * 150], np.int16)
    pad = np.zeros((1, N_SAMPLES + N_FFT - HOP_LENGTH - pcm.shape[1]), np.int16)
    chunk = np.concatenate([pcm, pad], axis=1)
    a, ma = log_mel_chunk_unnorm(torch.from_numpy(chunk), 80)
    b, mb = log_mel_chunk_unnorm(torch.from_numpy(chunk.astype(np.float32) / 32768.0), 80)
    assert a.shape == (1, 80, N_FRAMES) and a.dtype == torch.float32
    assert torch.equal(a, b) and torch.equal(ma, mb)


def test_log_mel_chunk_unnorm_matches_jax():
    """The port's chunk log-mel and the JAX package's (a strided
    convolution) on the same int16 and f32 chunks, both normalized with the
    same max: within the log-mel tolerance; each row's max as close."""
    rng = np.random.default_rng(5)
    f32 = (rng.standard_normal((3, N_SAMPLES + tr._CHUNK_HALO)) * 0.1).astype(np.float32)
    f32[1, : 16000 * 4] = 0.0  # digital silence: frames at the floor
    i16 = (f32 * 16000).astype(np.int16)
    for chunk in (f32, i16):
        got, gmax = log_mel_chunk_unnorm(torch.from_numpy(chunk), 80)
        want, wmax = jaudio.log_mel_chunk_unnorm(jnp.asarray(chunk), 80)
        want, wmax = np.asarray(want), np.asarray(wmax)
        assert got.shape == want.shape == (3, 80, N_FRAMES)
        np.testing.assert_allclose(gmax.numpy(), wmax, atol=MEL_TOL, rtol=0)
        m = wmax[:, None, None]
        np.testing.assert_allclose((np.maximum(got.numpy(), m - 8.0) + 4.0) / 4.0,
                                   (np.maximum(want, m - 8.0) + 4.0) / 4.0, atol=MEL_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the chunk builders and the gather
# ---------------------------------------------------------------------------


def test_chunk_build_int16_direct_vs_f32_fallback():
    """_build_chunk builds int16 directly for PCM-representable rows and
    falls back to f32 otherwise; the int16 chunk rescaled equals the f32
    assembly of the same rows."""
    rows = [_noise(61, seed=4), _noise(45, seed=5), np.zeros(0, np.float32)]
    grp = _group(3)
    for s in range(grp.n_real + 1):
        c = grp._build_chunk(rows, s)
        assert c.dtype == np.int16, s
        np.testing.assert_array_equal(c.astype(np.float32) / 32768.0, grp._build_f32(rows, s),
                                      err_msg=f"chunk {s}")
    bad = rows[0].copy()
    bad[7] = 1.0 / 3.0  # one sample off the PCM grid: the chunk goes as f32
    c = grp._build_chunk([bad, rows[1]], 0)
    assert c.dtype == np.float32
    np.testing.assert_array_equal(c, grp._build_f32([bad, rows[1]], 0))


@pytest.mark.parametrize("case", ["pcm", "raw", "short", "tail"])
def test_chunk_builders_match_jax(case):
    """The port's copies of ``_build_chunk`` and ``_build_f32`` give the JAX
    package's arrays bit for bit, at every chunk of the group."""
    rows = {
        "pcm": [_noise(61, seed=4), _noise(45, seed=5), np.zeros(0, np.float32)],
        "raw": [_raw(50, 6), _noise(31, seed=7)],
        "short": [_noise(1, seed=8)[:150], _noise(1, seed=9)[:201], np.zeros(0, np.float32)],
        "tail": [_noise(60, seed=10), _raw(60, 11)[: 60 * 16000 - 50]],
    }[case]
    n_real = -(-max(len(r) for r in rows) // N_SAMPLES)
    mine, theirs = _group(n_real), jtr._StreamedMelGroup.__new__(jtr._StreamedMelGroup)
    theirs.n_real = n_real
    for s in range(n_real + 1):
        for build in ("_build_chunk", "_build_f32"):
            got, want = getattr(mine, build)(rows, s), getattr(theirs, build)(rows, s)
            assert got.dtype == want.dtype, (build, s)
            np.testing.assert_array_equal(got, want, err_msg=f"{build} chunk {s}")


def test_gather_windows_norm_matches_jax():
    """One unnormalized buffer through both gathers: windows within 1e-6,
    the window minima and the maxes used equal."""
    rng = np.random.default_rng(12)
    stack = (rng.standard_normal((3, 80, 4 * N_FRAMES)) * 2.0 - 3.0).astype(np.float32)
    rowmax = stack.max(axis=(1, 2)) - np.float32([0.0, 1.5, 0.25])  # one a running max
    rows, seeks, sizes = [0, 2, 1, 1], [0, 4000, 2999, 9000], [3000, 1234, 3000, 1]
    got = tr._gather_windows_norm(*(torch.from_numpy(np.asarray(a)) for a in
                                    (stack, rowmax, rows, seeks, sizes)))
    want = jtr._gather_windows_norm(*(jnp.asarray(a) for a in (stack, rowmax, rows, seeks,
                                                               sizes)))
    win, wmin, used = (g.numpy() for g in got)
    assert win.shape == (4, 80, N_FRAMES)
    np.testing.assert_allclose(win, np.asarray(want[0]), atol=GATHER_TOL, rtol=0)
    np.testing.assert_array_equal(wmin, np.asarray(want[1]))
    np.testing.assert_array_equal(used, np.asarray(want[2]))
    assert not win[3, :, 1:].any() and win[3, :, 0].all()  # frames past the size zeroed


@pytest.mark.parametrize("int16_transport", [None, False])
def test_streamed_windows_equal_whole_file_windows(model, monkeypatch, tmp_path,
                                                   int16_transport):
    """Every window a round gathers is bit-equal to the window of the file's
    whole-file log-mel (``transcribe``'s path): int16-exact rows, f32 rows,
    digital silence, a file given as a wav path, two groups; with the
    transport of the CPU (int16 where a chunk is exact PCM) and with the
    card's (float32 throughout)."""
    windows, transports = [], set()
    gather, put = tr._gather_round, tr._StreamedMelGroup._put

    def recording_gather(specs, groups, gather_w, guards):
        out = gather(specs, groups, gather_w, guards)
        windows.extend(zip([s[2:5] for s in specs], out))
        return out

    def recording_put(self, s, chunk):
        transports.add(str(chunk.dtype))
        return put(self, s, chunk)

    monkeypatch.setattr(tr, "_gather_round", recording_gather)
    monkeypatch.setattr(tr._StreamedMelGroup, "_put", recording_put)
    monkeypatch.setattr(tr._StreamedMelGroup, "int16_transport", int16_transport)
    monkeypatch.setattr(tr, "GROUP_BUDGET", 3 * 3 * N_SAMPLES)  # 3 rows of 90 s a group
    wavs = [_noise(65, seed=1), _raw(40, 2), _noise(31, seed=3), _raw(89, 4), _noise(7, seed=5)]
    wavs[0][16000 * 35: 16000 * 50] = 0.0
    path = str(tmp_path / "f2.wav")
    wavfile.write(path, 16000, (wavs[2] * 32768).astype(np.int16))
    audios = [wavs[0], torch.from_numpy(wavs[1]), path, wavs[3], wavs[4]]
    tr.transcribe_many(model, audios, batch_size=4, **KW)
    assert {i for (_, _, i), _ in windows} == set(range(5))
    assert len(windows) > 6  # more than one window of the long files
    whole = [log_mel_spectrogram(w, 80, padding=N_SAMPLES) for w in wavs]
    for (seek, size, i), got in windows:
        want = torch.nn.functional.pad(whole[i][:, seek: seek + size], (0, N_FRAMES - size))
        assert torch.equal(got, want), (i, seek, size)
    assert transports == ({"int16", "float32"} if int16_transport is None else {"float32"})


def test_groups_under_thread_switching():
    """Four groups at once (four builder threads beside this one), the
    interpreter switching threads every microsecond, ``poll`` in a loop
    until each group is complete: every buffer and running max equal to the
    one log-mel of its rows' whole padded length, every builder ended."""
    import sys

    rows = [[_noise(150, seed=10 * g + j) for j in range(2)] for g in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        groups = [tr._StreamedMelGroup(r, 5 * N_SAMPLES, 80, "cpu") for r in rows]
        for _ in range(10_000):
            for grp in groups:
                grp.poll()
            if all(grp.complete for grp in groups):
                break
        for grp in groups:
            grp.finish()
            grp.close()
    finally:
        sys.setswitchinterval(interval)
    for grp, r in zip(groups, rows):
        assert grp.complete and not grp._builder.is_alive()
        pcm = torch.from_numpy(np.stack(r))
        whole = log_mel_spectrogram(pcm, 80, padding=N_SAMPLES)
        n = whole.shape[-1]
        norm = (torch.maximum(grp.buf[:, :, :n], grp.rowmax[:, None, None] - 8.0) + 4.0) / 4.0
        assert torch.equal(norm, whole)


def test_builder_error_surfaces(model, monkeypatch):
    """An exception of the builder thread is raised in the caller."""

    def broken(self, rows, s):
        if s == 1:
            raise OSError("chunk 1 could not be built")
        return build(self, rows, s)

    build = tr._StreamedMelGroup._build_chunk
    monkeypatch.setattr(tr._StreamedMelGroup, "_build_chunk", broken)
    with pytest.raises(OSError, match="chunk 1"):
        tr.transcribe_many(model, [_noise(40, seed=1), _noise(35, seed=2)], batch_size=2, **KW)


# ---------------------------------------------------------------------------
# transcribe_many streamed against transcribe
# ---------------------------------------------------------------------------


def test_mixed_lengths_with_silence_match_sequential(model):
    wavs = [_noise(s, seed=s) for s in (45, 95, 61)]
    wavs[1][16000 * 40: 16000 * 55] = 0.0  # digital silence mid-file
    outs = tr.transcribe_many(model, wavs, batch_size=2, **KW)
    _same_as_transcribe(model, outs, wavs)


def test_stale_max_guard_reruns_affected_file(model, monkeypatch):
    """A file whose round-0 window is clamp-sensitive (digital silence in
    slice 0, the file's max in a later slice) runs again through the
    per-file path, and only that file; with ``poll`` disabled the running
    max stays stale. Both results equal ``transcribe`` of the file alone."""
    monkeypatch.setattr(tr._StreamedMelGroup, "poll", lambda self: None)
    quiet = _noise(30, seed=1, scale=0.0005)
    quiet[16000 * 2: 16000 * 20] = 0.0  # -10 floor bins in slice 0
    loud = _noise(35, seed=2, scale=0.3)  # the file's max lives in slice 1+
    w = np.concatenate([quiet, loud])
    other = _noise(65, seed=3)
    reruns = []
    transcribe = tr.transcribe

    def recording_transcribe(m, audio, **kw):
        reruns.append(audio)
        return transcribe(m, audio, **kw)

    monkeypatch.setattr(tr, "transcribe", recording_transcribe)
    monkeypatch.setattr(tr.transcribe_many, "stale_max_reruns", 0)
    outs = tr.transcribe_many(model, [w, other], batch_size=2, **KW)
    assert tr.transcribe_many.stale_max_reruns == 1
    assert len(reruns) == 1 and reruns[0] is w
    monkeypatch.setattr(tr, "transcribe", transcribe)
    _same_as_transcribe(model, outs, [w, other])


def test_non_pcm_audio_matches_sequential(model):
    """Raw f32 audio that is not int16-representable takes the f32
    transport and still matches the per-file path."""
    wavs = [_raw(45, 11), _raw(61, 12)]
    grp = _group(3)
    assert grp._build_chunk(wavs, 0).dtype == np.float32
    outs = tr.transcribe_many(model, wavs, batch_size=2, **KW)
    _same_as_transcribe(model, outs, wavs)


def test_no_rerun_when_upload_completes(model, monkeypatch):
    """Normal case: ``poll`` completes the group during round 0, later
    gathers use the final max, and nothing runs again."""
    monkeypatch.setattr(tr.transcribe_many, "stale_max_reruns", 0)
    wavs = [_noise(70, seed=9), _noise(70, seed=10)]
    outs = tr.transcribe_many(model, wavs, batch_size=2, **KW)
    assert tr.transcribe_many.stale_max_reruns == 0
    assert len(outs) == 2 and all(o["segments"] for o in outs)
