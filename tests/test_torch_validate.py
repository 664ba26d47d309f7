"""The port's in-loop validation (``olmoasr_tpu_torch.training.validate``)
against the JAX package's, at micro dims on the CPU.

``argmax_wer`` on the same logits, argmax ids and targets gives the same WER
and rows. ``loss_fn(return_pred=True)``'s ``pred`` is JAX's ``aux["pred"]``,
and ``validate`` on the same weights and batches gives the same ``val/wer``
and ``val/loss`` within 1e-5 relative. The JAX side runs its Pallas attention
kernels in interpret mode, as ``tests/test_torch_training.py`` runs them
(they round P to bf16 as the port's twins do), fp32 compute on both sides.
The token embedding's text rows past the 256 byte tokens are zeroed, so that
the argmax picks byte tokens, which the offline tokenizer decodes to text;
the test checks that every argmax leads its runner-up by more than the
logits' difference can move it.

On the card (``gpu``, skipped without one): fp32 ``validate`` against the
CPU, and ``short_form_eval``'s hypotheses against ``model.decode`` run
directly on the same batches. The file imports jax only inside the tests
that compare with the JAX package, so the card's machine runs it with
``--noconftest``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from olmoasr_tpu_torch.models import convert
from olmoasr_tpu_torch.models import whisper as tm
from olmoasr_tpu_torch.models.dims import ModelDimensions
from olmoasr_tpu_torch.models.whisper import PADDING_TOKEN
from olmoasr_tpu_torch.tokenizer import get_tokenizer
from olmoasr_tpu_torch.training import train as ttrain
from olmoasr_tpu_torch.training import validate as tvalidate

MICRO = dict(n_mels=80, n_audio_ctx=40, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
             n_vocab=51864, n_text_ctx=24, n_text_state=128, n_text_head=2, n_text_layer=2)
LOSS_TOL = 1e-5
LOGIT_TOL = 1e-3  # the argmax must lead its runner-up by more than this
EOT = 50256


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, its model's attention on its Pallas
    kernels in interpret mode; undone after the module."""
    import jax
    import jax.numpy as jnp

    from olmoasr_tpu.models import whisper as jm
    from olmoasr_tpu.models.dims import ModelDimensions as JaxDims
    from olmoasr_tpu.ops.train_attention import enc_self_attention
    from olmoasr_tpu.training import train as jtrain
    from olmoasr_tpu.training import validate as jvalidate

    mp = pytest.MonkeyPatch()
    mp.setenv("OLMOASR_DEC_ATTN", "kernel_interpret")
    mp.setattr(jm, "sdpa", lambda q, k, v, n_head, mask=None, key_bias=None:
               enc_self_attention(q, k, v, n_head, interpret=True))
    yield dict(jax=jax, jnp=jnp, jm=jm, JaxDims=JaxDims, jtrain=jtrain, jvalidate=jvalidate)
    mp.undo()


@pytest.fixture(scope="module")
def params(jx):
    jax = jx["jax"]
    p = jax.tree.map(np.asarray, jx["jm"].init_params(jax.random.PRNGKey(1),
                                                      jx["JaxDims"](**MICRO),
                                                      include_padding_token=True))
    p["decoder"]["token_embedding"] = p["decoder"]["token_embedding"].copy()
    p["decoder"]["token_embedding"][256:EOT] = 0.0
    return p


def _model(params):
    dims = ModelDimensions(**MICRO)
    model = tm.empty_model(dims, include_padding_token=True)
    model.load_state_dict(convert.state_dict_from_jax_params(params, dims))
    return model


def _batch(seed, B=3):
    """Byte-token text behind the SOT sequence, padded to different lengths."""
    tok = get_tokenizer(False)
    rng = np.random.default_rng(seed)
    T = MICRO["n_text_ctx"]
    mel = rng.standard_normal((B, 80, 2 * MICRO["n_audio_ctx"])).astype(np.float32)
    inp = np.full((B, T), PADDING_TOKEN, np.int64)
    tgt = np.full((B, T), PADDING_TOKEN, np.int64)
    mask = np.full((B, T), -np.inf, np.float32)
    for b in range(B):
        words = tok.encode(" " + " ".join(rng.choice(["hello", "world", "again", "model"],
                                                     int(rng.integers(1, 4)))))
        ids = list(tok.sot_sequence_including_notimestamps) + words + [tok.eot]
        n = len(ids) - 1
        inp[b, :n], tgt[b, :n], mask[b, :n] = ids[:-1], ids[1:], 0.0
    return {"mel": mel, "text_input": inp, "text_target": tgt, "padding_mask": mask}


def test_argmax_wer_matches():
    from olmoasr_tpu.training import validate as jvalidate

    tok = get_tokenizer(False)
    rng = np.random.default_rng(0)
    B, T, V = 4, 20, 300
    targets = np.full((B, T), PADDING_TOKEN, np.int64)
    for b in range(B):
        ids = tok.encode(" hello world again"[: 6 + 3 * b])
        targets[b, :len(ids)] = ids
    targets[3] = PADDING_TOKEN  # an empty reference is skipped
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    for b in range(B):  # rows 0 and 1 predict their targets, row 2 not
        for t in range(T):
            if b < 2 and targets[b, t] != PADDING_TOKEN:
                logits[b, t, targets[b, t]] = 10.0
    for x in (logits, logits.argmax(-1)):
        got, want = tvalidate.argmax_wer(x, targets), jvalidate.argmax_wer(x, targets)
        assert got == want and len(got[1]) == 3 and 0 < got[0] < 1
    assert tvalidate.argmax_wer(logits[3:], targets[3:]) == (0.0, [])


def test_loss_fn_pred_matches_jax(jx, params):
    jax, jnp = jx["jax"], jx["jnp"]
    b = _batch(0)
    jloss, jaux = jax.jit(lambda p, *a: jx["jtrain"].loss_fn(
        p, jx["JaxDims"](**MICRO), *a, compute_dtype=jnp.float32, remat=False,
        return_pred=True))(
        jax.tree.map(jnp.asarray, params),
        *(jnp.asarray(b[k]) for k in ("mel", "text_input", "text_target", "padding_mask")))
    model = _model(params)
    args = [torch.from_numpy(b[k]) for k in ("mel", "text_input", "text_target", "padding_mask")]
    with torch.no_grad():
        loss, aux = ttrain.loss_fn(model, *args, compute_dtype=torch.float32, remat=False,
                                   return_pred=True)
        logits = tm.forward_train(model, *args[:2], args[3], compute_dtype=torch.float32)
    top2 = logits.topk(2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > LOGIT_TOL
    assert aux["pred"].shape == (3, MICRO["n_text_ctx"])
    np.testing.assert_array_equal(aux["pred"].numpy(), np.asarray(jaux["pred"]))
    assert (aux["pred"] < 256).any()  # byte tokens: the hypotheses have text
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    _, no_pred = ttrain.loss_fn(model, *args, compute_dtype=torch.float32, remat=False)
    assert "pred" not in no_pred


def test_validate_matches_jax(jx, params):
    jax, jnp = jx["jax"], jx["jnp"]
    batches = [_batch(1), _batch(2)]
    want = jx["jvalidate"].validate(jax.tree.map(jnp.asarray, params), jx["JaxDims"](**MICRO),
                                    batches, compute_dtype=jnp.float32)
    got = tvalidate.validate(_model(params), batches, compute_dtype=torch.float32)
    assert got["val/n_batches"] == want["val/n_batches"] == 2
    assert got["val/wer"] == want["val/wer"] and 0 < got["val/wer"]
    assert abs(got["val/loss"] - want["val/loss"]) <= LOSS_TOL * abs(want["val/loss"])
    one = tvalidate.validate(_model(params), batches, compute_dtype=torch.float32, max_batches=1)
    assert one["val/n_batches"] == 1
    empty = tvalidate.validate(_model(params), [])
    assert empty["val/n_batches"] == 0
    assert np.isnan(empty["val/loss"]) and np.isnan(empty["val/wer"])


def _byte_model(dims, seed=0):
    """A random fp32 model whose token embedding keeps only the byte
    tokens' text rows, so that its argmax and its decodes have text."""
    model = tm.init_params(tm.empty_model(dims, True), torch.Generator().manual_seed(seed),
                           include_padding_token=True)
    with torch.no_grad():
        model.decoder.token_embedding.weight[256:EOT].zero_()
    return model


@pytest.mark.gpu
def test_validate_on_the_card_matches_the_cpu():
    """fp32 ``validate`` of a micro model at full context on the card (its
    attention kernels) and on the CPU (their twins): the loss within 1e-4
    relative, the same WER; the argmax ids equal wherever the CPU's top two
    lead by more than LOGIT_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dims = ModelDimensions(**{**MICRO, "n_audio_ctx": 1500, "n_text_ctx": 448})
    model = _byte_model(dims)
    rng = np.random.default_rng(0)
    T = dims.n_text_ctx
    tokens = rng.integers(0, 256, (2, T + 1))
    pad = np.arange(T)[None] >= np.array([T, 150])[:, None]
    batch = {"mel": rng.standard_normal((2, 80, 3000)).astype(np.float32),
             "text_input": np.where(pad, PADDING_TOKEN, tokens[:, :-1]),
             "text_target": np.where(pad, PADDING_TOKEN, tokens[:, 1:]),
             "padding_mask": np.where(pad, -np.inf, 0.0).astype(np.float32)}
    args = [torch.from_numpy(batch[k]) for k in ("mel", "text_input", "text_target",
                                                  "padding_mask")]
    cpu = tvalidate.validate(model, [batch], compute_dtype=torch.float32)
    with torch.no_grad():
        logits = tm.forward_train(model, args[0], args[1], args[3], compute_dtype=torch.float32)
        top2 = logits.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > LOGIT_TOL
        model.to("cuda")
        _, aux = ttrain.loss_fn(model, *(a.cuda() for a in args), compute_dtype=torch.float32,
                                remat=False, return_pred=True)
    gpu = tvalidate.validate(model, [batch], compute_dtype=torch.float32)
    assert abs(gpu["val/loss"] - cpu["val/loss"]) <= 1e-4 * abs(cpu["val/loss"])
    assert torch.equal(aux["pred"].cpu()[sure], logits.argmax(-1)[sure])
    assert gpu["val/wer"] == cpu["val/wer"]


@pytest.mark.gpu
def test_short_form_eval_on_the_card_is_direct_decode(tmp_path):
    """``short_form_eval`` at bf16 on the card over 5 utterances in batches
    of 2: each hypothesis is the normalized text of ``model.decode`` on the
    same batch, run directly, and the corpus WER that of those texts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import scipy.io.wavfile as wavfile

    from olmoasr_tpu_torch.api import _new_model
    from olmoasr_tpu_torch.audio import log_mel_spectrogram, pad_or_trim
    from olmoasr_tpu_torch.decoding import DecodingOptions
    from olmoasr_tpu_torch.eval import harness
    from olmoasr_tpu_torch.eval.wer import compute_measures
    from olmoasr_tpu_torch.normalizers import EnglishTextNormalizer

    dims = ModelDimensions(**{**MICRO, "n_audio_ctx": 1500, "n_text_ctx": 448})
    sd = convert.strip_padding_row(_byte_model(dims).state_dict())
    model = _new_model(dims, False, "cuda", torch.float32)
    model.load_state_dict(sd)
    chap = tmp_path / "LibriSpeech" / "test-clean" / "1" / "2"
    chap.mkdir(parents=True)
    rng = np.random.default_rng(0)
    wavs, lines = [], []
    for i in range(5):
        wav = (rng.standard_normal(int(16000 * rng.uniform(2, 12))) * 1500).astype(np.int16)
        wavfile.write(str(chap / f"1-2-{i:04d}.wav"), 16000, wav)
        wavs.append(wav.astype(np.float32) / 32768.0)
        lines.append(f"1-2-{i:04d} HELLO WORLD NUMBER {i}")
    (chap / "1-2.trans.txt").write_text("\n".join(lines))
    result = harness.short_form_eval(model.eval(), "librispeech_clean", str(tmp_path),
                                     batch_size=2)
    norm = EnglishTextNormalizer()
    options = DecodingOptions(language="en", without_timestamps=True, fp16=True)
    hyps = []
    for i in range(0, 5, 2):
        batch = torch.from_numpy(np.stack([pad_or_trim(w) for w in wavs[i:i + 2]])).cuda()
        hyps += [norm(r.text) for r in model.decode(log_mel_spectrogram(batch), options)]
    assert [r["hyp"] for r in result.per_sample] == hyps and any(hyps)
    refs = [norm(line.split(" ", 1)[1]) for line in lines]
    assert result.wer == compute_measures(refs, hyps).wer
    json.dumps(result.to_dict())
