"""The port's model (olmoasr_tpu_torch.models.whisper) against the JAX model
on the same params and inputs, in fp32 on the CPU.

Tolerances: 2e-4 where both sides compute the same fp32 math (cache
projections, decoder steps). The encoder is held to 1e-2: its attention keeps
the TPU kernel's rounding of p to bf16 (relative error up to 2^-9 per weight,
so up to 2^-9 * max|v| per output and layer), while the JAX model on the CPU
runs exact fp32 ``sdpa``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from olmoasr_tpu.models import whisper as jm
from olmoasr_tpu.models.dims import ModelDimensions
from olmoasr_tpu_torch.api import _new_model
from olmoasr_tpu_torch.models import whisper as tm
from olmoasr_tpu_torch.models.convert import state_dict_from_jax_params
from olmoasr_tpu_torch.ops import attention as tm_attention

DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=24, n_audio_state=64, n_audio_head=4, n_audio_layer=3,
    n_vocab=51864, n_text_ctx=20, n_text_state=64, n_text_head=4, n_text_layer=3,
)
ATOL = 2e-4
ENC_ATOL = 1e-2


@pytest.fixture(scope="module")
def pair():
    params = jm.init_params(jax.random.PRNGKey(0), DIMS, include_padding_token=False)
    params_np = jax.tree.map(np.asarray, params)
    model = _new_model(DIMS, False, "cpu", torch.float32)
    model.load_state_dict(state_dict_from_jax_params(params_np, DIMS))
    return params, model


@pytest.fixture(scope="module")
def audio_features():
    rng = np.random.default_rng(1)
    return rng.standard_normal((2, DIMS.n_audio_ctx, DIMS.n_audio_state)).astype(np.float32)


def test_encode_audio_matches(pair):
    params, model = pair
    mel = np.random.default_rng(0).standard_normal((2, 80, 2 * DIMS.n_audio_ctx)).astype(
        np.float32
    )
    want = np.asarray(jm.encode_audio(params, DIMS, jnp.asarray(mel), compute_dtype=jnp.float32))
    got = tm.encode_audio(model, torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ENC_ATOL, rtol=0)


def test_sinusoids_match():
    np.testing.assert_array_equal(tm.sinusoids(1500, 768), jm.sinusoids(1500, 768))


@pytest.mark.parametrize("quantize", [False, True])
def test_init_cache_matches(pair, audio_features, quantize):
    params, model = pair
    want = jm.init_cache(params, DIMS, jnp.asarray(audio_features), max_len=12,
                         quantize_cross=quantize)
    got = tm.init_cache(model, torch.from_numpy(audio_features), max_len=12,
                        quantize_cross=quantize)
    assert tuple(got.self_k.shape) == tuple(want.self_k.shape)
    assert not got.self_k.any() and not got.self_v.any() and got.index == 0
    for name in ("cross_k", "cross_v"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        if quantize:
            assert g.dtype == torch.int8
            # an fp32 projection summed in another order may round one step apart
            assert np.abs(g.numpy().astype(np.int32) - w.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)
        scale = getattr(got, f"{name}_scale")
        w_scale = getattr(want, f"{name}_scale")
        if quantize:
            np.testing.assert_allclose(scale.numpy(), np.asarray(w_scale), rtol=1e-5)
        else:
            assert w_scale is None and bool((scale == 1).all())


@pytest.mark.parametrize("quantize", [False, True])
def test_decode_step_prefill_and_steps_match(pair, audio_features, quantize, monkeypatch):
    """Over the int8 cross cache the single-token steps take the fused
    layer_block_decode, one call per layer, as the JAX step takes its layer
    block there."""
    params, model = pair
    fused = []
    monkeypatch.setattr(tm, "layer_block_decode",
                        lambda *a, **kw: fused.append(1) or tm_attention.layer_block_decode(*a, **kw))
    jcache = jm.init_cache(params, DIMS, jnp.asarray(audio_features), max_len=12,
                           quantize_cross=quantize)
    tcache = tm.init_cache(model, torch.from_numpy(audio_features), max_len=12,
                           quantize_cross=quantize)
    if quantize:  # hold both sides to the same int8 cache
        tcache.cross_k = torch.from_numpy(np.asarray(jcache.cross_k))
        tcache.cross_v = torch.from_numpy(np.asarray(jcache.cross_v))
    rng = np.random.default_rng(2)
    chunks = [rng.integers(0, DIMS.n_vocab, (2, 3)), rng.integers(0, DIMS.n_vocab, (2, 1)),
              rng.integers(0, DIMS.n_vocab, (2, 1))]
    for toks in chunks:  # prefill of 3 tokens, then 2 single-token steps
        want, jcache = jm.decode_step(params, DIMS, jnp.asarray(toks, jnp.int32), jcache)
        got = tm.decode_step(model, torch.from_numpy(toks), tcache)
        assert got.dtype == torch.float32 and got.shape == (2, toks.shape[1], DIMS.n_vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert tcache.index == int(jcache.index) == 5
    np.testing.assert_allclose(tcache.self_k[:, :, :5].numpy(),
                               np.asarray(jcache.self_k)[:, :, :5], atol=ATOL, rtol=0)
    assert len(fused) == (2 * DIMS.n_text_layer if quantize else 0)


def test_decode_step_with_shared_cross_cache_matches(pair, audio_features):
    """best_of layout: two token rows per audio window (self_batch = 2B) over
    one cross cache; prefill of 3 tokens, then 2 single-token steps, which run
    every sub-block through the kernel wrappers (here their plain twins)."""
    params, model = pair
    G = 2
    jcache = jm.init_cache(params, DIMS, jnp.asarray(audio_features), max_len=12,
                           self_batch=2 * G)
    tcache = tm.init_cache(model, torch.from_numpy(audio_features), max_len=12, self_batch=2 * G)
    assert tuple(tcache.self_k.shape) == tuple(jcache.self_k.shape) == (3, 2 * G, 12, 64)
    assert tcache.kv_group == G and tuple(tcache.cross_k.shape[:2]) == (3, 2)
    rng = np.random.default_rng(3)
    steps_before = tm.decode_step.single_steps
    for width in (3, 1, 1):
        toks = rng.integers(0, DIMS.n_vocab, (2 * G, width))
        want, jcache = jm.decode_step(params, DIMS, jnp.asarray(toks, jnp.int32), jcache)
        got = tm.decode_step(model, torch.from_numpy(toks), tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert tm.decode_step.single_steps == steps_before + 2
    np.testing.assert_allclose(tcache.self_v[:, :, :5].numpy(),
                               np.asarray(jcache.self_v)[:, :, :5], atol=ATOL, rtol=0)


@pytest.mark.parametrize("K", [2, 3])
def test_decode_step_with_beam_ancestry_matches(pair, audio_features, K):
    """Beam layout: K token rows per window over one cross cache, a prefill
    of 3 tokens, then 3 single-token steps, each with a freshly permuted
    ancestry map (random rows below the write position, the identity from
    it on, as the beam loop keeps it); the same map goes to both packages."""
    params, model = pair
    rows = 2 * K
    jcache = jm.init_cache(params, DIMS, jnp.asarray(audio_features), max_len=12,
                           self_batch=rows)
    tcache = tm.init_cache(model, torch.from_numpy(audio_features), max_len=12, self_batch=rows)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, DIMS.n_vocab, (rows, 3))
    want, jcache = jm.decode_step(params, DIMS, jnp.asarray(toks, jnp.int32), jcache)
    got = tm.decode_step(model, torch.from_numpy(toks), tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for _ in range(3):
        index = tcache.index
        anc = rng.integers(0, K, (rows, 12)).astype(np.int32)
        anc[:, index:] = np.arange(rows)[:, None] % K
        toks = rng.integers(0, DIMS.n_vocab, (rows, 1))
        want, jcache = jm.decode_step(params, DIMS, jnp.asarray(toks, jnp.int32), jcache,
                                      beam_anc=jnp.asarray(anc))
        got = tm.decode_step(model, torch.from_numpy(toks), tcache, beam_anc=torch.from_numpy(anc))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert tcache.index == int(jcache.index) == 6
    np.testing.assert_allclose(tcache.self_k[:, :, :6].numpy(),
                               np.asarray(jcache.self_k)[:, :, :6], atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="ancestry"):  # a map needs S=1
        tm.decode_step(model, torch.from_numpy(rng.integers(0, 100, (rows, 2))), tcache,
                       beam_anc=torch.from_numpy(anc))


def test_derived_weights_follow_the_model():
    """The per-dtype copy and the fused QKV are made once and dropped when
    load_state_dict or .to() changes the model."""
    model = tm.init_params(_new_model(DIMS, False, "cpu", torch.float32),
                           torch.Generator().manual_seed(0))
    assert model.in_dtype(torch.float32) is model
    bf16 = model.in_dtype(torch.bfloat16)
    assert bf16.dtype == torch.bfloat16 and model.in_dtype(torch.bfloat16) is bf16
    assert model.dtype == torch.float32
    w, b = model.fused_qkv()
    assert w.shape == (3, 3 * 64, 64) and b.shape == (3, 3 * 64)
    blk = model.decoder.blocks[1].attn
    assert torch.equal(w[1, 64:128], blk.key.weight) and not b[1, 64:128].any()
    assert torch.equal(b[1, 128:], blk.value.bias)
    assert model.fused_qkv()[0] is w
    sd = {k: v + 1 for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    assert model.fused_qkv()[0] is not w
    assert torch.equal(model.fused_qkv()[0][1, :64], blk.query.weight)
    assert model.in_dtype(torch.bfloat16) is not bf16
    copy = model.in_dtype(torch.bfloat16)
    model.to(torch.float32)
    assert model.in_dtype(torch.bfloat16) is not copy


def test_decode_step_refuses_positions_past_the_cache(pair, audio_features):
    _, model = pair
    cache = tm.init_cache(model, torch.from_numpy(audio_features), max_len=2)
    with pytest.raises(ValueError):
        tm.decode_step(model, torch.zeros((2, 3), dtype=torch.long), cache)


def test_init_params_is_seeded_and_follows_the_jax_scheme():
    make = lambda seed: tm.init_params(
        _new_model(DIMS, True, "cpu", torch.float32), torch.Generator().manual_seed(seed),
        include_padding_token=True,
    )
    a, b, c = make(0), make(0), make(1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["decoder.blocks.0.mlp.0.weight"], sc["decoder.blocks.0.mlp.0.weight"])
    assert not sa["decoder.token_embedding.weight"][jm.PADDING_TOKEN].any()
    assert bool((sa["encoder.blocks.1.attn_ln.weight"] == 1).all())
    w = sa["encoder.blocks.0.mlp.2.weight"]  # fan_in 4 * 64
    assert abs(float(w.std()) - (2.0 / 256) ** 0.5) < 0.01
    assert "decoder.blocks.0.attn.key.bias" not in sa  # the key projection has no bias
