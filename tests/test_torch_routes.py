"""The port's decode step over int8 self rings and along every kernel route
of the JAX step (``decode_step(route=...)``), in fp32 on the CPU, where each
wrapper runs its plain twin.

``init_cache(quantize_self=True)``, a prefill and six single-token steps are
held to the JAX package's ``init_cache``/``decode_step`` on the same params
(its XLA path on the CPU: the ring dequantized, this step's keys exact):
logits within 2e-4, the argmax token-exact, each call from the same rings.
A key or value that lands on a rounding edge can quantize one int8 step
apart after fp32 sums taken in another order, and one such step moves the
logits of later steps by about 4e-3; so the rings written are held to one
step, and the JAX package's rings go into the port's cache before its next
call. Each route is held to ``"auto"`` on the same cache, within 2e-4 (the
routes compute one function; their fp32 sums run in another order), and
each route's conditions are refused where they do not hold.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from olmoasr_tpu.models import whisper as jm
from olmoasr_tpu.models.dims import ModelDimensions
from olmoasr_tpu_torch.api import _new_model
from olmoasr_tpu_torch.models import whisper as tm
from olmoasr_tpu_torch.models.convert import state_dict_from_jax_params

DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=24, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
    n_vocab=1024, n_text_ctx=20, n_text_state=64, n_text_head=4, n_text_layer=3,
)
ATOL = 2e-4
STEPS = 6


@pytest.fixture(scope="module")
def pair():
    import jax

    params = jm.init_params(jax.random.PRNGKey(1), DIMS, include_padding_token=False)
    model = _new_model(DIMS, False, "cpu", torch.float32)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), DIMS))
    feats = np.random.default_rng(5).standard_normal(
        (2, DIMS.n_audio_ctx, DIMS.n_audio_state)).astype(np.float32)
    return params, model, feats


def _tokens(rows, seed=6):
    rng = np.random.default_rng(seed)
    return rng.integers(0, DIMS.n_vocab, (rows, 3)), rng.integers(0, DIMS.n_vocab, (rows, STEPS))


def _torch_run(model, feats, route="auto", G=1, **cache_kw):
    """Prefill of 3 tokens, then STEPS single-token steps along ``route``:
    the logits of every call's last position, (rows, 1 + STEPS, vocab)."""
    cache = tm.init_cache(model, torch.from_numpy(feats), max_len=12, self_batch=2 * G,
                          **cache_kw)
    prompt, steps = _tokens(2 * G)
    out = [tm.decode_step(model, torch.from_numpy(prompt), cache)[:, -1]]
    for i in range(STEPS):
        out.append(tm.decode_step(model, torch.from_numpy(steps[:, i:i + 1]), cache,
                                  route=route)[:, 0])
    return torch.stack(out, dim=1), cache


@pytest.mark.parametrize("quantize_cross,G", [(False, 1), (True, 1), (False, 2)])
def test_int8_self_rings_match_jax(pair, quantize_cross, G):
    """``G=2``: two token rows per window (best_of), which int8 rings allow.
    The prefill attends its own keys unquantized and writes them afterwards;
    a port that wrote them first would attend their int8 rounding here."""
    params, model, feats = pair
    jcache = jm.init_cache(params, DIMS, jnp.asarray(feats), max_len=12,
                           quantize_cross=quantize_cross, quantize_self=True, self_batch=2 * G)
    prompt, steps = _tokens(2 * G)
    cache = tm.init_cache(model, torch.from_numpy(feats), max_len=12, self_batch=2 * G,
                          quantize_cross=quantize_cross, quantize_self=True)
    assert cache.self_kv.dtype == torch.int8 and cache.self_scale.shape == (2, 3, 2 * G, 1, 12)
    if quantize_cross:  # hold both sides to the same int8 cross cache
        cache.cross_k = torch.from_numpy(np.array(jcache.cross_k))
        cache.cross_v = torch.from_numpy(np.array(jcache.cross_v))
    before = tm.decode_step.single_steps
    for toks in [prompt] + [steps[:, i:i + 1] for i in range(STEPS)]:
        want, jcache = jm.decode_step(params, DIMS, jnp.asarray(toks, jnp.int32), jcache)
        got = tm.decode_step(model, torch.from_numpy(toks), cache)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))
        end = cache.index
        assert end == int(jcache.index)
        for i, name in enumerate("kv"):
            jring = np.array(getattr(jcache, f"self_{name}"))
            jscale = np.array(getattr(jcache, f"self_{name}_scale"))
            assert np.abs(cache.self_kv[i].numpy().astype(np.int32)
                          - jring.astype(np.int32)).max() <= 1
            np.testing.assert_allclose(cache.self_scale[i].numpy(), jscale, rtol=1e-5, atol=0)
            assert not cache.self_kv[i, :, :, end:].any()
            cache.self_kv[i] = torch.from_numpy(jring)
            cache.self_scale[i] = torch.from_numpy(jscale)
    assert tm.decode_step.single_steps == before + STEPS


def test_init_cache_quantize_self_matches_jax(pair):
    params, model, feats = pair
    want = jm.init_cache(params, DIMS, jnp.asarray(feats), max_len=12, quantize_self=True)
    got = tm.init_cache(model, torch.from_numpy(feats), max_len=12, quantize_self=True)
    assert got.self_kv.dtype == torch.int8 and tuple(got.self_k.shape) == want.self_k.shape
    assert tuple(got.self_k_scale.shape) == want.self_k_scale.shape == (3, 2, 1, 12)
    assert not got.self_scale.any() and got.cross_k.dtype == torch.float32
    plain = tm.init_cache(model, torch.from_numpy(feats), max_len=12)
    assert plain.self_scale is None and plain.self_k_scale is None


@pytest.mark.parametrize("route,quantize_cross,quantize_self", [
    ("split", True, False), ("layer", True, False), ("attend", True, False),
    ("attend", False, False), ("split", False, True), ("attend", True, True),
])
def test_routes_match_auto(pair, route, quantize_cross, quantize_self, monkeypatch):
    """Each route computes what ``"auto"`` computes, through its own
    kernels: ``layer`` one whole-layer ``layer_block_decode`` a layer and
    step, ``attend`` one ``cross_attend_decode`` (the others none)."""
    _, model, feats = pair
    calls = {"cross_attend": 0, "whole_layer": 0, "sc": 0}

    def attend(*a, **kw):
        calls["cross_attend"] += 1
        return tm_attention.cross_attend_decode(*a, **kw)

    def layer(*a, **kw):
        calls["whole_layer" if kw.get("include_mlp") else "sc"] += 1
        return tm_attention.layer_block_decode(*a, **kw)

    from olmoasr_tpu_torch.ops import attention as tm_attention

    kw = dict(quantize_cross=quantize_cross, quantize_self=quantize_self)
    want, _ = _torch_run(model, feats, **kw)
    monkeypatch.setattr(tm, "cross_attend_decode", attend)
    monkeypatch.setattr(tm, "layer_block_decode", layer)
    got, _ = _torch_run(model, feats, route, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    L = DIMS.n_text_layer
    assert calls == {"cross_attend": L * STEPS if route == "attend" else 0,
                     "whole_layer": L * STEPS if route == "layer" else 0, "sc": 0}


def test_auto_route_keeps_its_kernels(pair, monkeypatch):
    """``"auto"`` over an int8 cross cache with one row per window takes the
    "sc" layer block, as before; over int8 rings the split chain."""
    from olmoasr_tpu_torch.ops import attention as tm_attention

    _, model, feats = pair
    seen = []
    monkeypatch.setattr(tm, "layer_block_decode",
                        lambda *a, **kw: seen.append(kw["include_mlp"])
                        or tm_attention.layer_block_decode(*a, **kw))
    _torch_run(model, feats, quantize_cross=True)
    assert seen == [False] * DIMS.n_text_layer * STEPS
    seen.clear()
    _torch_run(model, feats, quantize_cross=True, quantize_self=True)
    assert seen == []


@pytest.mark.parametrize("case", ["ancestry over int8 rings", "layer over a bf16 cross cache",
                                  "layer over int8 rings", "layer with kv_group 2",
                                  "attend with kv_group 2", "no such route"])
def test_routes_refuse_what_their_kernels_do_not_take(pair, case):
    _, model, feats = pair
    G = 2 if "kv_group 2" in case or "ancestry" in case else 1
    cache = tm.init_cache(model, torch.from_numpy(feats), max_len=12, self_batch=2 * G,
                          quantize_cross="bf16" not in case, quantize_self="int8 rings" in case)
    tm.decode_step(model, torch.from_numpy(_tokens(2 * G)[0]), cache)  # the prefill
    token = torch.zeros((2 * G, 1), dtype=torch.long)
    kw = {"route": case.split()[0]} if case != "no such route" else {"route": "fused"}
    if "ancestry" in case:
        kw = {"beam_anc": torch.zeros((2 * G, 12), dtype=torch.int32)}
    with pytest.raises(ValueError, match="unquantized|route|kv_group"):
        tm.decode_step(model, token, cache, **kw)
    assert cache.index == 3  # nothing advanced
