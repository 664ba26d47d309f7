"""The decode layer of the served path: ``layer_block_decode`` in both its
modes ("sc" and the whole layer, ``include_mlp``) and ``mlp_block``.

CPU: the plain twins against the JAX package's Pallas kernels in interpret
mode, at the shapes the bf16 kernel's tiles must take: one row and 17 rows
(a ragged 16-row tile), 130 cross keys (not a multiple of the 128-key
stage), the self ring empty and full; in bf16, the bf16 kernels' contract
(the fp32 twins are pinned in test_torch_ops.py). Tolerance: two bf16 steps
at the output's largest magnitude (the JAX kernel rounds the softmax weights
to bf16 for the value product, the twin keeps them fp32).

GPU (``pytest.mark.gpu``, skipped without a card): the bf16 layer kernel of
``csrc/decode_layer.cu`` and ``mlp_block`` (``csrc/skinny_proj.cu``) against the
twins at small.en widths over ragged rows, ring depths and cross lengths; a
case where the int8 and the exact q.K products land far apart, reached
through the cross q projection; two launches bit-equal. Run on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_decode_layer.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from olmoasr_tpu_torch.ops import attention

L, T, D, H, FF, C = 2, 130, 64, 4, 256, 16
LAYER = 1


@pytest.fixture(scope="module")
def jx():
    import types

    import jax.numpy as jnp

    from olmoasr_tpu.models.whisper import _quantize_rows
    from olmoasr_tpu.ops import attention as attn

    return types.SimpleNamespace(jnp=jnp, quantize_rows=_quantize_rows, attn=attn)


def _bf16_tol(want) -> float:
    return 2.0 ** -6 * float(torch.as_tensor(want).float().abs().max())


def _params(rng):
    """(L, ...) parameters in the JAX layout: linear weights (in, out)."""
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    ln = lambda: [1 + f(L, D, scale=0.1), f(L, D, scale=0.1)]
    return {
        "self": [*ln(), f(L, D, 3 * D, scale=D ** -0.5), f(L, 3 * D, scale=0.1),
                 f(L, D, D, scale=D ** -0.5), f(L, D, scale=0.1)],
        "cross": [*ln(), f(L, D, D, scale=D ** -0.5), f(L, D, scale=0.1),
                  f(L, D, D, scale=D ** -0.5), f(L, D, scale=0.1)],
        "mlp": [*ln(), f(L, D, FF, scale=D ** -0.5), f(L, FF, scale=0.1),
                f(L, FF, D, scale=FF ** -0.5), f(L, D, scale=0.1)],
    }


def _torch_layer(jnp, arrays, tdt):
    """One layer of JAX-layout (ln_g, ln_b, w, b, w, b) as torch (out, in)."""
    return [torch.from_numpy(np.asarray(jnp.asarray(a[LAYER].T if a.ndim == 3 else a[LAYER],
                                                    jnp.float32))).to(tdt) for a in arrays]


@pytest.mark.parametrize("rows", [1, 17])
@pytest.mark.parametrize("offset", [0, C])
@pytest.mark.parametrize("include_mlp", [False, True], ids=["sc", "layer"])
def test_layer_block_twin_matches_jax_kernel(jx, rows, offset, include_mlp):
    jnp = jx.jnp
    rng = np.random.default_rng(100 * rows + offset)
    p = _params(rng)
    jdt, tdt = jnp.bfloat16, torch.bfloat16
    j = lambda a: jnp.asarray(a, jdt)
    x = rng.standard_normal((rows, 1, D)).astype(np.float32)
    k_ring, v_ring = (rng.standard_normal((L, rows, C, D)).astype(np.float32) for _ in range(2))
    ck, ks = jx.quantize_rows(jnp.asarray(rng.standard_normal((L, rows, T, D)), jnp.float32))
    cv, vs = jx.quantize_rows(jnp.asarray(rng.standard_normal((L, rows, T, D)), jnp.float32))
    w = {k: [j(a) for a in v] for k, v in p.items()}
    want = jx.attn.layer_block_decode(
        j(x), *w["self"], *w["cross"], *w["mlp"], j(k_ring), j(v_ring), ck.transpose(0, 1, 3, 2),
        cv, ks[:, :, None, :], vs[:, :, None, :], jnp.int32(offset), jnp.int32(LAYER),
        n_head=H, include_mlp=include_mlp, interpret=True,
    )
    as_t = lambda a: torch.from_numpy(np.asarray(jnp.asarray(a, jnp.float32)))
    got_x, kv_new = attention.layer_block_decode(
        as_t(j(x)).to(tdt), *_torch_layer(jnp, w["self"], tdt), *_torch_layer(jnp, w["cross"], tdt),
        as_t(j(k_ring)).to(tdt), as_t(j(v_ring)).to(tdt), torch.from_numpy(np.asarray(ck[LAYER])),
        torch.from_numpy(np.asarray(cv[LAYER])), as_t(ks[LAYER])[:, None],
        as_t(vs[LAYER])[:, None], offset, LAYER, n_head=H, include_mlp=include_mlp,
        mlp=_torch_layer(jnp, w["mlp"], tdt) if include_mlp else None,
    )
    assert got_x.shape == (rows, 1, D) and kv_new.shape == (2, rows, 1, D)
    for got, ref in ((got_x, want[0]), (kv_new[0], want[1]), (kv_new[1], want[2])):
        ref = as_t(ref)
        np.testing.assert_allclose(got.float().numpy(), ref.numpy(), rtol=0,
                                   atol=_bf16_tol(ref))


@pytest.mark.parametrize("rows", [1, 17])
def test_mlp_block_twin_matches_jax_kernel(jx, rows):
    jnp = jx.jnp
    rng = np.random.default_rng(rows)
    mlp = [jnp.asarray(a, jnp.bfloat16) for a in _params(rng)["mlp"]]
    x = jnp.asarray(rng.standard_normal((rows, 1, D)), jnp.bfloat16)
    want = torch.from_numpy(np.asarray(jnp.asarray(
        jx.attn.mlp_block(x, *mlp, jnp.int32(LAYER), interpret=True), jnp.float32)))
    got = attention.mlp_block(torch.from_numpy(np.asarray(jnp.asarray(x, jnp.float32)))
                              .to(torch.bfloat16), *_torch_layer(jnp, mlp, torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=0, atol=_bf16_tol(want))


# ---------------------------------------------------------------------------
# the bf16 kernels against their twins (run on the card)
# ---------------------------------------------------------------------------

Dg, Hg, Fg, Cg, Tg = 768, 12, 3072, 225, 1500


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(g, rows, device):
    """small.en-wide bf16 layer inputs: x, the self and cross sub-blocks, one
    layer of rings (L = 1, C = 225), an int8 cross cache of 1500 keys, the
    MLP."""
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(device, torch.bfloat16)
    sub = lambda n: [1 + r(Dg, scale=0.1), r(Dg, scale=0.1), r(n * Dg, Dg, scale=Dg ** -0.5),
                     r(n * Dg, scale=0.1), r(Dg, Dg, scale=Dg ** -0.5), r(Dg, scale=0.1)]
    mlp = [1 + r(Dg, scale=0.1), r(Dg, scale=0.1), r(Fg, Dg, scale=Dg ** -0.5),
           r(Fg, scale=0.1), r(Dg, Fg, scale=Fg ** -0.5), r(Dg, scale=0.1)]
    (ck, ks), (cv, vs) = (_quantize_rows(torch.randn(rows, Tg, Dg, generator=g).to(device))
                          for _ in range(2))
    return (r(rows, 1, Dg), sub(3), sub(1), [r(1, rows, Cg, Dg), r(1, rows, Cg, Dg)],
            (ck, cv, ks, vs), mlp)


def _cache(cache, keys):
    ck, cv, ks, vs = cache
    return (ck[:, :keys].contiguous(), cv[:, :keys].contiguous(),
            ks[:, None, :keys].contiguous(), vs[:, None, :keys].contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("include_mlp", [False, True], ids=["sc", "layer"])
def test_decode_layer_kernel_matches_twin(cuda, include_mlp):
    """Rows 1, 5, 17, 64, 80 (ragged 16-row tiles, two 64-row groups); ring
    depths 0, 1, 127, 128, 224 and C (the 128-key stage's edges); 1, 130 and
    1500 cross keys."""
    g = torch.Generator().manual_seed(11)
    counter = "mlp_launches" if include_mlp else "launches"
    for rows in (1, 5, 17, 64, 80):
        x, w_self, w_cross, rings, cache, mlp = _inputs(g, rows, cuda)
        kw = dict(n_head=Hg, include_mlp=include_mlp, mlp=mlp if include_mlp else None)
        for keys in (1, 130, Tg):
            for offset in (0, 1, 127, 128, 224, Cg):
                args = (x, *w_self, *w_cross, *rings, *_cache(cache, keys), offset, 0)
                before = getattr(attention.layer_block_decode, counter)
                got, kv = attention.layer_block_decode(*args, **kw)
                want, kv_want = attention.layer_block_decode_plain(*args, **kw)
                torch.cuda.synchronize()
                assert getattr(attention.layer_block_decode, counter) == before + 1
                what = (rows, keys, offset)
                assert float((got.float() - want.float()).abs().max()) <= _bf16_tol(want), what
                assert float((kv.float() - kv_want.float()).abs().max()) <= _bf16_tol(kv_want), what


@pytest.mark.gpu
def test_mlp_block_kernel_matches_twin_at_ragged_rows(cuda):
    g = torch.Generator().manual_seed(12)
    for rows in (1, 5, 17, 64, 80):
        x, *_, mlp = _inputs(g, rows, cuda)
        before = attention.mlp_block.launches
        got, want = attention.mlp_block(x, *mlp), attention.mlp_block_plain(x, *mlp)
        torch.cuda.synchronize()
        assert attention.mlp_block.launches == before + 1
        assert float((got.float() - want.float()).abs().max()) <= _bf16_tol(want), rows


@pytest.mark.gpu
@pytest.mark.parametrize("include_mlp", [False, True], ids=["sc", "layer"])
def test_decode_layer_kernel_takes_the_int8_qk_product(cuda, include_mlp, monkeypatch):
    """Row h * dh of the cross q projection scaled by 1000, so lane 0 of every
    head of q dominates and the head's other lanes round to 0 against its
    int8 scale. Lane 0 of every key holds 3.0 (its row's largest magnitude,
    exact in int8): the int8 logits are equal and the weights uniform. Key
    T // 3 lines up with the small lanes of each row's q, so the exact
    product puts its weight there; its value is 3.0 in every lane."""
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    g = torch.Generator().manual_seed(13)
    rows, dh, offset = 5, Dg // Hg, 100
    x, w_self, w_cross, rings, _, mlp = _inputs(g, rows, cuda)
    w_cross[2] = w_cross[2].clone()
    w_cross[2][::dh] *= 1000
    # the twin's q of the cross sub-block, to line key T // 3 up with it
    A = attention
    qkv = A._linear_f32(A._ln_f32(x, *w_self[:2]).to(torch.bfloat16), *w_self[2:4])
    q, kn, vn = qkv.split(Dg, dim=-1)
    a = A.self_attend_decode_plain(q, *rings, kn, vn, offset, 0, n_head=Hg)
    x1 = x.float() + A._linear_f32(a.to(torch.bfloat16), *w_self[4:])
    qc = A._linear_f32(A._ln_f32(x1, *w_cross[:2]).to(torch.bfloat16), *w_cross[2:4])[:, 0]
    sign = torch.where(qc >= 0, 1.0, -1.0)
    k = torch.rand(rows, Tg, Dg, generator=g).to(cuda) * 2 - 1
    k[:, Tg // 3] = 2.9 * sign
    k[:, :, ::dh] = 3.0
    v = torch.rand(rows, Tg, Dg, generator=g).to(cuda) * 2 - 1
    v[:, Tg // 3] = 3.0
    (ck, ks), (cv, vs) = _quantize_rows(k), _quantize_rows(v)
    args = (x, *w_self, *w_cross, *rings, ck, cv, ks[:, None].contiguous(),
            vs[:, None].contiguous(), offset, 0)
    kw = dict(n_head=Hg, include_mlp=include_mlp, mlp=mlp if include_mlp else None)
    got = attention.layer_block_decode(*args, **kw)[0]
    want = attention.layer_block_decode_plain(*args, **kw)[0]
    monkeypatch.setattr(attention, "quantizes_q", lambda k_dtype, x_dtype: False)
    exact = attention.layer_block_decode_plain(*args, **kw)[0]
    torch.cuda.synchronize()
    tol = _bf16_tol(want)
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert float((got.float() - exact.float()).abs().max()) > 8 * tol


@pytest.mark.gpu
def test_decode_layer_kernels_are_deterministic(cuda):
    """Two launches on the same inputs give the same bits: "sc", the whole
    layer and mlp_block."""
    g = torch.Generator().manual_seed(14)
    x, w_self, w_cross, rings, cache, mlp = _inputs(g, 64, cuda)
    args = (x, *w_self, *w_cross, *rings, *_cache(cache, Tg), 224, 0)
    for kw in (dict(n_head=Hg), dict(n_head=Hg, include_mlp=True, mlp=mlp)):
        first = attention.layer_block_decode(*args, **kw)
        second = attention.layer_block_decode(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(attention.mlp_block(x, *mlp), attention.mlp_block(x, *mlp))
