"""The port's kernels (olmoasr_tpu_torch.ops) against the JAX package's Pallas
kernels run in interpret mode, on the same numpy inputs, in fp32: the decode
step's ln_matmul, self_attend_decode, matmul_residual, cross_block_decode
(with and without kv_group) and mlp_block, and the attention forward.

On the CPU each wrapper runs its plain PyTorch twin, so these tests pin the
twins' semantics to the TPU kernels. Tests marked ``gpu`` hold the CUDA
kernels against the same twins; they skip where torch has no CUDA device.
JAX is imported inside the fixture that needs it, so that the ``gpu`` tests
also run where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_ops.py``.
Tolerances: 2e-4 for the decode sub-blocks and projections (fp32 sums taken
in another order); 5e-4 for the attention forward, which rounds p to bf16 on both sides:
where the two fp32 scores differ in the last bit that rounding can flip by one
bf16 step and move an output by p/l * 2^-8 * |v| (about 2.6e-4 seen at 80
keys, where p/l is large).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from olmoasr_tpu_torch.ops import attention, train_attention

ATOL = 2e-4
ATTN_ATOL = 5e-4
L, B, T, D, H, FF = 2, 3, 96, 64, 4, 256
LAYER = 1
C = 16  # self ring capacity


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jax.numpy and the JAX package's kernels."""
    import types

    import jax.numpy as jnp

    from olmoasr_tpu.models.whisper import _quantize_rows
    from olmoasr_tpu.ops import attention as attn
    from olmoasr_tpu.ops import train_attention as train_attn

    return types.SimpleNamespace(jnp=jnp, quantize_rows=_quantize_rows, attn=attn,
                                 train_attn=train_attn)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=0)


def _block_params(rng):
    """Stacked (L, ...) params in the JAX layout: linear weights (in, out)."""
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    return {
        "ln_g": 1 + f(L, D, scale=0.1), "ln_b": f(L, D, scale=0.1),
        "wq": f(L, D, D, scale=D ** -0.5), "bq": f(L, D, scale=0.1),
        "wo": f(L, D, D, scale=D ** -0.5), "bo": f(L, D, scale=0.1),
        "w1": f(L, D, FF, scale=D ** -0.5), "b1": f(L, FF, scale=0.1),
        "w2": f(L, FF, D, scale=FF ** -0.5), "b2": f(L, D, scale=0.1),
        "wqkv": f(L, D, 3 * D, scale=D ** -0.5), "bqkv": f(L, 3 * D, scale=0.1),
    }


def _layer(p, name, transpose=False):
    a = p[name][LAYER]
    return _t(a.T if transpose else a)


@pytest.mark.parametrize("kv", ["fp32", "bf16", "int8"])
def test_cross_block_decode_matches_jax_kernel(jx, kv):
    jnp = jx.jnp
    rng = _rng(0)
    p = _block_params(rng)
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    ck = rng.standard_normal((L, B, T, D)).astype(np.float32)
    cv = rng.standard_normal((L, B, T, D)).astype(np.float32)
    if kv == "int8":
        ck_j, ks_j = jx.quantize_rows(jnp.asarray(ck))
        cv_j, vs_j = jx.quantize_rows(jnp.asarray(cv))
    else:
        dt = jnp.bfloat16 if kv == "bf16" else jnp.float32
        ck_j, cv_j = jnp.asarray(ck, dt), jnp.asarray(cv, dt)
        ks_j = vs_j = jnp.ones((L, B, T), jnp.float32)
    want = jx.attn.cross_block_decode(
        jnp.asarray(x), jnp.asarray(p["ln_g"]), jnp.asarray(p["ln_b"]), jnp.asarray(p["wq"]),
        jnp.asarray(p["bq"]), jnp.asarray(p["wo"]), jnp.asarray(p["bo"]), ck_j, cv_j,
        ks_j, vs_j, jnp.int32(LAYER), n_head=H, interpret=True, wv_mode="dot",
    )
    # the port takes one layer, torch weight layout, and its cache dtype as is
    as_t = lambda a: _t(np.asarray(jnp.asarray(a, jnp.float32)))
    ck_t, cv_t = as_t(ck_j[LAYER]), as_t(cv_j[LAYER])
    if kv == "int8":
        ck_t, cv_t = ck_t.to(torch.int8), cv_t.to(torch.int8)
    elif kv == "bf16":
        ck_t, cv_t = ck_t.to(torch.bfloat16), cv_t.to(torch.bfloat16)
    ks_t, vs_t = as_t(ks_j[LAYER])[:, None], as_t(vs_j[LAYER])[:, None]
    before = attention.cross_block_decode.launches
    got = attention.cross_block_decode(
        _t(x), _layer(p, "ln_g"), _layer(p, "ln_b"), _layer(p, "wq", True), _layer(p, "bq"),
        _layer(p, "wo", True), _layer(p, "bo"), ck_t, cv_t, ks_t, vs_t, H,
    )
    _close(got, want)
    assert attention.cross_block_decode.launches == before  # CPU: the plain twin


@pytest.mark.parametrize("kv", ["fp32", "bf16"])
def test_cross_block_decode_kv_group_matches_jax_kernel(jx, kv):
    """Two query rows per cache row: row b reads cache row b // 2."""
    jnp = jx.jnp
    G = 2
    rng = _rng(5)
    p = _block_params(rng)
    x = rng.standard_normal((B * G, 1, D)).astype(np.float32)
    dt = jnp.bfloat16 if kv == "bf16" else jnp.float32
    ck_j, cv_j = (jnp.asarray(rng.standard_normal((L, B, T, D)), dt) for _ in range(2))
    ones = jnp.ones((L, B, T), jnp.float32)
    want = jx.attn.cross_block_decode(
        jnp.asarray(x), jnp.asarray(p["ln_g"]), jnp.asarray(p["ln_b"]), jnp.asarray(p["wq"]),
        jnp.asarray(p["bq"]), jnp.asarray(p["wo"]), jnp.asarray(p["bo"]), ck_j, cv_j,
        ones, ones, jnp.int32(LAYER), n_head=H, interpret=True, wv_mode="dot", kv_group=G,
    )
    as_t = lambda a: _t(np.asarray(jnp.asarray(a, jnp.float32)))
    tdt = torch.bfloat16 if kv == "bf16" else torch.float32
    scale = torch.ones(B, 1, T)
    got = attention.cross_block_decode(
        _t(x), _layer(p, "ln_g"), _layer(p, "ln_b"), _layer(p, "wq", True), _layer(p, "bq"),
        _layer(p, "wo", True), _layer(p, "bo"), as_t(ck_j[LAYER]).to(tdt),
        as_t(cv_j[LAYER]).to(tdt), scale, scale, H, kv_group=G,
    )
    _close(got, want)


def test_ln_matmul_matches_jax_kernel(jx):
    jnp = jx.jnp
    rng = _rng(6)
    p = _block_params(rng)
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    want = jx.attn.ln_matmul(
        jnp.asarray(x), jnp.asarray(p["ln_g"]), jnp.asarray(p["ln_b"]), jnp.asarray(p["wqkv"]),
        jnp.asarray(p["bqkv"]), jnp.int32(LAYER), interpret=True,
    )
    before = attention.ln_matmul.launches
    got = attention.ln_matmul(_t(x), _layer(p, "ln_g"), _layer(p, "ln_b"),
                              _layer(p, "wqkv", True), _layer(p, "bqkv"))
    assert got.shape == (B, 1, 3 * D)
    _close(got, want)
    assert attention.ln_matmul.launches == before


def test_matmul_residual_matches_jax_kernel(jx):
    jnp = jx.jnp
    rng = _rng(7)
    p = _block_params(rng)
    attn, x = (rng.standard_normal((B, 1, D)).astype(np.float32) for _ in range(2))
    want = jx.attn.matmul_residual(
        jnp.asarray(attn), jnp.asarray(x), jnp.asarray(p["wo"]), jnp.asarray(p["bo"]),
        jnp.int32(LAYER), interpret=True,
    )
    before = attention.matmul_residual.launches
    got = attention.matmul_residual(_t(attn), _t(x), _layer(p, "wo", True), _layer(p, "bo"))
    _close(got, want)
    assert attention.matmul_residual.launches == before


@pytest.mark.parametrize("offset", [0, 1, 9, C])
def test_self_attend_decode_matches_jax_kernel(jx, offset):
    """Ring positions < offset plus the step's own key; the rest of the ring
    holds values that must not leak in."""
    jnp = jx.jnp
    rng = _rng(8)
    q, k_new, v_new = (rng.standard_normal((B, 1, D)).astype(np.float32) for _ in range(3))
    k_ring, v_ring = (rng.standard_normal((L, B, C, D)).astype(np.float32) for _ in range(2))
    want = jx.attn.self_attend_decode(
        jnp.asarray(q), jnp.asarray(k_ring), jnp.asarray(v_ring), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.int32(offset), jnp.int32(LAYER), n_head=H, interpret=True,
    )
    before = attention.self_attend_decode.launches
    got = attention.self_attend_decode(
        _t(q), _t(k_ring), _t(v_ring), _t(k_new), _t(v_new), offset, LAYER, n_head=H,
    )
    _close(got, want)
    assert attention.self_attend_decode.launches == before


def test_mlp_block_matches_jax_kernel(jx):
    jnp = jx.jnp
    rng = _rng(1)
    p = _block_params(rng)
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    want = jx.attn.mlp_block(
        jnp.asarray(x), jnp.asarray(p["ln_g"]), jnp.asarray(p["ln_b"]), jnp.asarray(p["w1"]),
        jnp.asarray(p["b1"]), jnp.asarray(p["w2"]), jnp.asarray(p["b2"]), jnp.int32(LAYER),
        interpret=True,
    )
    before = attention.mlp_block.launches
    got = attention.mlp_block(
        _t(x), _layer(p, "ln_g"), _layer(p, "ln_b"), _layer(p, "w1", True), _layer(p, "b1"),
        _layer(p, "w2", True), _layer(p, "b2"),
    )
    _close(got, want)
    assert attention.mlp_block.launches == before


@pytest.mark.parametrize("valid_len", [None, 53])
def test_enc_self_attention_matches_jax_kernel(jx, valid_len):
    jnp = jx.jnp
    rng = _rng(2)
    q, k, v = (rng.standard_normal((2, 64, 128)).astype(np.float32) for _ in range(3))
    want = jx.train_attn.enc_self_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2, interpret=True, valid_len=valid_len
    )
    got = train_attention.enc_self_attention(_t(q), _t(k), _t(v), 2, valid_len=valid_len)
    _close(got, want, ATTN_ATOL)


def test_dec_self_attention_with_key_bias_matches_jax_kernel(jx):
    jnp = jx.jnp
    rng = _rng(3)
    Bq, Tq, Dq, Hq = 2, 48, 128, 2
    q, k, v = (rng.standard_normal((Bq, Tq, Dq)).astype(np.float32) for _ in range(3))
    lengths = np.array([Tq, 31])
    key_bias = np.where(np.arange(Tq)[None] < lengths[:, None], 0.0, -np.inf).astype(np.float32)
    want = jx.train_attn.dec_self_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), Hq, key_bias=jnp.asarray(key_bias),
        interpret=True,
    )
    got = train_attention.dec_self_attention(_t(q), _t(k), _t(v), Hq, key_bias=_t(key_bias))
    _close(got, want, ATTN_ATOL)


def test_cross_attention_matches_jax_kernel(jx):
    jnp = jx.jnp
    rng = _rng(4)
    q = rng.standard_normal((2, 24, 128)).astype(np.float32)
    k, v = (rng.standard_normal((2, 80, 128)).astype(np.float32) for _ in range(2))
    want = jx.train_attn.cross_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2, interpret=True
    )
    _close(train_attention.cross_attention(_t(q), _t(k), _t(v), 2), want, ATTN_ATOL)


def test_key_bias_row_clamps_and_masks():
    kb = torch.tensor([[0.0, -float("inf"), 0.0, 0.0]])
    bias = train_attention.key_bias_row(4, kb, 3, "cpu")
    assert bias.tolist() == [[0.0, -1e9, 0.0, -1e9]]
    assert train_attention.key_bias_row(4, None, None, "cpu") is None
    assert train_attention.key_bias_row(4, None, 4, "cpu") is None


# ---------------------------------------------------------------------------
# CUDA kernels against their plain twins (run on the card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16_tol(want):
    return 2.0 ** -6 * float(want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("act,kv", [("bf16", "bf16"), ("bf16", "int8"), ("fp32", "fp32")])
def test_cross_block_kernel_matches_twin(cuda, act, kv):
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    g = torch.Generator().manual_seed(0)
    Bc, Tc, Dc, Hc = 5, 300, 768, 12
    dt = torch.bfloat16 if act == "bf16" else torch.float32
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(cuda, dt)
    x = r(Bc, 1, Dc)
    w = [1 + r(Dc, scale=0.1), r(Dc, scale=0.1), r(Dc, Dc, scale=Dc ** -0.5),
         r(Dc, scale=0.1), r(Dc, Dc, scale=Dc ** -0.5), r(Dc, scale=0.1)]
    ck, cv = (torch.randn(Bc, Tc, Dc, generator=g).to(cuda) for _ in range(2))
    if kv == "int8":
        ck, ks = _quantize_rows(ck)
        cv, vs = _quantize_rows(cv)
        ks, vs = ks[:, None].contiguous(), vs[:, None].contiguous()
    else:
        ck, cv = ck.to(dt), cv.to(dt)
        ks = vs = torch.ones(Bc, 1, Tc, device=cuda)
    args = (x, *w, ck, cv, ks, vs, Hc)
    before = attention.cross_block_decode.launches
    got = attention.cross_block_decode(*args)
    want = attention.cross_block_decode_plain(*args)
    torch.cuda.synchronize()
    assert attention.cross_block_decode.launches == before + 1
    tol = 1e-4 if dt == torch.float32 else _bf16_tol(want)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["bf16", "fp32"])
def test_mlp_kernel_matches_twin(cuda, act):
    g = torch.Generator().manual_seed(1)
    dt = torch.bfloat16 if act == "bf16" else torch.float32
    Bm, Dm, Fm = 7, 768, 3072
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(cuda, dt)
    args = (r(Bm, 1, Dm), 1 + r(Dm, scale=0.1), r(Dm, scale=0.1), r(Fm, Dm, scale=Dm ** -0.5),
            r(Fm, scale=0.1), r(Dm, Fm, scale=Fm ** -0.5), r(Dm, scale=0.1))
    got = attention.mlp_block(*args)
    want = attention.mlp_block_plain(*args)
    torch.cuda.synchronize()
    tol = 1e-4 if dt == torch.float32 else _bf16_tol(want)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["bf16", "fp32"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_kernel_matches_twin(cuda, act, causal):
    g = torch.Generator().manual_seed(2)
    dt = torch.bfloat16 if act == "bf16" else torch.float32
    Ba, Ta, Da, Ha = 3, 200, 256, 4
    q, k, v = (torch.randn(Ba, Ta, Da, generator=g).to(cuda, dt) for _ in range(3))
    key_bias = torch.zeros(Ba, Ta, device=cuda)
    key_bias[1, 150:] = float("-inf")
    kw = dict(causal=causal, key_bias=key_bias, valid_len=190)
    got = train_attention.train_attention_fwd(q, k, v, Ha, **kw)
    want = train_attention.train_attention_fwd_plain(q, k, v, Ha, **kw)
    torch.cuda.synchronize()
    tol = 1e-3 if dt == torch.float32 else _bf16_tol(want)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["bf16", "fp32"])
def test_cross_block_kv_group_kernel_matches_twin(cuda, act):
    g = torch.Generator().manual_seed(3)
    Bc, G, Tc, Dc, Hc = 3, 5, 300, 768, 12
    dt = torch.bfloat16 if act == "bf16" else torch.float32
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(cuda, dt)
    w = [1 + r(Dc, scale=0.1), r(Dc, scale=0.1), r(Dc, Dc, scale=Dc ** -0.5),
         r(Dc, scale=0.1), r(Dc, Dc, scale=Dc ** -0.5), r(Dc, scale=0.1)]
    ck, cv = r(Bc, Tc, Dc), r(Bc, Tc, Dc)
    ones = torch.ones(Bc, 1, Tc, device=cuda)
    args = (r(Bc * G, 1, Dc), *w, ck, cv, ones, ones, Hc)
    got = attention.cross_block_decode(*args, kv_group=G)
    want = attention.cross_block_decode_plain(*args, kv_group=G)
    torch.cuda.synchronize()
    tol = 1e-4 if dt == torch.float32 else _bf16_tol(want)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["bf16", "fp32"])
def test_self_sub_block_kernels_match_twins(cuda, act):
    """ln_matmul -> self_attend_decode -> matmul_residual at small.en widths,
    the attention reading row views of the fused projection."""
    g = torch.Generator().manual_seed(4)
    dt = torch.bfloat16 if act == "bf16" else torch.float32
    Ls, Bs, Cs, Ds, Hs = 3, 6, 40, 768, 12
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(cuda, dt)
    x = r(Bs, 1, Ds)
    ln = (1 + r(Ds, scale=0.1), r(Ds, scale=0.1))
    wqkv, bqkv = r(3 * Ds, Ds, scale=Ds ** -0.5), r(3 * Ds, scale=0.1)
    k_ring, v_ring = r(Ls, Bs, Cs, Ds), r(Ls, Bs, Cs, Ds)
    wo, bo = r(Ds, Ds, scale=Ds ** -0.5), r(Ds, scale=0.1)
    tol = (lambda want: 1e-4 * max(1.0, float(want.abs().max()))) if dt == torch.float32 \
        else _bf16_tol
    qkv = attention.ln_matmul(x, *ln, wqkv, bqkv)
    want = attention.ln_matmul_plain(x, *ln, wqkv, bqkv)
    torch.cuda.synchronize()
    assert float((qkv.float() - want.float()).abs().max()) <= tol(want)
    q, kn, vn = qkv[..., :Ds], qkv[..., Ds:2 * Ds], qkv[..., 2 * Ds:]
    for offset in (0, 1, 17, Cs):
        got = attention.self_attend_decode(q, k_ring, v_ring, kn, vn, offset, 1, n_head=Hs)
        want = attention.self_attend_decode_plain(q, k_ring, v_ring, kn, vn, offset, 1, n_head=Hs)
        torch.cuda.synchronize()
        assert float((got.float() - want.float()).abs().max()) <= tol(want), offset
    out = attention.matmul_residual(got, x, wo, bo)
    want = attention.matmul_residual_plain(got, x, wo, bo)
    torch.cuda.synchronize()
    assert float((out.float() - want.float()).abs().max()) <= tol(want)


@pytest.mark.gpu
def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(2, 1, 64, device=cuda, dtype=torch.float16)
    w = torch.zeros(256, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        attention.mlp_block(x, x[0, 0], x[0, 0], w, w[:, 0], w.T.contiguous(), x[0, 0])
    q = torch.zeros(1, 8, 96, device=cuda)  # head width 48
    with pytest.raises(ValueError):
        train_attention.train_attention_fwd(q, q, q, 2)
    ring = torch.zeros(2, 2, 8, 64, device=cuda)
    row = torch.zeros(2, 1, 64, device=cuda)
    with pytest.raises(ValueError):  # offset past the ring
        attention.self_attend_decode(row, ring, ring, row, row, 9, 0, n_head=4)
    with pytest.raises(ValueError):  # weights not in the activation dtype
        attention.ln_matmul(row, row[0, 0], row[0, 0], torch.zeros(192, 64, device=cuda,
                            dtype=torch.bfloat16), torch.zeros(192, device=cuda))
