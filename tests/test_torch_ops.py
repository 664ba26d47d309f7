"""The port's kernels (olmoasr_tpu_torch.ops) against the JAX package's Pallas
kernels run in interpret mode, on the same numpy inputs, in fp32: the decode
step's ln_matmul, self_attend_decode (with and without beam ancestry),
matmul_residual, cross_block_decode (with and without kv_group),
layer_block_decode and mlp_block, and the attention forward. The int8 cross
cache under bf16 activations is held to the TPU kernel's int8 q.K product
three times: its logits exactly (``_qk_logits``), the whole sub-block in
bf16, and a case built so that the int8 and the exact products land far
apart (``_outlier_q_case``).

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
keys, where p/l is large). The int8 q.K logits are integer dot products
times the same fp32 scales on both sides: 1e-6 relative. bf16 sub-blocks:
two bf16 steps at the output's largest magnitude (the JAX kernel rounds the
softmax weights to bf16 for the value product, the port keeps them fp32).
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


@pytest.mark.parametrize("kv", ["fp32", "bf16", "int8", "int8-bf16x"])
def test_cross_block_decode_matches_jax_kernel(jx, kv):
    """``int8-bf16x``: bf16 activations over the int8 cache, where the TPU
    kernel quantizes q per head for an int8 q.K product (the server's
    default path). Both sides get the same bf16-rounded parameters."""
    jnp = jx.jnp
    rng = _rng(0)
    p = _block_params(rng)
    bf16x = kv == "int8-bf16x"
    if bf16x:
        p = {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy() for k, v in p.items()}
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    ck = rng.standard_normal((L, B, T, D)).astype(np.float32)
    cv = rng.standard_normal((L, B, T, D)).astype(np.float32)
    if kv.startswith("int8"):
        ck_j, ks_j = jx.quantize_rows(jnp.asarray(ck))
        cv_j, vs_j = jx.quantize_rows(jnp.asarray(cv))
    else:
        dt = jnp.bfloat16 if kv == "bf16" else jnp.float32
        ck_j, cv_j = jnp.asarray(ck, dt), jnp.asarray(cv, dt)
        ks_j = vs_j = jnp.ones((L, B, T), jnp.float32)
    want = jx.attn.cross_block_decode(
        jnp.asarray(x, jnp.bfloat16 if bf16x else jnp.float32), jnp.asarray(p["ln_g"]),
        jnp.asarray(p["ln_b"]), jnp.asarray(p["wq"]), jnp.asarray(p["bq"]), jnp.asarray(p["wo"]),
        jnp.asarray(p["bo"]), ck_j, cv_j, ks_j, vs_j, jnp.int32(LAYER), n_head=H,
        interpret=True, wv_mode="dot",
    )
    # the port takes one layer, torch weight layout, and its cache dtype as is
    as_t = lambda a: _t(np.asarray(jnp.asarray(a, jnp.float32)))
    ck_t, cv_t = as_t(ck_j[LAYER]), as_t(cv_j[LAYER])
    if kv.startswith("int8"):
        ck_t, cv_t = ck_t.to(torch.int8), cv_t.to(torch.int8)
    elif kv == "bf16":
        ck_t, cv_t = ck_t.to(torch.bfloat16), cv_t.to(torch.bfloat16)
    ks_t, vs_t = as_t(ks_j[LAYER])[:, None], as_t(vs_j[LAYER])[:, None]
    act = torch.bfloat16 if bf16x else torch.float32
    w = [_layer(p, "ln_g"), _layer(p, "ln_b"), _layer(p, "wq", True), _layer(p, "bq"),
         _layer(p, "wo", True), _layer(p, "bo")]
    before = attention.cross_block_decode.launches
    got = attention.cross_block_decode(
        _t(x).to(act), *[t.to(act) for t in w], ck_t, cv_t, ks_t, vs_t, H,
    )
    assert got.dtype == act
    want = np.asarray(jnp.asarray(want, jnp.float32))
    _close(got, want, _bf16_tol(_t(want)) if bf16x else ATOL)
    assert attention.cross_block_decode.launches == before  # CPU: the plain twin


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_qk_logits_match_jax(jx, seed):
    """The twin's pre-softmax logits for bf16 activations over int8 keys are
    the TPU kernel's ``_qk_logits``: q rounded per head to int8, an integer
    dot product, times the head's q scale (the per-key scale comes after)."""
    jnp = jx.jnp
    rng = _rng(seed)
    dh = D // H
    q = (rng.standard_normal(D) * dh ** -0.5 * (1 + 3 * rng.random(D))).astype(np.float32)
    k = rng.integers(-127, 128, (T, D)).astype(np.int8)
    qm = np.where(np.arange(D)[:, None] // dh == np.arange(H)[None, :], q[:, None], 0.0)
    want = np.asarray(jx.attn._qk_logits(jnp.asarray(k), jnp.asarray(qm, jnp.float32),
                                         jnp.bfloat16))  # (T, H)
    assert attention.quantizes_q(torch.int8, torch.bfloat16)
    got = attention.qk_logits(_t(q).view(1, 1, H, dh), _t(k).view(1, T, H, dh), True)
    np.testing.assert_allclose(got[0, :, 0].T.numpy(), want, rtol=1e-6, atol=0)
    exact = attention.qk_logits(_t(q).view(1, 1, H, dh), _t(k).view(1, T, H, dh), False)
    assert not np.allclose(exact[0, :, 0].T.numpy(), want, rtol=1e-6, atol=0)


def _outlier_q_case(g, B, T, D, H, dtype, device="cpu"):
    """Cross sub-block inputs (x, ln_g, ln_b, wq, bq, wo, bo, ck, cv, ks, vs)
    on which the int8 q.K product and the exact one disagree far beyond
    bf16 rounding. wq = 0, so q = bq: one lane of 100 per head and +-0.35 on
    the others, which round to 0 against the head's int8 scale. Lane 0 of
    every head holds 3.0 in every key, the row's largest magnitude, so it
    quantizes exactly and the int8 logits are the same for every key: uniform
    weights. The exact product also sees the small lanes, and key T // 3
    lines them up (2.9 * their signs), so it takes most of the weight; its
    value is 3.0 in every lane."""
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    dh = D // H
    sign = torch.where(torch.randn(D, generator=g) >= 0, 1.0, -1.0)
    bq = 0.35 * sign
    bq[::dh] = 100.0
    k = torch.rand(B, T, D, generator=g) * 2 - 1
    k[:, T // 3] = 2.9 * sign
    k[:, :, ::dh] = 3.0
    v = torch.rand(B, T, D, generator=g) * 2 - 1
    v[:, T // 3] = 3.0
    (ck, ks), (cv, vs) = _quantize_rows(k), _quantize_rows(v)
    params = [torch.ones(D), torch.zeros(D), torch.zeros(D, D), bq,
              torch.randn(D, D, generator=g) * D ** -0.5, torch.zeros(D)]
    to = lambda t: t.to(device, dtype)
    return (to(torch.randn(B, 1, D, generator=g)), *map(to, params), ck.to(device),
            cv.to(device), ks[:, None].contiguous().to(device),
            vs[:, None].contiguous().to(device))


def test_outlier_q_case_separates_the_int8_product_from_the_exact_one(jx):
    """On ``_outlier_q_case`` the TPU kernel (bf16 x, int8 cache) agrees with
    the twin's int8 q.K product and lies far outside the bf16 tolerance of
    the exact product: a kernel that skipped the q rounding, the integer dot
    or the head's scale would fail the same check on the card."""
    jnp = jx.jnp
    args = _outlier_q_case(torch.Generator().manual_seed(0), B, T, D, H, torch.bfloat16)
    x, ln_g, ln_b, wq, bq, wo, bo, ck, cv, ks, vs = args
    j = lambda t, dt=jnp.bfloat16: jnp.asarray(t.float().numpy(), dt)
    stack = lambda t: jnp.stack([t] * L)
    want = jx.attn.cross_block_decode(
        j(x), stack(j(ln_g)), stack(j(ln_b)), stack(j(wq.T)), stack(j(bq)), stack(j(wo.T)),
        stack(j(bo)), stack(jnp.asarray(ck.numpy())), stack(jnp.asarray(cv.numpy())),
        stack(j(ks[:, 0], jnp.float32)), stack(j(vs[:, 0], jnp.float32)), jnp.int32(LAYER),
        n_head=H, interpret=True, wv_mode="dot",
    )
    want = _t(np.asarray(jnp.asarray(want, jnp.float32)))
    tol = _bf16_tol(want)
    got = attention.cross_block_decode(*args, H)
    exact = attention.cross_block_decode_plain(*args, H, quantize_q=False)
    assert float((got.float() - want).abs().max()) <= tol
    assert float((exact.float() - want).abs().max()) > 8 * tol


@pytest.mark.parametrize("act", ["fp32", "bf16"])
@pytest.mark.parametrize("offset", [0, 1, C // 2, C])
def test_layer_block_decode_matches_jax_kernel(jx, act, offset):
    """The self and cross sub-blocks in one launch over an int8 cross cache
    (the JAX kernel takes its keys transposed, the port (B, T, D)); the new
    key and value come back for the rings. ``bf16``: bf16 activations,
    parameters and rings, where the cross q.K product is the int8 one."""
    jnp = jx.jnp
    rng = _rng(20 + offset)
    p = _block_params(rng)
    bf16 = act == "bf16"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    k_ring, v_ring = (rng.standard_normal((L, B, C, D)).astype(np.float32) for _ in range(2))
    ck_j, ks_j = jx.quantize_rows(jnp.asarray(rng.standard_normal((L, B, T, D)), jnp.float32))
    cv_j, vs_j = jx.quantize_rows(jnp.asarray(rng.standard_normal((L, B, T, D)), jnp.float32))
    j = lambda a: jnp.asarray(a, jdt)
    sub = [j(p["ln_g"]), j(p["ln_b"]), j(p["wqkv"]), j(p["bqkv"]), j(p["wo"]), j(p["bo"])]
    cross = [j(p["ln_g"][::-1]), j(p["ln_b"][::-1]), j(p["wq"]), j(p["bq"]), j(p["wo"][::-1]),
             j(p["bo"][::-1])]
    mlp = [j(p["ln_g"]), j(p["ln_b"]), j(p["w1"]), j(p["b1"]), j(p["w2"]), j(p["b2"])]
    want_x, want_k, want_v = jx.attn.layer_block_decode(
        j(x), *sub, *cross, *mlp, j(k_ring), j(v_ring), ck_j.transpose(0, 1, 3, 2), cv_j,
        ks_j[:, :, None, :], vs_j[:, :, None, :], jnp.int32(offset), jnp.int32(LAYER),
        n_head=H, include_mlp=False, interpret=True,
    )
    as_t = lambda a, transpose=False: _t(np.asarray(jnp.asarray(
        a[LAYER].T if transpose else a[LAYER], jnp.float32))).to(tdt)
    before = attention.layer_block_decode.launches
    got_x, kv_new = attention.layer_block_decode(
        _t(x).to(tdt), *[as_t(a, transpose=t) for a, t in zip(sub, (0, 0, 1, 0, 1, 0))],
        *[as_t(a, transpose=t) for a, t in zip(cross, (0, 0, 1, 0, 1, 0))],
        _t(np.asarray(j(k_ring), np.float32)).to(tdt),
        _t(np.asarray(j(v_ring), np.float32)).to(tdt),
        _t(np.asarray(ck_j[LAYER])), _t(np.asarray(cv_j[LAYER])),
        _t(np.asarray(ks_j[LAYER]))[:, None], _t(np.asarray(vs_j[LAYER]))[:, None],
        offset, LAYER, n_head=H,
    )
    assert attention.layer_block_decode.launches == before  # CPU: the plain twin
    assert got_x.dtype == kv_new.dtype == tdt and kv_new.shape == (2, B, 1, D)
    for got, want in ((got_x, want_x), (kv_new[0], want_k), (kv_new[1], want_v)):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        _close(got, want, _bf16_tol(_t(want)) if bf16 else ATOL)


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


@pytest.mark.parametrize("beam_k", [2, 3])
@pytest.mark.parametrize("offset", [1, C // 2, C - 1])
def test_self_attend_decode_ancestry_matches_jax_kernel(jx, offset, beam_k):
    """Beam search: two windows of beam_k rows, a random ancestry map; row b
    reads position t from ring row (b // beam_k) * beam_k + anc[b, t]."""
    jnp = jx.jnp
    rng = _rng(10 + beam_k)
    Bk = 2 * beam_k
    q, k_new, v_new = (rng.standard_normal((Bk, 1, D)).astype(np.float32) for _ in range(3))
    k_ring, v_ring = (rng.standard_normal((L, Bk, C, D)).astype(np.float32) for _ in range(2))
    anc = rng.integers(0, beam_k, (Bk, C)).astype(np.int32)
    want = jx.attn.self_attend_decode(
        jnp.asarray(q), jnp.asarray(k_ring), jnp.asarray(v_ring), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.int32(offset), jnp.int32(LAYER), n_head=H, interpret=True,
        beam_anc=jnp.asarray(anc), beam_k=beam_k,
    )
    before = attention.self_attend_decode.launches
    got = attention.self_attend_decode(
        _t(q), _t(k_ring), _t(v_ring), _t(k_new), _t(v_new), offset, LAYER, n_head=H,
        beam_anc=_t(anc), beam_k=beam_k,
    )
    _close(got, want)
    assert attention.self_attend_decode.launches == before
    # the map matters: the identity reads other rows
    ident = np.broadcast_to(np.arange(Bk, dtype=np.int32)[:, None] % beam_k, (Bk, C))
    plain = attention.self_attend_decode(
        _t(q), _t(k_ring), _t(v_ring), _t(k_new), _t(v_new), offset, LAYER, n_head=H,
        beam_anc=_t(ident), beam_k=beam_k,
    )
    _close(plain, attention.self_attend_decode(
        _t(q), _t(k_ring), _t(v_ring), _t(k_new), _t(v_new), offset, LAYER, n_head=H))
    assert not np.allclose(plain.numpy(), got.numpy(), atol=ATOL)


def test_self_attend_decode_ancestry_rejects_int8_rings():
    ring = torch.zeros(1, 4, 8, 64, dtype=torch.int8)
    row = torch.zeros(4, 1, 64)
    anc = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="unquantized"):
        attention.self_attend_decode(row, ring, ring, row, row, 3, 0, n_head=4,
                                     beam_anc=anc, beam_k=2)


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
@pytest.mark.parametrize("act", ["bf16", "fp32", "int8"])
def test_cross_block_kv_group_kernel_matches_twin(cuda, act):
    """``int8``: bf16 activations over an int8 cache, the beams of a served
    request (int8 q.K)."""
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    g = torch.Generator().manual_seed(3)
    Bc, G, Tc, Dc, Hc = 3, 5, 300, 768, 12
    dt = torch.float32 if act == "fp32" else torch.bfloat16
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(cuda, dt)
    w = [1 + r(Dc, scale=0.1), r(Dc, scale=0.1), r(Dc, Dc, scale=Dc ** -0.5),
         r(Dc, scale=0.1), r(Dc, Dc, scale=Dc ** -0.5), r(Dc, scale=0.1)]
    ck, cv = r(Bc, Tc, Dc), r(Bc, Tc, Dc)
    ones = torch.ones(Bc, 1, Tc, device=cuda)
    ks = vs = ones
    if act == "int8":
        (ck, ks), (cv, vs) = _quantize_rows(ck), _quantize_rows(cv)
        ks, vs = ks[:, None].contiguous(), vs[:, None].contiguous()
    args = (r(Bc * G, 1, Dc), *w, ck, cv, ks, vs, Hc)
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
@pytest.mark.parametrize("act", ["bf16", "fp32"])
def test_self_attend_decode_ancestry_kernel_matches_twin(cuda, act):
    """Beam search at small.en widths: 4 windows x 5 beams, a random map,
    offsets across the chunk edges."""
    g = torch.Generator().manual_seed(5)
    dt = torch.bfloat16 if act == "bf16" else torch.float32
    Ls, K, Bs, Cs, Ds, Hs = 2, 5, 20, 200, 768, 12
    r = lambda *s: torch.randn(*s, generator=g).to(cuda, dt)
    qkv = r(Bs, 1, 3 * Ds)
    q, kn, vn = qkv[..., :Ds], qkv[..., Ds:2 * Ds], qkv[..., 2 * Ds:]
    k_ring, v_ring = r(Ls, Bs, Cs, Ds), r(Ls, Bs, Cs, Ds)
    anc = torch.randint(0, K, (Bs, Cs), generator=g, dtype=torch.int32).to(cuda)
    for offset in (0, 1, 128, 199):
        kw = dict(n_head=Hs, beam_anc=anc, beam_k=K)
        before = attention.self_attend_decode.launches
        got = attention.self_attend_decode(q, k_ring, v_ring, kn, vn, offset, 1, **kw)
        want = attention.self_attend_decode_plain(q, k_ring, v_ring, kn, vn, offset, 1, **kw)
        torch.cuda.synchronize()
        assert attention.self_attend_decode.launches == before + 1
        tol = 1e-4 * max(1.0, float(want.abs().max())) if dt == torch.float32 else _bf16_tol(want)
        assert float((got.float() - want.float()).abs().max()) <= tol, offset


@pytest.mark.gpu
@pytest.mark.parametrize("kv_group", [1, 5])
def test_cross_block_int8_qk_kernel_takes_the_int8_product(cuda, kv_group):
    """At small.en widths, on the case where the int8 and the exact q.K
    products land far apart: the kernel within bf16 tolerance of the int8
    twin, and far outside it against the exact one."""
    Bc, Tc, Dc, Hc = 3, 300, 768, 12
    args = list(_outlier_q_case(torch.Generator().manual_seed(6), Bc, Tc, Dc, Hc,
                                torch.bfloat16, cuda))
    args[0] = args[0].repeat_interleave(kv_group, dim=0)  # the beams of each window
    got = attention.cross_block_decode(*args, Hc, kv_group=kv_group)
    want = attention.cross_block_decode_plain(*args, Hc, kv_group=kv_group)
    exact = attention.cross_block_decode_plain(*args, Hc, kv_group=kv_group, quantize_q=False)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= _bf16_tol(want)
    assert float((got.float() - exact.float()).abs().max()) > 8 * _bf16_tol(want)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["bf16", "fp32"])
def test_layer_block_kernel_matches_twin(cuda, act):
    """The fused self + cross sub-blocks at small.en widths over an int8
    cross cache, offsets across the chunk edges; out and the new key and
    value."""
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    g = torch.Generator().manual_seed(7)
    dt = torch.bfloat16 if act == "bf16" else torch.float32
    Ls, Bs, Cs, Ts, Ds, Hs = 2, 5, 200, 300, 768, 12
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(cuda, dt)
    sub = lambda n: [1 + r(Ds, scale=0.1), r(Ds, scale=0.1), r(n * Ds, Ds, scale=Ds ** -0.5),
                     r(n * Ds, scale=0.1), r(Ds, Ds, scale=Ds ** -0.5), r(Ds, scale=0.1)]
    w_self, w_cross = sub(3), sub(1)
    rings = [r(Ls, Bs, Cs, Ds), r(Ls, Bs, Cs, Ds)]
    (ck, ks), (cv, vs) = (_quantize_rows(torch.randn(Bs, Ts, Ds, generator=g).to(cuda))
                          for _ in range(2))
    cache = (ck, cv, ks[:, None].contiguous(), vs[:, None].contiguous())
    x = r(Bs, 1, Ds)
    tol = (lambda want: 1e-4 * max(1.0, float(want.abs().max()))) if dt == torch.float32 \
        else _bf16_tol
    for offset in (0, 1, 128, 199):
        args = (x, *w_self, *w_cross, *rings, *cache, offset, 1)
        before = attention.layer_block_decode.launches
        got, kv = attention.layer_block_decode(*args, n_head=Hs)
        want, kv_want = attention.layer_block_decode_plain(*args, n_head=Hs)
        torch.cuda.synchronize()
        assert attention.layer_block_decode.launches == before + 1
        assert float((got.float() - want.float()).abs().max()) <= tol(want), offset
        assert float((kv.float() - kv_want.float()).abs().max()) <= tol(kv_want), offset


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
    with pytest.raises(ValueError):  # an ancestry map that is not int32 (B, C)
        attention.self_attend_decode(row, ring, ring, row, row, 3, 0, n_head=4,
                                     beam_anc=torch.zeros(2, 8, device=cuda), beam_k=2)
    with pytest.raises(ValueError):  # weights not in the activation dtype
        attention.ln_matmul(row, row[0, 0], row[0, 0], torch.zeros(192, 64, device=cuda,
                            dtype=torch.bfloat16), torch.zeros(192, device=cuda))
    vec, mat = torch.zeros(64, device=cuda), torch.zeros(64, 64, device=cuda)
    cache = torch.zeros(2, 16, 64, device=cuda)  # not int8
    scale = torch.ones(2, 1, 16, device=cuda)
    with pytest.raises(ValueError, match="int8"):
        attention.layer_block_decode(
            row, vec, vec, torch.zeros(192, 64, device=cuda), torch.zeros(192, device=cuda),
            mat, vec, vec, vec, mat, vec, mat, vec, ring, ring, cache, cache, scale, scale, 3, 0,
            n_head=4)
