"""The port's kernels (olmoasr_tpu_torch.ops) against the JAX package's Pallas
kernels run in interpret mode, on the same numpy inputs, in fp32: the decode
step's ln_matmul, self_attend_decode (with and without beam ancestry, over
int8 rings), matmul_residual, cross_block_decode (with and without
kv_group), cross_attend_decode, layer_block_decode (the self and cross
sub-blocks, and the whole layer) and mlp_block, and the attention forward.
The int8 cross cache under bf16 activations is held to the TPU kernel's int8
q.K product three times: its logits exactly (``_qk_logits``), the whole
sub-block in bf16, and a case built so that the int8 and the exact products
land far apart (``_outlier_q_case``); the int8 self rings the same way
(``_outlier_self_case``).

On the CPU each wrapper runs its plain PyTorch twin, so these tests pin the
twins' semantics to the TPU kernels; ``mlp_block``, ``matmul_residual`` and
``ln_matmul`` also at the beam's 160 rows and at 5, ``cross_block_decode``
at 32 windows x 5 rows and at 7, in fp32 and bf16. Tests marked ``gpu``
hold the CUDA kernels against the same twins; they skip where torch has no
CUDA device. The bf16 skinny projection (``csrc/skinny_proj.cu``, rows 1,
2, 5 and 6) is held there at every decode path's rows (1, 5, 64, 80, 160,
and 200 for a second pass over W), K of 768 and 3072, with and without GELU
and residual, the QKV width and the fp32 store of the cross q, two calls
bit-equal, its programmatically dependent launches bit-equal to serial
ones; ``csrc/linear.cu`` refuses bf16. The single-pass decode attention
(rows 8, 4, 4a and row 1's attention on ``csrc/decode_attention.cuh``) is
held at its stage edges, at every head width, at row counts whose launches
pick clusters of 1 to 16 blocks, row 1 at 1 to 11 query rows a cache row,
two launches bit-equal, one device kernel a call and four a bf16
``cross_block_decode`` (``-k single_pass``).
JAX is imported inside the fixture that needs it, so that the ``gpu`` tests
also run where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_ops.py``.
Tolerances: 2e-4 for the decode sub-blocks and projections (fp32 sums taken
in another order); 5e-4 for the attention forward, which rounds p to bf16 on both sides:
where the two fp32 scores differ in the last bit that rounding can flip by one
bf16 step and move an output by p/l * 2^-8 * |v| (about 2.6e-4 seen at 80
keys, where p/l is large). The int8 q.K logits are integer dot products
times the same fp32 scales on both sides: 1e-6 relative. bf16 sub-blocks
and ``self_attend_decode`` over bf16 rings: two bf16 steps at the output's
largest magnitude (the JAX kernel rounds the softmax weights to bf16 for the
value product, the port keeps them fp32).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from olmoasr_tpu_torch.ops import _build, attention, train_attention
from olmoasr_tpu_torch.perf import probe_proj

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
    _layer_block_case(jx, act, offset, include_mlp=False)


@pytest.mark.parametrize("act", ["fp32", "bf16"])
@pytest.mark.parametrize("offset", [0, C // 2, C])
def test_layer_block_decode_whole_layer_matches_jax_kernel(jx, act, offset):
    """``include_mlp=True``: the MLP's LayerNorm, W1, GELU, W2 and residual
    in the same launch, on the fp32 residual after the cross sub-block."""
    _layer_block_case(jx, act, offset, include_mlp=True)


def _layer_block_case(jx, act, offset, include_mlp):
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
        n_head=H, include_mlp=include_mlp, interpret=True,
    )
    as_t = lambda a, transpose=False: _t(np.asarray(jnp.asarray(
        a[LAYER].T if transpose else a[LAYER], jnp.float32))).to(tdt)
    mlp_t = [as_t(a, transpose=t) for a, t in zip(mlp, (0, 0, 1, 0, 1, 0))]
    before = attention.layer_block_decode.launches
    got_x, kv_new = attention.layer_block_decode(
        _t(x).to(tdt), *[as_t(a, transpose=t) for a, t in zip(sub, (0, 0, 1, 0, 1, 0))],
        *[as_t(a, transpose=t) for a, t in zip(cross, (0, 0, 1, 0, 1, 0))],
        _t(np.asarray(j(k_ring), np.float32)).to(tdt),
        _t(np.asarray(j(v_ring), np.float32)).to(tdt),
        _t(np.asarray(ck_j[LAYER])), _t(np.asarray(cv_j[LAYER])),
        _t(np.asarray(ks_j[LAYER]))[:, None], _t(np.asarray(vs_j[LAYER]))[:, None],
        offset, LAYER, n_head=H, include_mlp=include_mlp, mlp=mlp_t if include_mlp else None,
    )
    assert attention.layer_block_decode.launches == before  # CPU: the plain twin
    assert got_x.dtype == kv_new.dtype == tdt and kv_new.shape == (2, B, 1, D)
    for got, want in ((got_x, want_x), (kv_new[0], want_k), (kv_new[1], want_v)):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        _close(got, want, _bf16_tol(_t(want)) if bf16 else ATOL)


@pytest.mark.parametrize("kv,G", [
    pytest.param("fp32", 2, id="fp32"), pytest.param("bf16", 2, id="bf16"),
    pytest.param("int8-bf16x", 2, id="int8-bf16x"), pytest.param("fp32", 5, id="fp32-G5"),
    pytest.param("bf16", 5, id="bf16-G5"), pytest.param("int8-bf16x", 5, id="int8-bf16x-G5"),
])
def test_cross_block_decode_kv_group_matches_jax_kernel(jx, kv, G):
    """G query rows per cache row: row b reads cache row b // G. ``bf16``: a
    bf16 cache under fp32 activations; ``int8-bf16x``: bf16 activations and
    parameters over an int8 cache, where each row's q is quantized on its
    own for the int8 q.K product."""
    jnp = jx.jnp
    rng = _rng(5 if G == 2 else 6)
    p = _block_params(rng)
    bf16x = kv == "int8-bf16x"
    if bf16x:
        p = {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy() for k, v in p.items()}
    x = rng.standard_normal((B * G, 1, D)).astype(np.float32)
    if bf16x:
        ck_j, ks_j = jx.quantize_rows(jnp.asarray(rng.standard_normal((L, B, T, D)), jnp.float32))
        cv_j, vs_j = jx.quantize_rows(jnp.asarray(rng.standard_normal((L, B, T, D)), jnp.float32))
    else:
        dt = jnp.bfloat16 if kv == "bf16" else jnp.float32
        ck_j, cv_j = (jnp.asarray(rng.standard_normal((L, B, T, D)), dt) for _ in range(2))
        ks_j = vs_j = jnp.ones((L, B, T), jnp.float32)
    want = jx.attn.cross_block_decode(
        jnp.asarray(x, jnp.bfloat16 if bf16x else jnp.float32), jnp.asarray(p["ln_g"]),
        jnp.asarray(p["ln_b"]), jnp.asarray(p["wq"]), jnp.asarray(p["bq"]), jnp.asarray(p["wo"]),
        jnp.asarray(p["bo"]), ck_j, cv_j, ks_j, vs_j, jnp.int32(LAYER), n_head=H,
        interpret=True, wv_mode="dot", kv_group=G,
    )
    as_t = lambda a: _t(np.asarray(jnp.asarray(a, jnp.float32)))
    tdt = {"bf16": torch.bfloat16, "fp32": torch.float32, "int8-bf16x": torch.int8}[kv]
    act = torch.bfloat16 if bf16x else torch.float32
    w = [_layer(p, "ln_g"), _layer(p, "ln_b"), _layer(p, "wq", True), _layer(p, "bq"),
         _layer(p, "wo", True), _layer(p, "bo")]
    got = attention.cross_block_decode(
        _t(x).to(act), *[t.to(act) for t in w], as_t(ck_j[LAYER]).to(tdt),
        as_t(cv_j[LAYER]).to(tdt), as_t(ks_j[LAYER])[:, None], as_t(vs_j[LAYER])[:, None], H,
        kv_group=G,
    )
    assert got.dtype == act
    want = np.asarray(jnp.asarray(want, jnp.float32))
    _close(got, want, _bf16_tol(_t(want)) if bf16x else ATOL)


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


@pytest.mark.parametrize("act,offset", [
    *(pytest.param("fp32", o, id=str(o)) for o in (0, 1, 9, C)),
    *(pytest.param("bf16", o, id=f"bf16-{o}") for o in (0, 1, 9, C)),
])
def test_self_attend_decode_matches_jax_kernel(jx, act, offset):
    """Ring positions < offset plus the step's own key; the rest of the ring
    holds values that must not leak in. ``bf16``: bf16 rings, q, k_new and
    v_new. Tolerance: fp32 2e-4; bf16 two bf16 steps at the output's largest
    magnitude, because the JAX kernel rounds the normalised ring weights to
    bf16 for the value product and the twin keeps them fp32 (q's own
    rounding is exact: a bf16 q times dh^-0.5, a power of two)."""
    jnp = jx.jnp
    rng = _rng(8)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if act == "bf16" else (jnp.float32, torch.float32)
    q, k_new, v_new = (rng.standard_normal((B, 1, D)).astype(np.float32) for _ in range(3))
    k_ring, v_ring = (rng.standard_normal((L, B, C, D)).astype(np.float32) for _ in range(2))
    args = [jnp.asarray(a, jdt) for a in (q, k_ring, v_ring, k_new, v_new)]
    want = jx.attn.self_attend_decode(
        *args, jnp.int32(offset), jnp.int32(LAYER), n_head=H, interpret=True,
    )
    want = np.asarray(jnp.asarray(want, jnp.float32))
    before = attention.self_attend_decode.launches
    got = attention.self_attend_decode(
        *(_t(np.asarray(jnp.asarray(a, jnp.float32))).to(tdt) for a in args), offset, LAYER,
        n_head=H,
    )
    assert got.dtype == tdt and attention.self_attend_decode.launches == before
    _close(got, want, _bf16_tol(_t(want)) if act == "bf16" else ATOL)


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


def _int8_rings(jx, rng, rows=B):
    """(int8 k ring, int8 v ring, k scale, v scale) as the JAX package
    quantizes them: rows of the (L, rows, C, D) rings, scales (L, rows, 1, C)."""
    jnp = jx.jnp
    out = []
    for _ in range(2):
        q, scale = jx.quantize_rows(jnp.asarray(rng.standard_normal((L, rows, C, D)), jnp.float32))
        out.append((_t(np.asarray(q)), _t(np.asarray(scale))[:, :, None].contiguous()))
    (kq, ks), (vq, vs) = out
    return kq, vq, ks, vs


@pytest.mark.parametrize("act", ["fp32", "bf16"])
@pytest.mark.parametrize("offset", [0, 1, 9, C])
def test_self_attend_decode_int8_rings_match_jax_kernel(jx, act, offset):
    """int8 rings with per-position scales (``_self_decode_kernel_q8``): under
    bf16 the ring logits are the int8 q.K product and the weights are
    rounded to bf16; under fp32 the product is exact. Tolerance: fp32 2e-4;
    bf16 two bf16 steps at the output's largest magnitude."""
    jnp = jx.jnp
    rng = _rng(30 + offset)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if act == "bf16" else (jnp.float32, torch.float32)
    q, k_new, v_new = (rng.standard_normal((B, 1, D)).astype(np.float32) for _ in range(3))
    kq, vq, ks, vs = _int8_rings(jx, rng)
    want = jx.attn.self_attend_decode(
        jnp.asarray(q, jdt), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
        jnp.asarray(k_new, jdt), jnp.asarray(v_new, jdt), jnp.int32(offset), jnp.int32(LAYER),
        jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()), n_head=H, interpret=True,
    )
    want = np.asarray(jnp.asarray(want, jnp.float32))
    before = attention.self_attend_decode.launches
    got = attention.self_attend_decode(
        _t(q).to(tdt), kq, vq, _t(k_new).to(tdt), _t(v_new).to(tdt), offset, LAYER, n_head=H,
        k_scale=ks, v_scale=vs,
    )
    assert got.dtype == tdt and attention.self_attend_decode.launches == before
    _close(got, want, _bf16_tol(_t(want)) if act == "bf16" else ATOL)


def _outlier_self_case(g, L, B, C, D, H, dtype, device="cpu"):
    """self_attend_decode inputs (q, k_ring, v_ring, k_new, v_new) and the
    int8 rings' (k_scale, v_scale), built as ``_outlier_q_case``: q has one
    lane of 100 per head and +-0.35 on the others, which round to 0 against
    the head's int8 scale; lane 0 of every head holds 3.0 in every ring key,
    so the int8 logits are the same for every position; the exact product
    also sees the small lanes, which position C // 3 lines up, so it takes
    most of the weight; its value is 3.0 in every lane. This step's key is
    zero, far below the ring's logits."""
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    dh = D // H
    sign = torch.where(torch.randn(D, generator=g) >= 0, 1.0, -1.0)
    q = (0.35 * sign).expand(B, 1, D).clone()
    q[..., ::dh] = 100.0
    k = torch.rand(L, B, C, D, generator=g) * 2 - 1
    k[:, :, C // 3] = 2.9 * sign
    k[..., ::dh] = 3.0
    v = torch.rand(L, B, C, D, generator=g) * 2 - 1
    v[:, :, C // 3] = 3.0
    (kq, ks), (vq, vs) = _quantize_rows(k), _quantize_rows(v)
    to = lambda t: t.to(device, dtype)
    new = torch.zeros(B, 1, D)
    return ((to(q), kq.to(device), vq.to(device), to(new), to(torch.rand(B, 1, D, generator=g))),
            (ks[:, :, None].contiguous().to(device), vs[:, :, None].contiguous().to(device)))


def test_outlier_self_case_separates_the_int8_product_from_the_exact_one(jx):
    """On ``_outlier_self_case`` the TPU kernel (bf16 q, int8 rings) agrees
    with the twin's int8 q.K product and lies far outside the bf16 tolerance
    of a twin that takes the exact product (the mutant a kernel skipping the
    q rounding would match)."""
    jnp = jx.jnp
    (q, kq, vq, kn, vn), (ks, vs) = _outlier_self_case(torch.Generator().manual_seed(1), L, B,
                                                       C, D, H, torch.bfloat16)
    offset = C - 1
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    want = jx.attn.self_attend_decode(
        j(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()), j(kn), j(vn), jnp.int32(offset),
        jnp.int32(LAYER), jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()), n_head=H,
        interpret=True,
    )
    want = _t(np.asarray(jnp.asarray(want, jnp.float32)))
    tol = _bf16_tol(want)
    args = (q, kq, vq, kn, vn, offset, LAYER)
    got = attention.self_attend_decode(*args, n_head=H, k_scale=ks, v_scale=vs)
    exact = attention.self_attend_decode_plain(*args, n_head=H, k_scale=ks, v_scale=vs,
                                               quantize_q=False)
    assert float((got.float() - want).abs().max()) <= tol
    assert float((exact.float() - want).abs().max()) > 8 * tol


@pytest.mark.parametrize("kv", ["fp32", "bf16", "int8-bf16x", "int8-fp32x"])
def test_cross_attend_decode_matches_jax_kernel(jx, kv):
    """The standalone cross attention (``_cross_decode_kernel``): q projected
    but not scaled, (B, T, D) keys and values with per-key scales (ones
    when absent). ``int8-bf16x``: bf16 q over the int8 cache, the int8 q.K
    product; ``int8-fp32x``: fp32 q, the exact one. Tolerance: fp32 2e-4;
    bf16 two bf16 steps at the output's largest magnitude (the twin rounds
    where the TPU kernel rounds, so both land within one step)."""
    jnp = jx.jnp
    rng = _rng(40)
    bf16 = kv in ("bf16", "int8-bf16x")
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    q = rng.standard_normal((B, 1, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, D)).astype(np.float32) for _ in range(2))
    if kv.startswith("int8"):
        (k_j, ks_j), (v_j, vs_j) = (jx.quantize_rows(jnp.asarray(a)) for a in (k, v))
        scales_t = [_t(np.asarray(ks_j)), _t(np.asarray(vs_j))[:, None]]  # (B, T) and (B, 1, T)
    else:
        k_j, v_j, ks_j, vs_j = jnp.asarray(k, jdt), jnp.asarray(v, jdt), None, None
        scales_t = [None, None]
    want = jx.attn.cross_attend_decode(jnp.asarray(q, jdt), k_j, v_j, ks_j, vs_j, n_head=H,
                                       interpret=True)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    as_t = lambda a: _t(np.asarray(jnp.asarray(a, jnp.float32))).to(
        torch.int8 if kv.startswith("int8") else tdt)
    before = attention.cross_attend_decode.launches
    got = attention.cross_attend_decode(_t(q).to(tdt), as_t(k_j), as_t(v_j), *scales_t, n_head=H)
    assert got.dtype == tdt and attention.cross_attend_decode.launches == before
    _close(got, want, _bf16_tol(_t(want)) if bf16 else ATOL)


def test_decode_kernels_refuse_what_the_jax_kernels_refuse():
    """On the CPU too: int8 rings need their scales, and the fused layer
    block needs unquantized rings and the MLP's weights with include_mlp."""
    ring = torch.zeros(1, 2, 8, 64, dtype=torch.int8)
    row = torch.zeros(2, 1, 64)
    with pytest.raises(ValueError, match="k_scale"):
        attention.self_attend_decode(row, ring, ring, row, row, 3, 0, n_head=4)
    scale = torch.ones(1, 2, 1, 8)
    with pytest.raises(ValueError, match="k_scale"):  # scales without int8 rings
        attention.self_attend_decode(row, ring.float(), ring.float(), row, row, 3, 0, n_head=4,
                                     k_scale=scale, v_scale=scale)
    vec, mat = torch.zeros(64), torch.zeros(64, 64)
    cache, cscale = torch.zeros(2, 16, 64, dtype=torch.int8), torch.ones(2, 1, 16)
    args = [row, vec, vec, torch.zeros(192, 64), torch.zeros(192), mat, vec, vec, vec, mat, vec,
            mat, vec, ring, ring, cache, cache, cscale, cscale, 3, 0]
    with pytest.raises(ValueError, match="unquantized"):
        attention.layer_block_decode(*args, n_head=4)
    args[13] = args[14] = ring.float()
    with pytest.raises(ValueError, match="include_mlp"):
        attention.layer_block_decode(*args, n_head=4, include_mlp=True)


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


def _as(act, a):
    """numpy fp32 -> (jax array, torch tensor) holding the same values in the
    activation type."""
    import jax.numpy as jnp

    t = _t(a) if act == "fp32" else _t(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.float32 if act == "fp32" else jnp.bfloat16), t


def _close_act(got, want, act):
    want = np.asarray(want, np.float32)
    atol = ATOL if act == "fp32" else 2.0 ** -6 * float(np.abs(want).max())
    _close(got, want, atol)


@pytest.mark.parametrize("act", ["fp32", "bf16"])
@pytest.mark.parametrize("rows", [5, 160])
def test_mlp_block_plain_matches_jax_kernel_at_decode_rows(jx, rows, act):
    """The twin that the bf16 kernel (csrc/skinny_proj.cu) is held to, at the
    beam's 160 rows and at a row count that is no multiple of 16."""
    rng = _rng(11)
    p = _block_params(rng)
    xj, xt = _as(act, rng.standard_normal((rows, 1, D)).astype(np.float32))
    names = ("ln_g", "ln_b", "w1", "b1", "w2", "b2")
    stacked = [_as(act, p[n])[0] for n in names]
    want = jx.attn.mlp_block(xj, *stacked, jx.jnp.int32(LAYER), interpret=True)
    mine = [_as(act, np.ascontiguousarray(p[n][LAYER].T if n in ("w1", "w2") else p[n][LAYER]))[1]
            for n in names]
    got = attention.mlp_block_plain(xt, *mine)
    assert got.dtype == xt.dtype and got.shape == (rows, 1, D)
    _close_act(got, want, act)


@pytest.mark.parametrize("act", ["fp32", "bf16"])
@pytest.mark.parametrize("rows", [5, 160])
def test_matmul_residual_plain_matches_jax_kernel_at_decode_rows(jx, rows, act):
    rng = _rng(12)
    p = _block_params(rng)
    (aj, at), (xj, xt) = (_as(act, rng.standard_normal((rows, 1, D)).astype(np.float32))
                          for _ in range(2))
    want = jx.attn.matmul_residual(aj, xj, _as(act, p["wo"])[0], _as(act, p["bo"])[0],
                                   jx.jnp.int32(LAYER), interpret=True)
    got = attention.matmul_residual_plain(
        at, xt, _as(act, np.ascontiguousarray(p["wo"][LAYER].T))[1], _as(act, p["bo"][LAYER])[1])
    assert got.dtype == xt.dtype and got.shape == (rows, 1, D)
    _close_act(got, want, act)


@pytest.mark.parametrize("act", ["fp32", "bf16"])
@pytest.mark.parametrize("rows", [5, 160])
def test_ln_matmul_plain_matches_jax_kernel_at_decode_rows(jx, rows, act):
    """The twin that the bf16 QKV launches (csrc/skinny_proj.cu) are held
    to, at the beam's 160 rows and at a row count that is no multiple of
    16."""
    rng = _rng(14)
    p = _block_params(rng)
    xj, xt = _as(act, rng.standard_normal((rows, 1, D)).astype(np.float32))
    names = ("ln_g", "ln_b", "wqkv", "bqkv")
    want = jx.attn.ln_matmul(xj, *[_as(act, p[n])[0] for n in names], jx.jnp.int32(LAYER),
                             interpret=True)
    mine = [_as(act, np.ascontiguousarray(p[n][LAYER].T if n == "wqkv" else p[n][LAYER]))[1]
            for n in names]
    got = attention.ln_matmul_plain(xt, *mine)
    assert got.dtype == xt.dtype and got.shape == (rows, 1, 3 * D)
    _close_act(got, want, act)


@pytest.mark.parametrize("act", ["fp32", "bf16"])
@pytest.mark.parametrize("windows,group", [(32, 5), (7, 1)])
def test_cross_block_decode_plain_matches_jax_kernel_at_decode_rows(jx, windows, group, act):
    """The twin that row 1's bf16 launches (the projections on
    csrc/skinny_proj.cu, the cross pass on csrc/cross_attention.cu) are held
    to, over a cache in the activation type: the beam's 32 windows x 5 rows
    (kv_group 5, 160 rows) and a ragged 7 rows of one window each."""
    jnp = jx.jnp
    rng = _rng(15)
    p = _block_params(rng)
    xj, xt = _as(act, rng.standard_normal((windows * group, 1, D)).astype(np.float32))
    (ckj, ckt), (cvj, cvt) = (_as(act, rng.standard_normal((L, windows, T, D)).astype(np.float32))
                              for _ in range(2))
    ones = jnp.ones((L, windows, T), jnp.float32)
    names = ("ln_g", "ln_b", "wq", "bq", "wo", "bo")
    want = jx.attn.cross_block_decode(
        xj, *[_as(act, p[n])[0] for n in names], ckj, cvj, ones, ones, jnp.int32(LAYER),
        n_head=H, interpret=True, wv_mode="dot", kv_group=group,
    )
    mine = [_as(act, np.ascontiguousarray(p[n][LAYER].T if n in ("wq", "wo") else p[n][LAYER]))[1]
            for n in names]
    scale = torch.ones(windows, 1, T)
    got = attention.cross_block_decode_plain(xt, *mine, ckt[LAYER], cvt[LAYER], scale, scale, H,
                                             group)
    assert got.dtype == xt.dtype and got.shape == (windows * group, 1, D)
    _close_act(got, want, act)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_proj_plain_composes_the_twins(dtype):
    """The skinny projection's plain version (what the gpu tests and
    perf/probe_proj hold the kernel to) composes to mlp_block_plain,
    matmul_residual_plain, ln_matmul_plain and, with the fp32 store for q,
    cross_block_decode_plain bit for bit."""
    g = torch.Generator().manual_seed(13)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(dtype)
    x, attn = r(7, D), r(7, D)
    ln = (1 + r(D, scale=0.1), r(D, scale=0.1))
    w1, b1, w2, b2 = r(FF, D, scale=D ** -0.5), r(FF, scale=0.1), r(D, FF, scale=FF ** -0.5), \
        r(D, scale=0.1)
    h = attention._ln_f32(x, *ln).to(dtype)
    u = attention._proj_plain(h, w1, b1, gelu=True)
    assert torch.equal(attention._proj_plain(u, w2, b2, resid=x),
                       attention.mlp_block_plain(x, *ln, w1, b1, w2, b2))
    assert torch.equal(attention._proj_plain(attn, w2[:, :D].contiguous(), b2, resid=x),
                       attention.matmul_residual_plain(attn, x, w2[:, :D].contiguous(), b2))
    wqkv, bqkv = w1[:3 * D].contiguous(), b1[:3 * D].contiguous()
    assert torch.equal(attention._proj_plain(h, wqkv, bqkv),
                       attention.ln_matmul_plain(x, *ln, wqkv, bqkv))
    # the cross sub-block: q's product stored fp32 unrounded, then scaled
    wq, bq, wo, bo = r(D, D, scale=D ** -0.5), r(D, scale=0.1), r(D, D, scale=D ** -0.5), \
        r(D, scale=0.1)
    ck, cv = r(7, T, D), r(7, T, D)
    ones = torch.ones(7, 1, T)
    q = attention._proj_plain(h, wq, bq, out_f32=True)
    assert q.dtype == torch.float32
    q = q * attention._q_scale(D // H)
    a = attention._cross_attend_plain(q[:, None], ck, cv, ones, ones, H, False).to(dtype)
    assert torch.equal(attention._proj_plain(a[:, 0], wo, bo, resid=x),
                       attention.cross_block_decode_plain(x[:, None], *ln, wq, bq, wo, bo, ck,
                                                          cv, ones, ones, H)[:, 0])


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


def _proj(a, w, bias, resid=None, gelu=False, out_f32=False):
    return attention._proj(_build.lib(), _build.stream_ptr(a.device), a, w, bias, resid=resid,
                           gelu=gelu, out_f32=out_f32)


def _proj_layer_norm(x, g, b):
    return attention._proj_layer_norm(_build.lib(), _build.stream_ptr(x.device), x, g, b)


def _fp32_tol(want):
    """fp32 sums of the same exact bf16 products in another order."""
    return 1e-4 * max(1.0, float(want.abs().max()))


# the bf16 skinny projection (csrc/skinny_proj.cu): (K, N, epilogue) of the
# decode step's products -- Wo (+ residual), W1 (+ GELU), W2 (+ residual),
# QKV (bias alone), the cross q (bias, stored fp32) -- and the other mixes
# of GELU and residual
PROJ_CASES = [(768, 768, "resid"), (768, 3072, "gelu"), (3072, 768, "resid"), (3072, 768, ""),
              (768, 768, "gelu resid"), (3072, 3072, "gelu resid"), (768, 2304, ""),
              (768, 768, "f32")]


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 5, 64, 80, 160, 200])
@pytest.mark.parametrize("K,N,epi", PROJ_CASES)
def test_skinny_proj_kernel_matches_twin(cuda, M, K, N, epi):
    """Every row count of the decode paths (1, ragged 5, greedy 64, long-form
    80, beam 160; 200 takes a second pass over W), twice: the same bits."""
    g = torch.Generator().manual_seed(M * 7 + K)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(cuda, torch.bfloat16)
    kw = dict(a=r(M, K), w=r(N, K, scale=K ** -0.5), bias=r(N, scale=0.1), gelu="gelu" in epi,
              out_f32="f32" in epi)
    if "resid" in epi:
        kw["resid"] = r(M, N)
    got = _proj(**kw)
    again = probe_proj.launch(**kw, pdl=False)
    want = attention._proj_plain(**kw)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and got.dtype == want.dtype and bool(torch.isfinite(got).all())
    tol = _fp32_tol(want) if kw["out_f32"] else _bf16_tol(want)
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 5, 64, 80, 160])
def test_mlp_and_matmul_residual_bf16_kernels(cuda, M):
    """The wrappers of rows 2 and 6 at the decode paths' rows: one launch
    counted a call, the twin's values, the same bits twice."""
    g = torch.Generator().manual_seed(M)
    Dm, Fm = 768, 3072
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(cuda, torch.bfloat16)
    x = r(M, 1, Dm)
    mlp = (1 + r(Dm, scale=0.1), r(Dm, scale=0.1), r(Fm, Dm, scale=Dm ** -0.5),
           r(Fm, scale=0.1), r(Dm, Fm, scale=Fm ** -0.5), r(Dm, scale=0.1))
    mr = (r(M, 1, Dm), x, r(Dm, Dm, scale=Dm ** -0.5), r(Dm, scale=0.1))
    for fn, plain, args in ((attention.mlp_block, attention.mlp_block_plain, (x, *mlp)),
                            (attention.matmul_residual, attention.matmul_residual_plain, mr)):
        before = fn.launches
        got, again = fn(*args), fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        assert float((got.float() - want.float()).abs().max()) <= _bf16_tol(want), fn.__name__
        assert torch.equal(got, again), fn.__name__
    # the wrapper's programmatically dependent launches, against the same
    # launches each waiting for the one before in full
    u = probe_proj.launch(_proj_layer_norm(x, *mlp[:2]), *mlp[2:4], gelu=True, pdl=False)
    serial = probe_proj.launch(u, *mlp[4:], resid=x.view(M, Dm), pdl=False)
    assert torch.equal(attention.mlp_block(x, *mlp).view(M, Dm), serial)


def _cross_serial(x, ln_g, ln_b, wq, bq, wo, bo, ck, cv, ks, vs, n_head, kv_group):
    """cross_block_decode's bf16 launches, each waiting for the one before in
    full: the LayerNorm, q's product stored fp32, the attention, the output
    projection."""
    lib, stream = _build.lib(), _build.stream_ptr(x.device)
    B, _, Dc = x.shape
    T_ = ck.shape[1]
    q = probe_proj.launch(_proj_layer_norm(x, ln_g, ln_b), wq, bq, out_f32=True, pdl=False)
    attn = torch.empty((B, Dc), dtype=x.dtype, device=x.device)
    _build.check(lib.olm_cross_attention(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        attn.data_ptr(), B, T_, Dc, n_head, kv_group, _build.dtype_code(ck.dtype),
        _build.dtype_code(x.dtype), attention._q_scale(Dc // n_head), stream), "cross attention")
    return probe_proj.launch(attn, wo, bo, resid=x.view(B, Dc), pdl=False)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 5, 64, 80, 160])
def test_ln_matmul_and_cross_block_bf16_kernels(cuda, M):
    """The bf16 wrappers of rows 5 and 1 at the decode paths' rows (80 and
    160 as 5 rows a window over a bf16 cross cache): one launch counted a
    call, the twin's values, the same bits twice, and the programmatically
    dependent launches bit-equal to launches that each wait for the one
    before in full."""
    g = torch.Generator().manual_seed(100 + M)
    Dm, Hm, Tm = 768, 12, 300
    G = 5 if M in (80, 160) else 1
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(cuda, torch.bfloat16)
    x = r(M, 1, Dm)
    ln = (1 + r(Dm, scale=0.1), r(Dm, scale=0.1))
    lm = (x, *ln, r(3 * Dm, Dm, scale=Dm ** -0.5), r(3 * Dm, scale=0.1))
    ones = torch.ones(M // G, 1, Tm, device=cuda)
    cross = (x, *ln, r(Dm, Dm, scale=Dm ** -0.5), r(Dm, scale=0.1), r(Dm, Dm, scale=Dm ** -0.5),
             r(Dm, scale=0.1), r(M // G, Tm, Dm), r(M // G, Tm, Dm), ones, ones, Hm, G)
    for fn, plain, args in ((attention.ln_matmul, attention.ln_matmul_plain, lm),
                            (attention.cross_block_decode, attention.cross_block_decode_plain,
                             cross)):
        before = fn.launches
        got, again = fn(*args), fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        assert got.shape == want.shape and got.dtype == torch.bfloat16, fn.__name__
        assert float((got.float() - want.float()).abs().max()) <= _bf16_tol(want), fn.__name__
        assert torch.equal(got, again), fn.__name__
    serial = probe_proj.launch(_proj_layer_norm(x, *ln), *lm[3:], pdl=False)
    assert torch.equal(attention.ln_matmul(*lm).view(M, 3 * Dm), serial)
    assert torch.equal(attention.cross_block_decode(*cross).view(M, Dm), _cross_serial(*cross))


@pytest.mark.gpu
def test_linear_refuses_bf16(cuda):
    """csrc/linear.cu is fp32 only: its product and its LayerNorm refuse
    bf16 (the bf16 projections run on csrc/skinny_proj.cu)."""
    lib, stream = _build.lib(), _build.stream_ptr(cuda)
    a = torch.zeros(4, 64, device=cuda, dtype=torch.bfloat16)
    out = torch.empty(4, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="linear"):
        attention._linear(lib, stream, a, a.new_zeros(64, 64), a[0], out)
    with pytest.raises(RuntimeError, match="layer norm"):
        attention._layer_norm(lib, stream, a, a[0], a[0])
    f = a.float()  # the fp32 forms of the same calls launch
    attention._linear(lib, stream, f, f.new_zeros(64, 64), f[0], out.float())
    attention._layer_norm(lib, stream, f, f[0], f[0])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 5, 64, 160])
@pytest.mark.parametrize("K", [768, 1280])
def test_skinny_proj_layer_norm_matches_twin(cuda, M, K):
    g = torch.Generator().manual_seed(M + K)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(cuda, torch.bfloat16)
    x, ln = 3 + r(M, K), (1 + r(K, scale=0.1), r(K, scale=0.1))
    got = _proj_layer_norm(x, *ln)
    want = attention._ln_f32(x, *ln).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= _bf16_tol(want)


@pytest.mark.gpu
def test_skinny_proj_refuses_what_it_does_not_take(cuda):
    """A LayerNorm past 1280 columns, K that is no multiple of 8 and (through
    the probe's entry) a cluster past 8 blocks raise: the launch is refused,
    nothing falls back."""
    a = torch.zeros(4, 2048, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(64, 2048, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="layer norm"):
        _proj_layer_norm(a, a[0], a[0])
    with pytest.raises(RuntimeError, match="skinny projection"):
        _proj(a[:, :2044].contiguous(), w[:, :2044].contiguous(), b)
    with pytest.raises(RuntimeError, match="skinny projection"):
        probe_proj.launch(a, w, b, cs=9)


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
@pytest.mark.parametrize("act", ["bf16", "fp32"])
def test_self_attend_decode_int8_ring_kernel_matches_twin(cuda, act):
    """int8 rings at small.en widths, q, k_new and v_new as row views of a
    fused projection, offsets across the chunk edges; under bf16 also the
    outlier case, where the kernel must take the int8 q.K product."""
    g = torch.Generator().manual_seed(8)
    dt = torch.bfloat16 if act == "bf16" else torch.float32
    Ls, Bs, Cs, Ds, Hs = 2, 6, 200, 768, 12
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    qkv = torch.randn(Bs, 1, 3 * Ds, generator=g).to(cuda, dt)
    q, kn, vn = qkv[..., :Ds], qkv[..., Ds:2 * Ds], qkv[..., 2 * Ds:]
    (kq, ks), (vq, vs) = (_quantize_rows(torch.randn(Ls, Bs, Cs, Ds, generator=g).to(cuda))
                          for _ in range(2))
    scales = dict(k_scale=ks[:, :, None].contiguous(), v_scale=vs[:, :, None].contiguous())
    for offset in (0, 1, 128, 199):
        before = attention.self_attend_decode.q8_launches
        got = attention.self_attend_decode(q, kq, vq, kn, vn, offset, 1, n_head=Hs, **scales)
        want = attention.self_attend_decode_plain(q, kq, vq, kn, vn, offset, 1, n_head=Hs,
                                                  **scales)
        torch.cuda.synchronize()
        assert attention.self_attend_decode.q8_launches == before + 1
        tol = 1e-4 * max(1.0, float(want.abs().max())) if dt == torch.float32 else _bf16_tol(want)
        assert float((got.float() - want.float()).abs().max()) <= tol, offset
    if dt == torch.bfloat16:
        (q, kq, vq, kn, vn), (ks, vs) = _outlier_self_case(g, Ls, Bs, Cs, Ds, Hs, dt, cuda)
        args = (q, kq, vq, kn, vn, Cs - 1, 1)
        got = attention.self_attend_decode(*args, n_head=Hs, k_scale=ks, v_scale=vs)
        want = attention.self_attend_decode_plain(*args, n_head=Hs, k_scale=ks, v_scale=vs)
        exact = attention.self_attend_decode_plain(*args, n_head=Hs, k_scale=ks, v_scale=vs,
                                                   quantize_q=False)
        torch.cuda.synchronize()
        assert float((got.float() - want.float()).abs().max()) <= _bf16_tol(want)
        assert float((got.float() - exact.float()).abs().max()) > 8 * _bf16_tol(want)


@pytest.mark.gpu
@pytest.mark.parametrize("act,kv", [("bf16", "bf16"), ("bf16", "int8"), ("fp32", "fp32"),
                                    ("fp32", "int8")])
def test_cross_attend_decode_kernel_matches_twin(cuda, act, kv):
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    g = torch.Generator().manual_seed(9)
    Bc, Tc, Dc, Hc = 5, 300, 768, 12
    dt = torch.bfloat16 if act == "bf16" else torch.float32
    q = torch.randn(Bc, 1, Dc, generator=g).to(cuda, dt)
    k, v = (torch.randn(Bc, Tc, Dc, generator=g).to(cuda) for _ in range(2))
    scales = (None, None)
    if kv == "int8":
        (k, ks), (v, vs) = _quantize_rows(k), _quantize_rows(v)
        scales = (ks, vs[:, None].contiguous())
    else:
        k, v = k.to(dt), v.to(dt)
    before = attention.cross_attend_decode.launches
    got = attention.cross_attend_decode(q, k, v, *scales, n_head=Hc)
    want = attention.cross_attend_decode_plain(q, k, v, *scales, n_head=Hc)
    torch.cuda.synchronize()
    assert attention.cross_attend_decode.launches == before + 1
    tol = 1e-4 * max(1.0, float(want.abs().max())) if dt == torch.float32 else _bf16_tol(want)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["bf16", "fp32"])
def test_layer_block_whole_layer_kernel_matches_twin(cuda, act):
    """include_mlp=True at small.en widths (F = 3072) over an int8 cross
    cache: the layer's output and the new key and value."""
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    g = torch.Generator().manual_seed(10)
    dt = torch.bfloat16 if act == "bf16" else torch.float32
    Ls, Bs, Cs, Ts, Ds, Hs, Fs = 2, 5, 200, 300, 768, 12, 3072
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(cuda, dt)
    sub = lambda n: [1 + r(Ds, scale=0.1), r(Ds, scale=0.1), r(n * Ds, Ds, scale=Ds ** -0.5),
                     r(n * Ds, scale=0.1), r(Ds, Ds, scale=Ds ** -0.5), r(Ds, scale=0.1)]
    mlp = [1 + r(Ds, scale=0.1), r(Ds, scale=0.1), r(Fs, Ds, scale=Ds ** -0.5),
           r(Fs, scale=0.1), r(Ds, Fs, scale=Fs ** -0.5), r(Ds, scale=0.1)]
    rings = [r(Ls, Bs, Cs, Ds), r(Ls, Bs, Cs, Ds)]
    (ck, ks), (cv, vs) = (_quantize_rows(torch.randn(Bs, Ts, Ds, generator=g).to(cuda))
                          for _ in range(2))
    cache = (ck, cv, ks[:, None].contiguous(), vs[:, None].contiguous())
    x = r(Bs, 1, Ds)
    tol = (lambda want: 1e-4 * max(1.0, float(want.abs().max()))) if dt == torch.float32 \
        else _bf16_tol
    for offset in (0, 128, 199):
        args = (x, *sub(3), *sub(1), *rings, *cache, offset, 1)
        kw = dict(n_head=Hs, include_mlp=True, mlp=mlp)
        before = attention.layer_block_decode.mlp_launches
        got, kv = attention.layer_block_decode(*args, **kw)
        want, kv_want = attention.layer_block_decode_plain(*args, **kw)
        torch.cuda.synchronize()
        assert attention.layer_block_decode.mlp_launches == before + 1
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


def _device_kernels(fn) -> list:
    """The names of the device kernels one call of ``fn`` launches
    (``torch.profiler``, after a warm-up call). A profile that recorded no
    device event at all is taken again, up to three profiles: the tracer
    now and then returns an empty trace on the card."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


# the single-pass core's edges: its 32-key stages (at small.en's head width),
# and its slices of at least 64 keys, where a launch over few rows splits a
# (row, head) pair's keys over a cluster of up to 16 blocks (on a 132-SM
# H100 at small.en's widths: 6 rows take 1, 2, 4 and 7 blocks at offsets 64,
# 65, 224 and 447, and 7 at T = 1500; 1 row 16 at T = 1500); 64 rows take
# one block a pair. Head widths: small.en's 64, and 8, 16 and 32.
SELF_OFFSETS = (0, 1, 31, 32, 33, 63, 64, 65, 224, 447)
SINGLE_PASS_SHAPES = ((1, 768, 12), (6, 768, 12), (64, 768, 12), (6, 64, 8), (6, 64, 4),
                      (6, 256, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["bf16", "fp32", "int8-bf16", "int8-fp32"])
def test_self_attend_decode_single_pass_kernel(cuda, act):
    """Rows 4 and 4a on the single-pass core (``csrc/decode_attention.cuh``,
    ``onepass``): bf16 and fp32 rings, and int8 rings with their (L, B, 1,
    C) scales under bf16 (the int8 q.K product, weights rounded to bf16) and
    fp32 activations; a C=448 ring, q, k_new and v_new row views of a fused
    QKV row; offsets 0 (the new key alone), 1, the stage and slice edges,
    224 and 447, at each of ``SINGLE_PASS_SHAPES`` (rows, width, heads; int8
    rings need a head width of 16 or more, and the launch refuses 8); two
    launches bit-equal (the rank-order merge); one device kernel a call."""
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    g = torch.Generator().manual_seed(11)
    q8 = act.startswith("int8")
    dt = torch.bfloat16 if act.endswith("bf16") else torch.float32
    Ls, Cs = 2, 448
    tol = (lambda want: 1e-4 * max(1.0, float(want.abs().max()))) if dt == torch.float32 \
        else _bf16_tol
    err = lambda got, want: float((got.float() - want.float()).abs().max())
    for Bs, Ds, Hs in SINGLE_PASS_SHAPES:
        qkv = torch.randn(Bs, 1, 3 * Ds, generator=g).to(cuda, dt)
        q, kn, vn = qkv[..., :Ds], qkv[..., Ds:2 * Ds], qkv[..., 2 * Ds:]
        k_ring, v_ring = (torch.randn(Ls, Bs, Cs, Ds, generator=g).to(cuda) for _ in range(2))
        kw = dict(n_head=Hs)
        if q8:
            (k_ring, ks), (v_ring, vs) = _quantize_rows(k_ring), _quantize_rows(v_ring)
            kw.update(k_scale=ks[:, :, None].contiguous(), v_scale=vs[:, :, None].contiguous())
        else:
            k_ring, v_ring = k_ring.to(dt), v_ring.to(dt)
        if q8 and Ds // Hs < 16:
            with pytest.raises(RuntimeError):
                attention.self_attend_decode(q, k_ring, v_ring, kn, vn, 1, 1, **kw)
            continue
        for offset in SELF_OFFSETS:
            args = (q, k_ring, v_ring, kn, vn, offset, 1)
            before = attention.self_attend_decode.launches
            before_q8 = attention.self_attend_decode.q8_launches
            got = attention.self_attend_decode(*args, **kw)
            again = attention.self_attend_decode(*args, **kw)
            want = attention.self_attend_decode_plain(*args, **kw)
            torch.cuda.synchronize()
            assert attention.self_attend_decode.launches == before + 2
            assert attention.self_attend_decode.q8_launches == before_q8 + 2 * q8
            assert err(got, want) <= tol(want), (Bs, Ds, Hs, offset)
            assert torch.equal(got, again), (Bs, Ds, Hs, offset)
        names = _device_kernels(lambda: attention.self_attend_decode(
            q, k_ring, v_ring, kn, vn, 224, 1, **kw))
        assert len(names) == 1 and "attend_kernel" in names[0], names


@pytest.mark.gpu
@pytest.mark.parametrize("act,kv", [("bf16", "bf16"), ("bf16", "int8"), ("fp32", "fp32"),
                                    ("fp32", "int8")])
def test_cross_block_decode_single_pass_kernel(cuda, act, kv):
    """Row 1 with its attention on the single-pass core: G = 1, 2, 5, 8 and
    11 query rows a cache row (8 and 11: a window's rows over two and three
    blocks), 1, 16 and 32 windows, T = 1, 130 and 1500, at small.en's
    widths, in each mode (over the int8 cache under bf16 the int8 q.K
    product, under fp32 the exact one), and G = 2, 5 and 11 at head widths
    32, 16 and 8; within the
    tolerances of the split pass's tests of its twin, two calls bit-equal;
    a bf16 call four device kernels (LayerNorm, Wq, the core's attention:
    `attend_kernel` at G = 1, `group_kernel` above; Wo), none the split
    pass's."""
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    g = torch.Generator().manual_seed(13)
    dt = torch.bfloat16 if act == "bf16" else torch.float32
    Dc, Hc = 768, 12
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(cuda, dt)
    w = [1 + r(Dc, scale=0.1), r(Dc, scale=0.1), r(Dc, Dc, scale=Dc ** -0.5),
         r(Dc, scale=0.1), r(Dc, Dc, scale=Dc ** -0.5), r(Dc, scale=0.1)]
    err = lambda got, want: float((got.float() - want.float()).abs().max())
    fn = attention.cross_block_decode
    for windows in (1, 16, 32):
        for Tc in (1, 130, 1500):
            ck, cv = (torch.randn(windows, Tc, Dc, generator=g).to(cuda) for _ in range(2))
            if kv == "int8":
                (ck, ks), (cv, vs) = _quantize_rows(ck), _quantize_rows(cv)
                ks, vs = ks[:, None].contiguous(), vs[:, None].contiguous()
            else:
                ck, cv = ck.to(dt), cv.to(dt)
                ks = vs = torch.ones(windows, 1, Tc, device=cuda)
            for G in (1, 2, 5, 8, 11):
                args = (r(windows * G, 1, Dc), *w, ck, cv, ks, vs, Hc)
                before = fn.launches
                got, again = fn(*args, kv_group=G), fn(*args, kv_group=G)
                want = attention.cross_block_decode_plain(*args, kv_group=G)
                torch.cuda.synchronize()
                assert fn.launches == before + 2
                tol = 1e-4 if dt == torch.float32 else _bf16_tol(want)
                assert got.dtype == dt and err(got, want) <= tol, (windows, Tc, G)
                assert torch.equal(got, again), (windows, Tc, G)
    if act == "bf16":  # over the last cache (32 windows, T = 1500)
        for G in (1, 5):
            args = (r(windows * G, 1, Dc), *w, ck, cv, ks, vs, Hc)
            names = _device_kernels(lambda: fn(*args, kv_group=G))
            core = [k for k in names if "attend_kernel" in k or "group_kernel" in k]
            assert len(names) == 4 and len(core) == 1, names
            assert not any("attn_partial" in k or "attn_combine" in k for k in names), names
    # the other head widths (fewer lanes a key than rows a block: each row's
    # own softmax weights), 16 windows, T = 130; int8 keys need 16 or more
    for Dw, Hw in ((256, 8), (64, 4), (64, 8)):
        if kv == "int8" and Dw // Hw < 16:
            continue
        w = [1 + r(Dw, scale=0.1), r(Dw, scale=0.1), r(Dw, Dw, scale=Dw ** -0.5),
             r(Dw, scale=0.1), r(Dw, Dw, scale=Dw ** -0.5), r(Dw, scale=0.1)]
        ck, cv = (torch.randn(16, 130, Dw, generator=g).to(cuda) for _ in range(2))
        if kv == "int8":
            (ck, ks), (cv, vs) = _quantize_rows(ck), _quantize_rows(cv)
            ks, vs = ks[:, None].contiguous(), vs[:, None].contiguous()
        else:
            ck, cv = ck.to(dt), cv.to(dt)
            ks = vs = torch.ones(16, 1, 130, device=cuda)
        for G in (2, 5, 11):
            args = (r(16 * G, 1, Dw), *w, ck, cv, ks, vs, Hw)
            got, again = fn(*args, kv_group=G), fn(*args, kv_group=G)
            want = attention.cross_block_decode_plain(*args, kv_group=G)
            torch.cuda.synchronize()
            tol = 1e-4 if dt == torch.float32 else _bf16_tol(want)
            assert err(got, want) <= tol, (Dw, Hw, G)
            assert torch.equal(got, again), (Dw, Hw, G)


@pytest.mark.gpu
@pytest.mark.parametrize("act,kv", [("bf16", "bf16"), ("bf16", "int8"), ("fp32", "fp32")])
def test_cross_attend_decode_single_pass_kernel(cuda, act, kv):
    """Row 8 on the single-pass core in each of its modes: T = 1, 130 and
    1500 at each of ``SINGLE_PASS_SHAPES`` (an int8 cache needs a head width
    of 16 or more, and the launch refuses 8), two launches bit-equal; one
    device kernel a call; over the int8 cache the outlier-q case, where the
    kernel must take the int8 q.K product (within tolerance of its twin, far
    outside it against the exact product)."""
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    g = torch.Generator().manual_seed(12)
    dt = torch.bfloat16 if act == "bf16" else torch.float32
    tol = (lambda want: 1e-4 * max(1.0, float(want.abs().max()))) if dt == torch.float32 \
        else _bf16_tol
    err = lambda got, want: float((got.float() - want.float()).abs().max())
    for Bc, Dc, Hc in SINGLE_PASS_SHAPES:
        for Tc in (1, 130, 1500):
            q = torch.randn(Bc, 1, Dc, generator=g).to(cuda, dt)
            k, v = (torch.randn(Bc, Tc, Dc, generator=g).to(cuda) for _ in range(2))
            scales = (None, None)
            if kv == "int8":
                (k, ks), (v, vs) = _quantize_rows(k), _quantize_rows(v)
                scales = (ks, vs[:, None].contiguous())
            else:
                k, v = k.to(dt), v.to(dt)
            args = (q, k, v, *scales)
            if kv == "int8" and Dc // Hc < 16:
                with pytest.raises(RuntimeError):
                    attention.cross_attend_decode(*args, n_head=Hc)
                break
            before = attention.cross_attend_decode.launches
            got = attention.cross_attend_decode(*args, n_head=Hc)
            again = attention.cross_attend_decode(*args, n_head=Hc)
            want = attention.cross_attend_decode_plain(*args, n_head=Hc)
            torch.cuda.synchronize()
            assert attention.cross_attend_decode.launches == before + 2
            assert got.dtype == dt and err(got, want) <= tol(want), (Bc, Dc, Hc, Tc)
            assert torch.equal(got, again), (Bc, Dc, Hc, Tc)
        else:
            names = _device_kernels(lambda: attention.cross_attend_decode(*args, n_head=Hc))
            assert len(names) == 1 and "attend_kernel" in names[0], names
    Bc, Dc, Hc = 4, 768, 12
    if kv == "int8":
        case = _outlier_q_case(g, Bc, 1500, Dc, Hc, dt, cuda)
        q = case[4].expand(Bc, 1, Dc).contiguous()  # q = bq, the outlier lanes
        args = (q, *case[7:])
        got = attention.cross_attend_decode(*args, n_head=Hc)
        want = attention.cross_attend_decode_plain(*args, n_head=Hc)
        exact = attention.cross_attend_decode_plain(q.float(), *case[7:], n_head=Hc)
        torch.cuda.synchronize()
        assert err(got, want) <= _bf16_tol(want)
        assert err(got, exact) > 8 * _bf16_tol(want)
