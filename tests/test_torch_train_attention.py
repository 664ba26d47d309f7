"""The port's attention backward (``ops.train_attention``: the autograd
function ``TrainAttention``, the kernel wrapper ``train_attention_bwd`` and
its plain twin) against ``jax.vjp`` of the JAX package's ``train_attention``,
whose backward is the Pallas kernel ``_attn_bwd`` run in interpret mode, on
the same numpy inputs. On the CPU the port runs its plain forward and plain
backward; the tests marked ``gpu`` hold the CUDA kernel to the twin at the
three training shapes.

Tolerances. bf16: two bf16 steps at the gradient's largest magnitude. fp32:
1e-5 x max|ref| on all but 1% of the elements, and two bf16 steps on those:
both sides round ds and pn to bf16 before their products (as the TPU kernel
does even for fp32 inputs), and where the two sides' fp32 scores or dp differ
in the last bit (exp and sums in another library and order) that rounding
flips by one bf16 step in a few elements; every other element agrees to the
last bits. A twin that takes delta from rowsum(dO * O), or keeps pn in fp32
for dV, moves most elements and fails (``test_mutants_fail_the_fp32_check``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from olmoasr_tpu_torch.ops import train_attention as ta
from olmoasr_tpu_torch.perf import _probes as P
from olmoasr_tpu_torch.perf import probe_bwd, probe_pack, probe_pipe

H = 2
CASES = {
    # name: (Tq, Tk, causal, key bias, valid_len)
    "self T=200": (200, 200, False, False, None),
    "causal+bias T=200": (200, 200, True, True, None),
    "cross 160x300": (160, 300, False, False, None),
    "cross valid_len=250": (160, 300, False, False, 250),
}
DTYPES = ("fp32", "bf16")


def _inputs(Tq, Tk, bias, seed=0, B=2, n_head=H):
    rng = np.random.default_rng(seed)
    D = 64 * n_head
    q, k, v, g = (rng.standard_normal((B, t, D)).astype(np.float32) for t in (Tq, Tk, Tk, Tq))
    kb = None
    if bias:  # -inf suffixes of different lengths: pads after each row's text
        lens = np.linspace(Tk, Tk // 3, B).astype(int)
        kb = np.where(np.arange(Tk)[None] < lens[:, None], 0.0, -np.inf).astype(np.float32)
    return q, k, v, g, kb


def _agree(got: torch.Tensor, want: np.ndarray, fp32: bool) -> bool:
    err = np.abs(got.float().numpy() - want)
    scale = float(np.abs(want).max())
    two_steps = 2.0 ** -6 * scale
    if not fp32:
        return float(err.max()) <= two_steps
    return float(err.max()) <= two_steps and float((err > 1e-5 * scale).mean()) <= 0.01


@pytest.fixture(scope="module")
def jax_grads():
    """(dq, dk, dv) and the output of the JAX kernels for every case."""
    import jax
    import jax.numpy as jnp

    from olmoasr_tpu.ops.train_attention import train_attention

    out = {}
    for name, (Tq, Tk, causal, bias, valid_len) in CASES.items():
        q, k, v, g, kb = _inputs(Tq, Tk, bias)
        for dt in DTYPES:
            jd = jnp.float32 if dt == "fp32" else jnp.bfloat16
            fn = lambda a, b, c: train_attention(
                a, b, c, H, causal, True, None if kb is None else jnp.asarray(kb), valid_len)
            o, vjp = jax.vjp(fn, *(jnp.asarray(x, jd) for x in (q, k, v)))
            grads = vjp(jnp.asarray(g, jd))
            out[name, dt] = [np.asarray(x.astype(jnp.float32)) for x in (*grads, o)]
    return out


def _port(name, dt):
    Tq, Tk, causal, bias, valid_len = CASES[name]
    q, k, v, g, kb = _inputs(Tq, Tk, bias)
    td = torch.float32 if dt == "fp32" else torch.bfloat16
    tq, tk, tv = (torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v))
    kb = None if kb is None else torch.from_numpy(kb)
    o = ta.train_attention(tq, tk, tv, H, causal, kb, valid_len)
    o.backward(torch.from_numpy(g).to(td))
    return tq.grad, tk.grad, tv.grad, o.detach()


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_the_tpu_kernel(jax_grads, name, dt):
    *grads, out = _port(name, dt)
    want = jax_grads[name, dt]
    for label, got, w in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == (torch.float32 if dt == "fp32" else torch.bfloat16)
        assert _agree(got, w, dt == "fp32"), (label, float(np.abs(got.float().numpy() - w).max()))
    assert _agree(out, want[3], dt == "fp32")


def _mutant(q, k, v, do, n_head, causal, key_bias, valid_len, *, delta_from_out=False,
            dv_fp32=False):
    """The plain twin with one of the two faults the fp32 check must catch."""
    B, Tq, D = q.shape
    dh = D // n_head
    scale = ta._scale(dh, q.dtype)
    qh = (ta._split(q, n_head) * scale).float()
    kh, vh, doh = (ta._split(t, n_head).float() for t in (k, v, do))
    s = qh @ kh.transpose(-1, -2)
    bias = ta.key_bias_row(k.shape[1], key_bias, valid_len, q.device)
    if bias is not None:
        s = s + bias[:, None, None, :]
    if causal:
        s = s.masked_fill(torch.ones_like(s[0, 0], dtype=torch.bool).triu(1), ta.NEG)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    pn = p / p.sum(-1, keepdim=True)
    dp = doh @ vh.transpose(-1, -2)
    if delta_from_out:
        o = ta._split(ta.train_attention_fwd_plain(q, k, v, n_head, causal, key_bias, valid_len),
                      n_head).float()
        delta = (doh * o).sum(-1, keepdim=True)
    else:
        delta = (dp * pn).sum(-1, keepdim=True)
    ds = (pn * (dp - delta)).to(torch.bfloat16).float()
    pv = pn if dv_fp32 else pn.to(torch.bfloat16).float()
    merge = lambda x: x.transpose(1, 2).reshape(B, x.shape[2], D)
    return merge(ds @ kh) * scale, merge(ds.transpose(-1, -2) @ qh), merge(pv.transpose(-1, -2) @ doh)


@pytest.mark.parametrize("fault", ["delta_from_out", "dv_fp32"])
def test_mutants_fail_the_fp32_check(jax_grads, fault):
    name = "cross 160x300"
    Tq, Tk, causal, bias, valid_len = CASES[name]
    args = [torch.from_numpy(x) for x in _inputs(Tq, Tk, bias)[:4]]
    want = jax_grads[name, "fp32"]
    got = _mutant(*args, H, causal, None, valid_len, **{fault: True})
    correct = ta.train_attention_bwd_plain(*args, H, causal, None, valid_len)
    assert all(_agree(c, w, True) for c, w in zip(correct, want))
    assert not all(_agree(m, w, True) for m, w in zip(got, want))


def test_no_grad_calls_the_forward_alone():
    q, k, v, _, _ = _inputs(64, 64, False)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        out = ta.enc_self_attention(tq, tk, tv, H)
    assert out.grad_fn is None
    assert torch.equal(out, ta.train_attention_fwd_plain(tq, tk, tv, H).detach())
    assert ta.enc_self_attention(tq, tk, tv, H).grad_fn is not None


# ---------------------------------------------------------------------------
# the CUDA kernel against its twin (run on the card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", ["encoder", "decoder self", "cross"])
def test_backward_kernel_matches_twin(cuda, shape, dt):
    """small.en's width (12 heads), at the three training shapes."""
    Tq, Tk, causal, bias, B = {"encoder": (1500, 1500, False, False, 1),
                               "decoder self": (448, 448, True, True, 4),
                               "cross": (448, 1500, False, False, 2)}[shape]
    q, k, v, g, kb = _inputs(Tq, Tk, bias, seed=3, B=B, n_head=12)
    td = torch.float32 if dt == "fp32" else torch.bfloat16
    args = [torch.from_numpy(x).to(cuda, td) for x in (q, k, v, g)]
    kb = None if kb is None else torch.from_numpy(kb).to(cuda)
    before = ta.train_attention_bwd.launches
    got = ta.train_attention_bwd(*args, 12, causal, kb)
    want = ta.train_attention_bwd_plain(*args, 12, causal, kb)
    torch.cuda.synchronize()
    assert ta.train_attention_bwd.launches == before + 1
    for a, w in zip(got, want):
        assert a.dtype == td and _agree(a.cpu(), w.float().cpu().numpy(), dt == "fp32")


# the redesigned bf16 kernels (csrc/attention_mma.cuh) at ragged shapes, at
# small.en's 12 heads: name -> (B, Tq, Tk, causal, key bias, valid_len)
RAGGED = {
    "self T=200": (2, 200, 200, False, False, None),
    "encoder valid_len=1437": (2, 1500, 1500, False, False, 1437),
    "decoder self 448 causal + pad bias": (2, 448, 448, True, True, None),
    "cross 448x1500": (2, 448, 1500, False, False, None),
}


def _cuda_args(cuda, name, seed=5):
    B, Tq, Tk, causal, bias, valid_len = RAGGED[name]
    q, k, v, g, kb = _inputs(Tq, Tk, bias, seed=seed, B=B, n_head=12)
    args = [torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (q, k, v, g)]
    return args, (causal, None if kb is None else torch.from_numpy(kb).to(cuda), valid_len)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(RAGGED))
def test_bf16_kernels_match_twins_at_ragged_shapes(cuda, name):
    (q, k, v, g), opts = _cuda_args(cuda, name)
    got = ta.train_attention_fwd(q, k, v, 12, *opts)
    want = ta.train_attention_fwd_plain(q, k, v, 12, *opts)
    torch.cuda.synchronize()
    assert _agree(got.cpu(), want.float().cpu().numpy(), False)
    got = ta.train_attention_bwd(q, k, v, g, 12, *opts)
    want = ta.train_attention_bwd_plain(q, k, v, g, 12, *opts)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and _agree(a.cpu(), w.float().cpu().numpy(), False)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["scores past 64", "a row with every key masked"])
def test_bf16_kernels_match_twins_off_the_fold(cuda, case):
    """Rows whose max passes 64 (or sits at -1e9: every key masked) take the
    forward's unfolded exp; both still match the twins."""
    q, k, v, g, _ = _inputs(200, 200, False, seed=8, B=2, n_head=12)
    kb = None
    if case == "scores past 64":
        q = q * 24  # scores of about 24 times a standard normal
    else:
        kb = torch.zeros((2, 200), device=cuda)
        kb[1] = float("-inf")
    q, k, v, g = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (q, k, v, g))
    got = ta.train_attention_fwd(q, k, v, 12, False, kb)
    want = ta.train_attention_fwd_plain(q, k, v, 12, False, kb)
    torch.cuda.synchronize()
    assert _agree(got.cpu(), want.float().cpu().numpy(), False)
    for a, w in zip(ta.train_attention_bwd(q, k, v, g, 12, False, kb),
                    ta.train_attention_bwd_plain(q, k, v, g, 12, False, kb)):
        assert _agree(a.cpu(), w.float().cpu().numpy(), False)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["encoder valid_len=1437", "decoder self 448 causal + pad bias"])
def test_backward_launches_are_bit_equal(cuda, name):
    """No atomics and every sum in a fixed order: two launches agree to the
    last bit."""
    (q, k, v, g), opts = _cuda_args(cuda, name, seed=6)
    first = ta.train_attention_bwd(q, k, v, g, 12, *opts)
    second = ta.train_attention_bwd(q, k, v, g, 12, *opts)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


PROBE_CASES = (
    [("pack", v) for v in probe_pack.VARIANTS]
    + [("pipe", v) for v in probe_pipe.VARIANTS if v != "ablate"]
    + [("ablate", ",".join(sorted(d)) or "none") for d, _ in P.ABLATE
       if not d & {"exp", "sum", "div"}]  # those compute no attention
    + [("bwd", v) for v in probe_bwd.VARIANTS])


@pytest.mark.gpu
@pytest.mark.parametrize("probe, variant", PROBE_CASES)
def test_probe_kernels_match_twins(cuda, probe, variant):
    """Every probe variant that computes attention against its plain version
    (the production twin, or for an ablation the twin with that stage
    changed), at B=2, T=200, 4 heads of 64."""
    q, k, v, do = P.inputs(4, shape=(2, 200, 256), seed=7, device=cuda)
    n = 4
    if probe == "bwd":
        got, want = probe_bwd.call(variant, q, k, v, do, n), ta.train_attention_bwd_plain(
            q, k, v, do, n)
    elif probe == "pack":
        got, want = probe_pack.call(variant, q, k, v, n), probe_pack.plain(variant, q, k, v, n)
    else:
        bias = torch.full((1, 200), -0.25, device=cuda)
        if probe == "pipe":
            (_, fn, _), = probe_pipe.cases(variant)
            drop = frozenset()
        else:
            drop = frozenset(variant.split(",")) - {"none"}
            fn = lambda q, k, v, bias, n: P.probe_ablate(q, k, v, n, drop, bias)
        got = fn(q, k, v, bias, n)
        want = P.attn_plain(q, k, v, n, ta._scale(64, q.dtype), bias, drop)
    torch.cuda.synchronize()
    for a, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        w = w.float().cpu().numpy()
        if a.dtype == torch.float32:  # the score probe: fp32 sums in another order
            assert np.abs(a.cpu().numpy() - w).max() <= 1e-4 * np.abs(w).max()
        else:
            assert _agree(a.cpu(), w, False)
