"""The port's flash route (``ops.flash``: the autograd function ``FlashMHA``,
the wrappers ``flash_mha_fwd`` / ``flash_mha_bwd`` and their plain versions)
against the JAX package's ``flash_mha``, whose kernel is JAX's stock Pallas
TPU flash attention run here in interpret mode
(``pltpu.force_tpu_interpret_mode``), on the same numpy inputs; then the
slice as a whole: ``forward_train(attention="flash")`` and a train step with
``TrainConfig(attention="flash")`` against the JAX model's flash route
(``OLMOASR_ENC_ATTN=flash``, ``OLMOASR_DEC_ATTN=xla``,
``OLMOASR_TRAIN_FLASH_DEC=1``, ``jax.default_backend`` patched to "tpu" so
that the model takes the route on the CPU). On the CPU the port runs its
plain versions; the tests marked ``gpu`` hold the CUDA kernels to them at
small.en's width. JAX is imported inside the fixtures that need it, so
that the ``gpu`` tests also run where it is not installed.

Tolerances. fp32: outputs within 2e-5, gradients within 1e-4 of their
largest magnitude; both sides compute the same fp32 arithmetic in another
order (the stock kernel takes 128-key blocks here, the port 64-key tiles),
about 5e-7 apart. bf16: two bf16 steps at the largest magnitude; the two
sides round p and ds to bf16 at the same places, but relative to running
maxima of other blocks, so single elements move by a step. Every row is
compared, the pad rows of the suffix-padded case included: a pad query
attends only the pads at or before it, and a mask with no per-query side
(``_key_only_scores``) fails there. The slice at micro dims, fp32: logits
within 5e-4, the loss within 2e-4 of itself, every gradient within 1e-4 of
its largest magnitude (about 3e-6 is seen); the train step's metrics
within 2e-5 and the parameters within 1e-3 of how far JAX moved them (the
``"kernel"`` route rounds p to bf16 and lands much further away).
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from olmoasr_tpu_torch.models import convert
from olmoasr_tpu_torch.models import whisper as tm
from olmoasr_tpu_torch.models.dims import ModelDimensions
from olmoasr_tpu_torch.ops import flash as tf
from olmoasr_tpu_torch.training import train as ttrain

H = 2
CASES = {
    # name: (Tq, Tk, causal, ids)
    "self T=40": (40, 40, False, None),
    "causal suffix pads T=40": (40, 40, True, "pads"),
    "cross 24x40": (24, 40, False, None),
    "three segments T=40": (40, 40, False, "three"),
    # four of the port's 64-key tiles, the last ragged: the online softmax
    # rescales across tiles; the padded row's text runs past the first tile,
    # and its pad queries' first tile is all text keys (all masked)
    "causal suffix pads T=200": (200, 200, True, "pads"),
}
DTYPES = ("fp32", "bf16")
OUT_TOL, GRAD_TOL = 2e-5, 1e-4  # fp32

MICRO = dict(n_mels=80, n_audio_ctx=40, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
             n_vocab=51864, n_text_ctx=24, n_text_state=128, n_text_head=2, n_text_layer=2)


def _ids(kind, B, T):
    if kind == "pads":  # the decoder's ids: text 0, then pads 1 (one row unpadded)
        lens = np.array([T, T * 2 // 3, T // 4])[:B]
        return (np.arange(T)[None] >= lens[:, None]).astype(np.int32)
    if kind == "three":  # three segments of different lengths in each row
        return np.stack([np.repeat([0, 1, 2], [13, 14, T - 27]),
                         np.repeat([5, 1, 7], [5, 20, T - 25])])[:B].astype(np.int32)
    return None


def _inputs(Tq, Tk, ids, seed=0, B=2, n_head=H):
    rng = np.random.default_rng(seed)
    D = 64 * n_head
    q, k, v, g = (rng.standard_normal((B, t, D)).astype(np.float32) for t in (Tq, Tk, Tk, Tq))
    return q, k, v, g, _ids(ids, B, Tq)


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jax, jax.numpy, interpret mode and the JAX package's
    model, flash attention and trainer."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from olmoasr_tpu.models import whisper as jm
    from olmoasr_tpu.models.dims import ModelDimensions as JaxDims
    from olmoasr_tpu.ops import flash as jflash
    from olmoasr_tpu.training import train as jtrain

    return types.SimpleNamespace(jax=jax, jnp=jnp, pltpu=pltpu, jm=jm, JaxDims=JaxDims,
                                 jflash=jflash, jtrain=jtrain)


def _agree(got, want, fp32: bool, tol: float) -> bool:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    return err <= (tol if fp32 else 2.0 ** -6 * scale)


@pytest.fixture(scope="module")
def stock(jx):
    """Output and (dq, dk, dv) of the JAX flash_mha for every case, through
    the stock kernel in interpret mode."""
    jax, jnp, out = jx.jax, jx.jnp, {}
    with jx.pltpu.force_tpu_interpret_mode():
        for name, (Tq, Tk, causal, kind) in CASES.items():
            q, k, v, g, ids = _inputs(Tq, Tk, kind)
            jids = None if ids is None else jnp.asarray(ids)
            for dt in DTYPES:
                jd = jnp.float32 if dt == "fp32" else jnp.bfloat16
                fn = lambda a, b, c: jx.jflash.flash_mha(a, b, c, H, causal=causal, q_ids=jids,
                                                         kv_ids=jids)
                o, vjp = jax.vjp(fn, *(jnp.asarray(x, jd) for x in (q, k, v)))
                grads = vjp(jnp.asarray(g, jd))
                out[name, dt] = [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]
    return out


def _port(name, dt):
    Tq, Tk, causal, kind = CASES[name]
    q, k, v, g, ids = _inputs(Tq, Tk, kind)
    td = torch.float32 if dt == "fp32" else torch.bfloat16
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    ids = None if ids is None else torch.from_numpy(ids)
    return tq, tk, tv, torch.from_numpy(g).to(td), ids, causal


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_the_stock_kernel(stock, name, dt):
    q, k, v, _, ids, causal = _port(name, dt)
    o = tf.flash_mha(q, k, v, H, causal=causal, q_ids=ids, kv_ids=ids)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert _agree(o, stock[name, dt][0], dt == "fp32", OUT_TOL)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_the_stock_kernel(stock, name, dt):
    q, k, v, g, ids, causal = _port(name, dt)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    o = tf.flash_mha(*leaves, H, causal=causal, q_ids=ids, kv_ids=ids)
    o.backward(g)
    for label, t, want in zip(("dq", "dk", "dv"), leaves, stock[name, dt][1:]):
        assert t.grad.dtype == t.dtype
        assert _agree(t.grad, want, dt == "fp32", GRAD_TOL * float(np.abs(want).max())), label


def _key_only_scores(qh, kh, scale, rows, cols, causal, q_ids, kv_ids):
    """``ops.flash._scores`` with the segment mask on the keys alone: a key
    is masked when it is a pad (id not 0), whatever the query. That is the
    per-key bias of the "kernel" route, under which a pad query attends the
    text."""
    s = (qh[:, :, rows] @ kh[:, :, cols].transpose(-1, -2)) * scale
    keep = kv_ids[:, None, None, cols] == 0
    if causal:
        keep = keep & (torch.arange(cols.start, cols.stop)[None]
                       <= torch.arange(rows.start, rows.stop)[:, None])
    return s + torch.where(keep, 0.0, tf.MASK_VALUE)


def test_key_only_mask_mutant_fails_the_pad_rows(stock, monkeypatch):
    name = "causal suffix pads T=40"
    q, k, v, _, ids, causal = _port(name, "fp32")
    want = stock[name, "fp32"][0]
    pads = ids.numpy().astype(bool)
    assert pads.any()
    good = tf.flash_mha_fwd_plain(q, k, v, H, causal, ids, ids)[0]
    monkeypatch.setattr(tf, "_scores", _key_only_scores)
    bad = tf.flash_mha_fwd_plain(q, k, v, H, causal, ids, ids)[0].numpy()
    assert _agree(good, want, True, OUT_TOL)
    assert _agree(bad[~pads], want[~pads], True, OUT_TOL)  # the text rows agree
    assert not _agree(bad[pads], want[pads], True, OUT_TOL)


def test_no_grad_runs_the_forward_alone():
    q, k, v, _, ids, causal = _port("causal suffix pads T=40", "fp32")
    leaves = [t.requires_grad_() for t in (q, k, v)]
    with torch.no_grad():
        out = tf.flash_mha(*leaves, H, causal=causal, q_ids=ids, kv_ids=ids)
    assert out.grad_fn is None
    assert torch.equal(out, tf.flash_mha_fwd_plain(q, k, v, H, causal, ids, ids)[0].detach())
    # one id tensor alone: the other is zeros
    half = tf.flash_mha(q, k, v, H, q_ids=torch.zeros_like(ids)).detach()
    assert torch.equal(half, tf.flash_mha_fwd_plain(q, k, v, H)[0].detach())


def test_unknown_attention_route_raises():
    model = tm.empty_model(ModelDimensions(**MICRO))
    with pytest.raises(ValueError, match="attention"):
        tm.forward_train(model, torch.zeros(1, 80, 80), torch.zeros(1, 4, dtype=torch.int32),
                         attention="sdpa")


# ---------------------------------------------------------------------------
# the slice at micro dims: forward_train, every gradient, a train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_flash(jx):
    """The JAX model on its flash route on the CPU (see the module
    docstring), with the stock kernel in interpret mode; undone after the
    module."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OLMOASR_ENC_ATTN", "flash")
    mp.setenv("OLMOASR_DEC_ATTN", "xla")
    mp.setenv("OLMOASR_TRAIN_FLASH_DEC", "1")
    mp.setattr(jx.jax, "default_backend", lambda: "tpu")
    with jx.pltpu.force_tpu_interpret_mode():
        yield jx
    mp.undo()


@pytest.fixture(scope="module")
def params(jx):
    return jx.jax.tree.map(np.asarray, jx.jm.init_params(
        jx.jax.random.PRNGKey(0), jx.JaxDims(**MICRO), include_padding_token=True))


def _port_model(params):
    dims = ModelDimensions(**MICRO)
    model = tm.empty_model(dims, include_padding_token=True)
    model.load_state_dict(convert.state_dict_from_jax_params(params, dims))
    return model.train()


def _batch(seed, shape=(2,)):
    """mel, text input and target with PADDING_TOKEN suffixes (one row
    unpadded), and the loader's (B, T) -inf key bias."""
    rng = np.random.default_rng(seed)
    T, n = MICRO["n_text_ctx"], int(np.prod(shape))
    mel = rng.standard_normal((n, 80, 2 * MICRO["n_audio_ctx"])).astype(np.float32)
    lens = rng.integers(T // 3, T, n)
    lens[0] = T
    tokens = rng.integers(0, 50000, (n, T + 1))
    pad = np.arange(T)[None] >= lens[:, None]
    inp = np.where(pad, tm.PADDING_TOKEN, tokens[:, :-1]).astype(np.int32)
    tgt = np.where(pad, tm.PADDING_TOKEN, tokens[:, 1:]).astype(np.int32)
    mask = np.where(pad, -np.inf, 0.0).astype(np.float32)
    out = {"mel": mel, "text_input": inp, "text_target": tgt, "padding_mask": mask}
    return {k: v.reshape(*shape, *v.shape[1:]) for k, v in out.items()}


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def test_forward_train_and_every_gradient_match_jax(jax_flash, params):
    jax, jnp, jm, jtrain = jax_flash.jax, jax_flash.jnp, jax_flash.jm, jax_flash.jtrain
    dims = jax_flash.JaxDims(**MICRO)
    b = _batch(1)
    keys = ("mel", "text_input", "text_target", "padding_mask")
    jp = jax.tree.map(jnp.asarray, params)
    jargs = [jnp.asarray(b[k]) for k in keys]
    (want_loss, want_aux), want_grads = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        jp, dims, *jargs, compute_dtype=jnp.float32, remat=False, flash=True)
    want_logits = jm.forward_train(jp, dims, jargs[0], jargs[1], jargs[3],
                                   compute_dtype=jnp.float32, flash=True)
    model = _port_model(params)
    args = [torch.from_numpy(b[k]) for k in keys]
    logits = tm.forward_train(model, args[0], args[1], args[3], compute_dtype=torch.float32,
                              remat=True, attention="flash")
    assert float(np.abs(logits.detach().numpy() - np.asarray(want_logits)).max()) <= 5e-4
    loss, aux = ttrain.loss_fn(model, *args, compute_dtype=torch.float32, remat=True,
                               attention="flash")
    loss.backward()
    assert _rel_err(loss.item(), want_loss) <= 2e-4
    assert _rel_err(aux["accuracy"].item(), want_aux["accuracy"]) <= 2e-4
    port_dims = ModelDimensions(**MICRO)
    grads = {n: p.grad for n, p in model.named_parameters()}
    got = jax.tree_util.tree_flatten_with_path(convert.jax_params_from_state_dict(grads, port_dims))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want_grads))[0])
    assert len(got) == len(want)
    for path, g in got:
        assert _rel_err(g, want[path]) <= GRAD_TOL, jax.tree_util.keystr(path)


@pytest.mark.parametrize("legacy", ["(B, T, T)", "(B, 1, T, T)"])
def test_legacy_mask_matches_jax(jax_flash, params, legacy):
    """A legacy full additive mask on the flash route: the segment ids come
    from the mask's first query row, in the JAX flash branch and in the
    port. Loss and every gradient against JAX's, and the loss against the
    port's own from the (B, T) key bias."""
    jax, jnp, jtrain = jax_flash.jax, jax_flash.jnp, jax_flash.jtrain
    b = _batch(4)
    B, T = b["padding_mask"].shape
    full = np.ascontiguousarray(np.broadcast_to(b["padding_mask"][:, None, :], (B, T, T)))
    mask = full if legacy == "(B, T, T)" else full[:, None]
    keys = ("mel", "text_input", "text_target")
    (want_loss, _), want_grads = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), jax_flash.JaxDims(**MICRO),
        *(jnp.asarray(b[k]) for k in keys), jnp.asarray(mask), compute_dtype=jnp.float32,
        remat=False, flash=True)
    model = _port_model(params)
    args = [torch.from_numpy(b[k]) for k in keys]
    loss, _ = ttrain.loss_fn(model, *args, torch.from_numpy(mask), compute_dtype=torch.float32,
                             remat=True, attention="flash")
    loss.backward()
    assert _rel_err(loss.item(), want_loss) <= 2e-4
    grads = {n: p.grad for n, p in model.named_parameters()}
    got = jax.tree_util.tree_flatten_with_path(
        convert.jax_params_from_state_dict(grads, ModelDimensions(**MICRO)))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want_grads))[0])
    assert len(got) == len(want)
    for path, g in got:
        assert _rel_err(g, want[path]) <= GRAD_TOL, jax.tree_util.keystr(path)
    with torch.no_grad():
        bias_loss, _ = ttrain.loss_fn(_port_model(params), *args,
                                      torch.from_numpy(b["padding_mask"]),
                                      compute_dtype=torch.float32, attention="flash")
    assert _rel_err(loss.item(), bias_loss.item()) <= 1e-6


def test_train_step_matches_jax(jax_flash, params):
    """Two steps of one micro-batch each: the first at learning rate 0 (the
    parameters stay), the second moves them."""
    jax, jnp, jtrain = jax_flash.jax, jax_flash.jnp, jax_flash.jtrain
    kw = dict(train_steps=10, eff_batch_size=2, micro_batch_size=2, peak_lr=1e-3)
    jcfg = jtrain.TrainConfig(**kw, remat=False, compute_dtype=jnp.float32)
    tcfg = ttrain.TrainConfig(**kw, remat=True, compute_dtype=torch.float32, attention="flash")
    opt = jtrain.make_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtrain.TrainState(jp, opt.init(jp), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jtrain.make_train_step(jax_flash.JaxDims(**MICRO), jcfg, opt, flash=True))
    model = _port_model(params)
    port_dims = ModelDimensions(**MICRO)
    state = ttrain.TrainState(model, ttrain.make_optimizer(tcfg, model.parameters()), 0)
    step = ttrain.make_train_step(port_dims, tcfg)
    for i in range(2):
        batch = _batch(10 + i, (1, 2))
        jstate, want = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, got = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "lr", "accuracy"):
            assert _rel_err(float(got[key]), float(want[key])) <= 2e-5, (i + 1, key)
        leaves = jax.tree_util.tree_flatten_with_path(
            convert.jax_params_from_state_dict(model.state_dict(), port_dims))[0]
        for (path, g), w, p0 in zip(leaves, jax.tree.leaves(jstate.params),
                                    jax.tree.leaves(params)):
            w = np.asarray(w)
            if i == 0:
                np.testing.assert_array_equal(g, p0, err_msg=jax.tree_util.keystr(path))
            else:
                assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w - p0), \
                    jax.tree_util.keystr(path)
    assert state.step == 2 and float(got["lr"]) > 0


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (run on the card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


SHAPES = {  # small.en's width (12 heads): (B, Tq, Tk, causal, ids)
    "encoder": (1, 1500, 1500, False, None),
    "decoder self": (3, 448, 448, True, "pads"),
    "cross": (2, 448, 1500, False, None),
    "causal suffix pads T=200": (2, 200, 200, True, "pads"),
}


def _card_inputs(shape, dt, device):
    B, Tq, Tk, causal, kind = SHAPES[shape]
    q, k, v, g, ids = _inputs(Tq, Tk, kind, seed=3, B=B, n_head=12)
    td = torch.float32 if dt == "fp32" else torch.bfloat16
    q, k, v, g = (torch.from_numpy(x).to(device, td) for x in (q, k, v, g))
    ids = None if ids is None else torch.from_numpy(ids).to(device)
    return q, k, v, g, ids, causal


def _card_agree(got, want, fp32: bool) -> bool:
    got, want = got.float().cpu(), want.float().cpu()
    scale = float(want.abs().max())
    return float((got - want).abs().max()) <= (1e-5 * max(scale, 1.0) if fp32 else 2.0 ** -6 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_kernel_matches_plain(cuda, shape, dt):
    q, k, v, _, ids, causal = _card_inputs(shape, dt, cuda)
    before = tf.flash_mha_fwd.launches
    got = tf.flash_mha_fwd(q, k, v, 12, causal, ids, ids)
    want = tf.flash_mha_fwd_plain(q, k, v, 12, causal, ids, ids)
    torch.cuda.synchronize()
    assert tf.flash_mha_fwd.launches == before + 1
    assert got[0].dtype == q.dtype
    assert all(_card_agree(a, w, dt == "fp32" or a.dtype == torch.float32) for a, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_backward_kernel_matches_plain(cuda, shape, dt):
    q, k, v, g, ids, causal = _card_inputs(shape, dt, cuda)
    o, m, l = tf.flash_mha_fwd_plain(q, k, v, 12, causal, ids, ids)
    args = (q, k, v, o, m, l, g, 12, causal, ids, ids)
    before = tf.flash_mha_bwd.launches
    got = tf.flash_mha_bwd(*args)
    want = tf.flash_mha_bwd_plain(*args)
    torch.cuda.synchronize()
    assert tf.flash_mha_bwd.launches == before + 1
    for a, w in zip(got, want):
        assert a.dtype == q.dtype and _card_agree(a, w, dt == "fp32")
