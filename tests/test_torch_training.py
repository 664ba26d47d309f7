"""The port's training slice (``olmoasr_tpu_torch.training``) against the JAX
package's, at micro dims on the CPU: ``loss_fn`` and every parameter's
gradient against ``jax.value_and_grad(loss_fn)``, three accumulated train
steps against ``make_train_step`` + ``make_optimizer``, the loader's batches
bit-equal to the JAX loader's, and ``train_loop.main`` with resume and the
``.npz`` interchange. The ``device_mel`` transport: the loader's PCM batches
bit-equal to the JAX loader's (int16 and f32 sources), ``loss_fn`` and every
gradient from int16 PCM against JAX's ``loss_fn`` from the same PCM (its
conv-DFT log-mel against the port's ``torch.stft``, the log-mels 2.5e-6
apart at most), and ``train_loop.main(device_mel=True)``. The cast-moment
Adam (``mu_dtype`` / ``nu_dtype``) over three clipped updates against the
JAX ``make_optimizer`` chain, and ``train_loop.main``'s in-loop evaluation
(sync with its best-WER gate and a failing eval, a real sync eval, async
through the port's harness in its own process), its profiler trace and its
bf16 moments through a checkpoint.

The JAX side runs its Pallas attention kernels in interpret mode: the
decoder through ``OLMOASR_DEC_ATTN=kernel_interpret``, the encoder by
monkeypatching its ``sdpa`` (which on the CPU stands in for the kernel and
does not round P to bf16) to ``enc_self_attention(..., interpret=True)``.
fp32 compute on both sides. The port runs with remat, JAX without: remat
must not change the numbers.

Tolerances. Loss, accuracy, grad norm and lr: 2e-4 x |ref|. Gradients: the
attention kernels round P and ds to bf16 even at fp32 compute, and where two
fp32 values differ in the last bit that rounding flips by one bf16 step; the
flips spread through the layers. That floor, the port's own gradients'
change under a 1e-7 relative change of the mel, is 1.3e-3 of a leaf's max at
these dims, so 2e-4 is out of reach for any two implementations: every leaf
is held to GRAD_TOL = 4e-3 x max|ref| (the largest error against JAX is
2.9e-3, in the cross-attention's q projection), and the floor is measured and
must stay below half of it. Parameters after each step, per leaf: the
L2 norm of the difference within 1% of the L2 norm of JAX's move since the
start (Adam's normalised update turns those flips into sign changes in a few
elements whose moment is near 0, so a bound per element would only say that
no element moved further than a flip; up to 0.36% is seen). The first step
moves nothing, and is held to equality.
"""

from __future__ import annotations

import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from olmoasr_tpu.models import whisper as jm
from olmoasr_tpu.models.dims import ModelDimensions as JaxDims
from olmoasr_tpu.training import train as jtrain
from olmoasr_tpu_torch.models import convert
from olmoasr_tpu_torch.models import whisper as tm
from olmoasr_tpu_torch.models.dims import ModelDimensions
from olmoasr_tpu_torch.training import train as ttrain

MICRO = dict(n_mels=80, n_audio_ctx=40, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
             n_vocab=51864, n_text_ctx=24, n_text_state=128, n_text_head=2, n_text_layer=2)
TOL, GRAD_TOL = 2e-4, 4e-3
_JAX_SDPA = jm.sdpa  # the JAX model's plain attention, before ``jax_kernels`` patches it
CAST_TOL = 1e-3  # CastMomentAdamW's parameters against JAX's, x the peak learning rate
ACCUM, MICRO_B, STEPS = 2, 2, 3


@pytest.fixture(scope="module")
def jax_kernels():
    """The JAX model with its attention on the Pallas kernels in interpret
    mode (see the module docstring); undone after the module."""
    from olmoasr_tpu.ops.train_attention import enc_self_attention

    mp = pytest.MonkeyPatch()
    mp.setenv("OLMOASR_DEC_ATTN", "kernel_interpret")
    mp.setattr(jm, "sdpa", lambda q, k, v, n_head, mask=None, key_bias=None:
               enc_self_attention(q, k, v, n_head, interpret=True))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), JaxDims(**MICRO),
                                                   include_padding_token=True))


def _port_model(params):
    dims = ModelDimensions(**MICRO)
    model = tm.empty_model(dims, include_padding_token=True)
    model.load_state_dict(convert.state_dict_from_jax_params(params, dims))
    return model.train()


def _batch(seed, shape=(MICRO_B,)):
    """mel, text input and target with PADDING_TOKEN suffixes of different
    lengths, and the loader's (B, T) -inf key bias."""
    rng = np.random.default_rng(seed)
    T = MICRO["n_text_ctx"]
    n = int(np.prod(shape))
    mel = rng.standard_normal((n, 80, 2 * MICRO["n_audio_ctx"])).astype(np.float32)
    lens = rng.integers(T // 3, T + 1, n)
    lens[0] = T
    tokens = rng.integers(0, 50000, (n, T + 1))
    pad = np.arange(T)[None] >= lens[:, None]
    inp = np.where(pad, jm.PADDING_TOKEN, tokens[:, :-1]).astype(np.int32)
    tgt = np.where(pad, jm.PADDING_TOKEN, tokens[:, 1:]).astype(np.int32)
    mask = np.where(pad, -np.inf, 0.0).astype(np.float32)
    out = {"mel": mel, "text_input": inp, "text_target": tgt, "padding_mask": mask}
    return {k: v.reshape(*shape, *v.shape[1:]) for k, v in out.items()}


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _close(got, want, what, tol=TOL):
    assert _rel_err(got, want) <= tol, (what, _rel_err(got, want))


def _port_grads(params, b, mel_scale=1.0):
    model = _port_model(params)
    args = [torch.from_numpy(b[k]) for k in ("mel", "text_input", "text_target", "padding_mask")]
    args[0] = args[0] * mel_scale
    loss, aux = ttrain.loss_fn(model, *args, compute_dtype=torch.float32, remat=True)
    loss.backward()
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    return loss, aux, grads


def _flip_floor(params, b) -> float:
    """The port's largest gradient change, per leaf against its largest
    magnitude, under a 1e-7 relative change of the mel: the bf16 flips of
    the attention's P and ds. Measured with one intra-op thread: the CPU's
    reductions split their sums by the thread count, which moves the floor
    (1.3167e-3 at 1-7 threads, 1.3202e-3 at 8), so that every process on
    every machine measures the same sums."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        base = _port_grads(params, b)[2]
        nudged = _port_grads(params, b, 1 + 1e-7)[2]
    finally:
        torch.set_num_threads(threads)
    return max(_rel_err(g, base[k]) for k, g in nudged.items())


def test_loss_and_every_gradient_match_jax(jax_kernels, params):
    dims = JaxDims(**MICRO)
    b = _batch(1)
    (jloss, jaux), jgrads = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), dims, *(jnp.asarray(b[k]) for k in
                                                   ("mel", "text_input", "text_target",
                                                    "padding_mask")),
        compute_dtype=jnp.float32, remat=False)
    loss, aux, grads = _port_grads(params, b)
    _close(loss.item(), jloss, "loss")
    _close(aux["accuracy"].item(), jaux["accuracy"], "accuracy")
    assert int(aux["n_tokens"]) == int(jaux["n_tokens"])
    floor = _flip_floor(params, b)
    assert floor <= GRAD_TOL / 2  # the bf16 flips, measured on the port itself
    port_dims = ModelDimensions(**MICRO)
    got = jax.tree_util.tree_flatten_with_path(convert.jax_params_from_state_dict(grads, port_dims))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jgrads))[0])
    assert len(got) == len(want)
    for path, g in got:
        _close(g, want[path], jax.tree_util.keystr(path), GRAD_TOL)
    # the padding row gets a gradient through the tied logits, as in JAX
    assert float(grads["decoder.token_embedding.weight"][jm.PADDING_TOKEN].abs().max()) > 0


@pytest.mark.parametrize("legacy", ["(B, T, T)", "(B, 1, T, T)"])
def test_legacy_mask_loss_and_every_gradient_match_jax(jax_kernels, params, monkeypatch, legacy):
    """A legacy full additive mask (the reference's per-sample (T, T) pad
    masks, here built from the loader's key bias): the JAX package sends the
    decoder through its XLA attention, self-attention under ``mask +
    causal`` and cross-attention unmasked, and so does the port's kernel
    route (``sdpa``, outside the kernels); the encoder stays on the kernels.
    Loss and every gradient against JAX's, and the loss against the port's
    own from the (B, T) key bias."""
    dims = JaxDims(**MICRO)
    b = _batch(3)
    B, T = b["padding_mask"].shape
    full = np.ascontiguousarray(np.broadcast_to(b["padding_mask"][:, None, :], (B, T, T)))
    mask = full if legacy == "(B, T, T)" else full[:, None]
    # JAX's decoder attention with a full mask is its plain sdpa; the
    # encoder's (no mask, as many queries as keys) stays the interpret kernel
    enc = jm.sdpa
    monkeypatch.setattr(jm, "sdpa", lambda q, k, v, n_head, mask=None, key_bias=None: (
        enc(q, k, v, n_head) if mask is None and key_bias is None and q.shape[1] == k.shape[1]
        else _JAX_SDPA(q, k, v, n_head, mask, key_bias)))
    keys = ("mel", "text_input", "text_target")
    (jloss, jaux), jgrads = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), dims, *(jnp.asarray(b[k]) for k in keys),
        jnp.asarray(mask), compute_dtype=jnp.float32, remat=False)
    model = _port_model(params)
    args = [torch.from_numpy(b[k]) for k in keys]
    loss, aux = ttrain.loss_fn(model, *args, torch.from_numpy(mask), compute_dtype=torch.float32,
                               remat=True)
    loss.backward()
    _close(loss.item(), jloss, "loss")
    _close(aux["accuracy"].item(), jaux["accuracy"], "accuracy")
    grads = {name: p.grad for name, p in model.named_parameters()}
    got = jax.tree_util.tree_flatten_with_path(
        convert.jax_params_from_state_dict(grads, ModelDimensions(**MICRO)))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jgrads))[0])
    assert len(got) == len(want)
    for path, g in got:
        _close(g, want[path], jax.tree_util.keystr(path), GRAD_TOL)
    with torch.no_grad():
        bias_loss, _ = ttrain.loss_fn(_port_model(params), *args,
                                      torch.from_numpy(b["padding_mask"]),
                                      compute_dtype=torch.float32, remat=False)
    _close(loss.item(), bias_loss.item(), "the loss from the (B, T) key bias")


def test_loss_and_every_gradient_from_pcm_match_jax(jax_kernels, params):
    """``loss_fn`` on a (B, samples) int16 batch, the device_mel transport at
    MICRO's 2 x 40 mel frames (JAX ``tests/test_training.py``'s shapes),
    against JAX's, and against the port's own ``loss_fn`` from the host mel."""
    from olmoasr_tpu_torch.audio import HOP_LENGTH, log_mel_spectrogram_np

    dims = JaxDims(**MICRO)
    b = _batch(2)
    rng = np.random.default_rng(5)
    pcm = (rng.standard_normal((MICRO_B, 2 * MICRO["n_audio_ctx"] * HOP_LENGTH)) * 3000
           ).astype(np.int16)
    args = [b[k] for k in ("text_input", "text_target", "padding_mask")]
    (jloss, jaux), jgrads = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), dims, jnp.asarray(pcm), *map(jnp.asarray, args),
        compute_dtype=jnp.float32, remat=False)
    model = _port_model(params)
    loss, aux = ttrain.loss_fn(model, torch.from_numpy(pcm), *map(torch.from_numpy, args),
                               compute_dtype=torch.float32, remat=True)
    loss.backward()
    _close(loss.item(), jloss, "loss")
    _close(aux["accuracy"].item(), jaux["accuracy"], "accuracy")
    grads = {name: p.grad for name, p in model.named_parameters()}
    got = jax.tree_util.tree_flatten_with_path(
        convert.jax_params_from_state_dict(grads, ModelDimensions(**MICRO)))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jgrads))[0])
    for path, g in got:
        _close(g, want[path], jax.tree_util.keystr(path), GRAD_TOL)
    host = torch.from_numpy(log_mel_spectrogram_np(pcm.astype(np.float32) / 32768.0))
    host_loss, _ = ttrain.loss_fn(_port_model(params), host, *map(torch.from_numpy, args),
                                  compute_dtype=torch.float32, remat=True)
    _close(loss.item(), host_loss.item(), "loss from the host mel")


def test_three_accumulated_steps_match_jax(jax_kernels, params):
    jcfg = jtrain.TrainConfig(train_steps=10, eff_batch_size=ACCUM * MICRO_B,
                              micro_batch_size=MICRO_B, peak_lr=1e-3, remat=False,
                              compute_dtype=jnp.float32)
    tcfg = ttrain.TrainConfig(train_steps=10, eff_batch_size=ACCUM * MICRO_B,
                              micro_batch_size=MICRO_B, peak_lr=1e-3, remat=True,
                              compute_dtype=torch.float32)
    dims = JaxDims(**MICRO)
    opt = jtrain.make_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtrain.TrainState(jp, opt.init(jp), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jtrain.make_train_step(dims, jcfg, opt))
    model = _port_model(params)
    state = ttrain.TrainState(model, ttrain.make_optimizer(tcfg, model.parameters()), 0)
    step = ttrain.make_train_step(ModelDimensions(**MICRO), tcfg)
    port_dims = ModelDimensions(**MICRO)
    for i in range(STEPS):
        batch = _batch(10 + i, (ACCUM, MICRO_B))
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "lr", "accuracy"):
            _close(float(m[key]), float(jm_[key]), f"step {i + 1} {key}")
        got = convert.jax_params_from_state_dict(model.state_dict(), port_dims)
        for (path, g), w, p0 in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                    jax.tree.leaves(jstate.params), jax.tree.leaves(params)):
            w = np.asarray(w)
            # the parameters' difference against how far JAX moved them
            diff, moved = np.linalg.norm(g - w), np.linalg.norm(w - p0)
            assert diff <= 1e-2 * moved, (i + 1, jax.tree_util.keystr(path), diff, moved)
        if i == 0:  # lr_schedule(0) = 0: the first update leaves every parameter as it was
            assert float(m["lr"]) == 0.0
            for (path, g), p0 in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                     jax.tree.leaves(params)):
                np.testing.assert_array_equal(g, p0, err_msg=jax.tree_util.keystr(path))
    assert state.step == STEPS and float(m["lr"]) > 0


@pytest.mark.parametrize("moments", ["mu and nu bf16", "mu bf16"])
def test_cast_moment_adam_matches_jax(moments):
    """Three clipped updates of ``CastMomentAdamW`` against the JAX
    ``make_optimizer`` chain on the same parameters and gradients: its
    ``_scale_by_adam_cast`` with both moments in bf16, and
    ``optax.adamw(mu_dtype=bf16)`` with mu alone. Moments stored in bf16
    and JAX's within 2^-9 of their largest; parameters within CAST_TOL x the
    peak learning rate (1.2e-4 x is seen; reading mu before its bf16 cast
    where JAX reads it after, or the other way round, gives 6e-3 to 1.6e-2
    x)."""
    import optax

    nu = jnp.bfloat16 if moments == "mu and nu bf16" else None
    jcfg = jtrain.TrainConfig(train_steps=10, peak_lr=1e-3, mu_dtype=jnp.bfloat16, nu_dtype=nu)
    tcfg = ttrain.TrainConfig(train_steps=10, peak_lr=1e-3, mu_dtype=torch.bfloat16,
                              nu_dtype=torch.bfloat16 if nu else None)
    rng = np.random.default_rng(0)
    shapes = {"w": (60, 50), "b": (50,), "e": (70, 30)}
    p0 = {k: rng.standard_normal(v).astype(np.float32) for k, v in shapes.items()}
    opt = jtrain.make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = opt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = ttrain.make_optimizer(tcfg, tp.values())
    assert isinstance(topt, ttrain.CastMomentAdamW) and topt.cast_update == (nu is not None)
    schedule = ttrain.lr_schedule(tcfg)
    for step, scale in enumerate((3.0, 0.1, 1.0)):  # clipped, not, not
        grads = {k: (rng.standard_normal(v) * scale / 4).astype(np.float32)
                 for k, v in shapes.items()}
        updates, jstate = opt.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k].copy())
        ttrain.clip_by_global_norm([p.grad for p in tp.values()], tcfg.max_grad_norm)
        topt.param_groups[0]["lr"] = schedule(step)
        topt.step()
        adam = jstate[1] if nu is not None else jstate[1][0]
        for k, p in tp.items():
            st = topt.state[p]
            assert st["exp_avg"].dtype == torch.bfloat16
            assert st["exp_avg_sq"].dtype == (torch.bfloat16 if nu else torch.float32)
            for mine, theirs in ((st["exp_avg"], adam.mu[k]), (st["exp_avg_sq"], adam.nu[k])):
                want = np.asarray(theirs, np.float32)
                assert np.abs(mine.float().numpy() - want).max() <= 2 ** -9 * np.abs(want).max()
            diff = np.abs(p.detach().numpy() - np.asarray(jp[k])).max()
            assert diff <= CAST_TOL * tcfg.peak_lr, (step, k, diff)
    assert schedule(2) > 0 and not np.array_equal(np.asarray(jp["w"]), p0["w"])


# ---------------------------------------------------------------------------
# the loader and the entry point
# ---------------------------------------------------------------------------

WORDS = ("hello", "world", "training", "smoke", "test", "audio", "words", "again")


def _vtt(rng) -> str:
    cues, t = [], 0.0
    for _ in range(int(rng.integers(1, 5))):
        start, t = t, t + float(rng.uniform(0.5, 2.0))
        text = " ".join(rng.choice(WORDS, int(rng.integers(1, 6))))
        cues.append(f"{_ts(start)} --> {_ts(t)}\n{text}\n")
    return "WEBVTT\n\n" + "\n".join(cues)


def _ts(s: float) -> str:
    ms = int(round(s * 1000))
    return f"{ms // 3600000:02d}:{ms // 60000 % 60:02d}:{ms // 1000 % 60:02d}.{ms % 1000:03d}"


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    """8 samples of seeded int16 noise with VTT transcripts of 1-4 cues."""
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(8):
        path = d / f"a{i}.npy"
        np.save(path, (rng.standard_normal(int(16000 * rng.uniform(2, 6))) * 2000).astype(np.int16))
        rows.append({"audio_file": str(path), "transcript": _vtt(rng), "ext": "vtt"})
    with gzip.open(d / "shard0.jsonl.gz", "wt") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return d


@pytest.mark.parametrize("transport", ["mel", "int16 pcm", "f32 pcm"])
def test_loader_batches_are_bit_equal_to_jax(shard_dir, transport):
    """The host-mel batches, and the device_mel transport's PCM batches from
    the shards' int16 .npy files and from in-memory f32 waveforms."""
    from olmoasr_tpu.training import dataset as jds
    from olmoasr_tpu_torch.training import dataset as tds

    shards = [str(shard_dir / "shard0.jsonl.gz")]

    def samples(mod):
        rows = mod.load_jsonl_samples(shards)
        if transport == "f32 pcm":
            return [{"audio": np.load(r.audio).astype(np.float32) / 32768.0,
                     "transcript": r.transcript, "transcript_ext": r.transcript_ext}
                    for r in rows]
        return rows

    device_mel = transport != "mel"
    loaders = [mod.BatchLoader(mod.AudioTextDataset(samples(mod), 448, seed=3,
                                                    device_mel=device_mel),
                               micro_batch_size=2, accum_steps=2, seed=3)
               for mod in (jds, tds)]
    for epoch in (0, 1):
        for loader in loaders:
            loader.set_epoch(epoch)
        got, want = list(loaders[1]), list(loaders[0])
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), (epoch, k)
    lens = (want[0]["padding_mask"] == 0).sum(-1)
    assert len(set(lens.ravel().tolist())) > 1  # the pad bias differs between rows
    mel = got[0]["mel"]
    if device_mel:
        assert mel.shape == (2, 2, 480000)
        assert mel.dtype == (np.int16 if transport == "int16 pcm" else np.float32)
    else:
        assert mel.shape == (2, 2, 80, 3000) and mel.dtype == np.float32


ENTRY = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=1, n_audio_layer=1,
             n_vocab=51864, n_text_ctx=448, n_text_state=64, n_text_head=1, n_text_layer=1)


def test_train_loop_resumes_and_writes_an_npz_both_packages_read(shard_dir, tmp_path,
                                                                 monkeypatch):
    from olmoasr_tpu.models.convert import load_npz_checkpoint
    from olmoasr_tpu_torch import load_model
    from olmoasr_tpu_torch.training import checkpoint, train_loop

    monkeypatch.chdir(tmp_path)
    dims = ModelDimensions(**ENTRY)
    kwargs = dict(variant=dims, train_shards=str(shard_dir / "*.jsonl.gz"), exp_name="micro",
                  train_steps=10, eff_batch_size=4, micro_batch_size=2, ckpt_dir="ckpt",
                  ckpt_every=2, log_every=1, max_steps_this_run=2, device="cpu")
    metrics = train_loop.main(**kwargs)
    assert metrics["global_step"] == 2 and np.isfinite(metrics["train/loss"])
    assert metrics["train/lr"] > 0 and "efficiency/audio_min_per_chip_second" in metrics
    assert os.path.isfile("logs/micro_metrics.jsonl")
    mgr = checkpoint.CheckpointManager("ckpt/micro")
    assert mgr.latest_step() == 2
    cfg = ttrain.TrainConfig(train_steps=10)
    fresh = ttrain.init_train_state(42, dims, cfg, device="cpu")
    init = {k: v.clone() for k, v in fresh.model.state_dict().items()}
    state, meta = mgr.restore(fresh)
    assert state.step == 2 and meta["global_step"] == 2 and meta["dims"] == ENTRY
    assert len(state.optimizer.state) == len(list(state.model.parameters()))
    moved = [k for k, v in state.model.state_dict().items() if not torch.equal(v, init[k])]
    assert "decoder.token_embedding.weight" in moved

    metrics = train_loop.main(**{**kwargs, "max_steps_this_run": 1})
    assert metrics["global_step"] == 3 and mgr.latest_step() == 3
    assert sorted(os.listdir("ckpt/micro")) == ["step_3"]

    path = str(tmp_path / "eval.npz")
    checkpoint.save_eval_checkpoint(path, state, dims)
    jparams, jdims = load_npz_checkpoint(path)
    assert jdims.to_dict() == ENTRY
    assert jparams["decoder"]["token_embedding"].shape[0] == jm.PADDING_TOKEN
    model = load_model(path, device="cpu")
    sd = state.model.state_dict()
    for k, v in model.state_dict().items():
        want = sd[k][:jm.PADDING_TOKEN] if k == "decoder.token_embedding.weight" else sd[k]
        assert torch.equal(v, want), k
    np.testing.assert_array_equal(np.asarray(jparams["decoder"]["blocks"]["mlp_w1"][0]),
                                  sd["decoder.blocks.0.mlp.0.weight"].numpy().T)


def test_train_loop_with_device_mel(shard_dir, tmp_path, monkeypatch):
    """Two steps from PCM batches: the loss the first step logs is the one
    the host-mel run logs on the same batch, to the log-mels' difference."""
    from olmoasr_tpu_torch.training import train_loop

    monkeypatch.chdir(tmp_path)
    losses = {}
    make_step = ttrain.make_train_step

    def recording(dims, config, mesh=None):
        step = make_step(dims, config, mesh)

        def run(state, batch):
            state, metrics = step(state, batch)
            losses.setdefault(batch["mel"].dim(), []).append(float(metrics["loss"]))
            return state, metrics

        return run

    monkeypatch.setattr(ttrain, "make_train_step", recording)
    kwargs = dict(variant=ModelDimensions(**ENTRY), train_shards=str(shard_dir / "*.jsonl.gz"),
                  train_steps=10, eff_batch_size=4, micro_batch_size=2, ckpt_dir="ckpt",
                  ckpt_every=0, log_every=1, device="cpu")
    metrics = train_loop.main(**kwargs, exp_name="pcm", device_mel=True, max_steps_this_run=2)
    assert metrics["global_step"] == 2 and np.isfinite(metrics["train/loss"])
    train_loop.main(**kwargs, exp_name="host", max_steps_this_run=1)
    pcm_losses, host_losses = losses[3], losses[4]  # (accum, B, samples) / (accum, B, mels, T)
    assert len(pcm_losses) == 2 and len(host_losses) == 1
    _close(pcm_losses[0], host_losses[0], "step 1 loss, PCM against the host mel")
    args = train_loop.build_cli_parser().parse_args(["--device_mel", "true"])
    assert args.device_mel is True


def test_unported_options_raise():
    """No option raises any more: an fsdp_size that does not divide the world
    (2 on one process) and an unknown fsdp_strategy are refused before any
    work; the cast-moment Adam is there."""
    from olmoasr_tpu_torch.training import train_loop

    with pytest.raises(ValueError, match="does not divide the world size 1"):
        train_loop.main(device="cpu", fsdp_size=2)
    with pytest.raises(ValueError, match="fsdp_strategy"):
        train_loop.main(device="cpu", fsdp_strategy="hybrid")
    opt = ttrain.make_optimizer(ttrain.TrainConfig(mu_dtype=torch.bfloat16),
                                [torch.zeros(2, requires_grad=True)])
    assert isinstance(opt, ttrain.CastMomentAdamW) and not opt.cast_update
    args = train_loop.build_cli_parser().parse_args(["--max_steps_this_run", "3",
                                                     "--remat", "false"])
    assert args.max_steps_this_run == 3 and args.remat is False and args.device == "cuda"
    args = train_loop.build_cli_parser().parse_args([
        "--eval_every", "2", "--eval_mode", "sync", "--eval_max_samples", "7",
        "--profile_dir", "p", "--mu_dtype", "bfloat16"])
    assert (args.eval_every, args.eval_mode, args.eval_max_samples) == (2, "sync", 7)
    assert args.profile_dir == "p" and args.mu_dtype == "bfloat16"
    assert not hasattr(args, "profile_steps")  # a tuple: left at its default, as in JAX
    assert args.nu_dtype is None and args.eval_set == "librispeech_clean"
    args = train_loop.build_cli_parser().parse_args(["--fsdp_size", "2", "--fsdp_strategy",
                                                     "grad_op"])
    assert (args.fsdp_size, args.fsdp_strategy) == (2, "grad_op")


def _eval_tree(root, n=2):
    import scipy.io.wavfile as wavfile

    chap = root / "LibriSpeech" / "test-clean" / "7" / "8"
    chap.mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        wavfile.write(str(chap / f"7-8-{i:04d}.wav"), 16000,
                      (rng.standard_normal(16000 * 3) * 1000).astype(np.int16))
        lines.append(f"7-8-{i:04d} HELLO WORLD {i}")
    (chap / "7-8.trans.txt").write_text("\n".join(lines))
    return str(root)


def _loop_kwargs(shard_dir, **kw):
    return dict(variant=ModelDimensions(**ENTRY), train_shards=str(shard_dir / "*.jsonl.gz"),
                train_steps=10, eff_batch_size=2, micro_batch_size=2, ckpt_dir="ckpt",
                ckpt_every=0, log_every=1, device="cpu", **kw)


def test_train_loop_sync_eval_best_gating(shard_dir, tmp_path, monkeypatch):
    """eval_mode="sync", as the JAX test_sync_eval_best_gating: the WER
    logged, best.npz written on an improvement only, and a failing eval
    reported without stopping the run."""
    from olmoasr_tpu_torch import load_model
    from olmoasr_tpu_torch.training import train_loop

    monkeypatch.chdir(tmp_path)
    wers = iter([0.5, RuntimeError("no eval data"), 0.7, 0.3])
    saved = []
    save = train_loop.ckpt_mod.save_eval_checkpoint

    def fake_eval(state, dims, eval_set, eval_dir, **kw):
        v = next(wers)
        if isinstance(v, Exception):
            raise v
        return v

    monkeypatch.setattr(train_loop, "run_sync_eval", fake_eval)
    monkeypatch.setattr(train_loop.ckpt_mod, "save_eval_checkpoint",
                        lambda path, state, dims: saved.append(state.step)
                        or save(path, state, dims))
    metrics = train_loop.main(**_loop_kwargs(shard_dir), exp_name="sync", eval_every=1,
                              eval_mode="sync", max_steps_this_run=4)
    assert metrics["eval/wer"] == 0.3 and saved == [1, 4]
    assert load_model("ckpt/sync/best.npz", device="cpu").dims.to_dict() == ENTRY
    with open("logs/sync_metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [r["alert_text"] for r in lines if "alert" in r] == ["no eval data"]
    assert [r["eval/wer"] for r in lines if "eval/wer" in r] == [0.5, 0.7, 0.3]
    with open("ckpt/sync/step_4/meta.json") as f:
        assert json.load(f)["best_eval_wer"] == 0.3


def test_train_loop_sync_eval_profile_and_cast_moments(shard_dir, tmp_path, monkeypatch):
    """A real sync eval (short_form_eval of the training weights over two
    utterances) whose WER and per-sample hypotheses equal short_form_eval of
    the best.npz it wrote, the profiler over steps 1-2 of 2 (the trace
    written when the run ends inside them), bf16 moments kept through the
    checkpoint. Just before the eval the trained embedding's text rows past
    the 256 byte tokens are zeroed (the offline tokenizer decodes nothing
    else), so that the hypotheses have text and a wrong weight transfer
    shows."""
    from olmoasr_tpu_torch import load_model
    from olmoasr_tpu_torch.eval import harness
    from olmoasr_tpu_torch.training import checkpoint, train_loop

    monkeypatch.chdir(tmp_path)
    eval_dir = _eval_tree(tmp_path / "eval")
    evals, sync_eval, short_form = [], train_loop.run_sync_eval, harness.short_form_eval

    def byte_sync_eval(state, *a, **kw):
        with torch.no_grad():
            state.model.decoder.token_embedding.weight[256:50256].zero_()
        state.model.drop_derived()
        return sync_eval(state, *a, **kw)

    monkeypatch.setattr(train_loop, "run_sync_eval", byte_sync_eval)
    monkeypatch.setattr(harness, "short_form_eval",
                        lambda *a, **kw: evals.append(short_form(*a, **kw)) or evals[-1])
    metrics = train_loop.main(**_loop_kwargs(shard_dir), exp_name="real", eval_every=2,
                              eval_mode="sync", eval_dir=eval_dir, max_steps_this_run=2,
                              profile_dir="prof", profile_steps=(1, 5), mu_dtype="bfloat16",
                              nu_dtype="bfloat16")
    assert metrics["global_step"] == 2 and os.path.isfile("ckpt/real/best.npz")
    (got,) = evals
    want = short_form(load_model("ckpt/real/best.npz", device="cpu"), "librispeech_clean",
                      eval_dir)
    assert metrics["eval/wer"] == got.wer == want.wer and want.n_samples == 2
    assert got.per_sample == want.per_sample and all(r["hyp"] for r in want.per_sample)
    (trace,) = os.listdir("prof")
    with open(os.path.join("prof", trace)) as f:
        assert "aten::" in f.read()
    dims = ModelDimensions(**ENTRY)
    cfg = ttrain.TrainConfig(train_steps=10, mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16)
    state, _ = checkpoint.CheckpointManager("ckpt/real").restore(
        ttrain.init_train_state(42, dims, cfg, device="cpu"))
    moments = [t.dtype for st in state.optimizer.state.values()
               for t in (st["exp_avg"], st["exp_avg_sq"])]
    assert moments and set(moments) == {torch.bfloat16}


def test_train_loop_async_eval(shard_dir, tmp_path, monkeypatch):
    """eval_mode="async": eval_<step>.npz written and the port's harness
    spawned on it with the trainer's device; its results files appear."""
    from olmoasr_tpu_torch.training import train_loop

    monkeypatch.chdir(tmp_path)
    eval_dir = _eval_tree(tmp_path / "eval")
    procs = []
    spawn = train_loop.run_async_eval
    monkeypatch.setattr(train_loop, "run_async_eval",
                        lambda *a: procs.append(spawn(*a)) or procs[-1])
    train_loop.main(**_loop_kwargs(shard_dir), exp_name="async", eval_every=1,
                    eval_dir=eval_dir, max_steps_this_run=1)
    (proc,) = procs
    assert proc.wait(timeout=300) == 0
    assert proc.args[proc.args.index("--device") + 1] == "cpu"
    assert "olmoasr_tpu_torch.eval.harness" in proc.args
    assert sorted(os.listdir("eval_results/async")) == [
        "librispeech_clean_eval_1.npz.json", "librispeech_clean_eval_1.npz.txt",
        "librispeech_clean_eval_1.npz_per_sample.csv"]
