"""The port's training slice (``olmoasr_tpu_torch.training``) against the JAX
package's, at micro dims on the CPU: ``loss_fn`` and every parameter's
gradient against ``jax.value_and_grad(loss_fn)``, three accumulated train
steps against ``make_train_step`` + ``make_optimizer``, the loader's batches
bit-equal to the JAX loader's, and ``train_loop.main`` with resume and the
``.npz`` interchange. The ``device_mel`` transport: the loader's PCM batches
bit-equal to the JAX loader's (int16 and f32 sources), ``loss_fn`` and every
gradient from int16 PCM against JAX's ``loss_fn`` from the same PCM (its
conv-DFT log-mel against the port's ``torch.stft``, the log-mels 2.5e-6
apart at most), and ``train_loop.main(device_mel=True)``.

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
    floor = max(_rel_err(g, grads[k]) for k, g in _port_grads(params, b, 1 + 1e-7)[2].items())
    assert floor <= GRAD_TOL / 2  # the bf16 flips, measured on the port itself
    port_dims = ModelDimensions(**MICRO)
    got = jax.tree_util.tree_flatten_with_path(convert.jax_params_from_state_dict(grads, port_dims))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jgrads))[0])
    assert len(got) == len(want)
    for path, g in got:
        _close(g, want[path], jax.tree_util.keystr(path), GRAD_TOL)
    # the padding row gets a gradient through the tied logits, as in JAX
    assert float(grads["decoder.token_embedding.weight"][jm.PADDING_TOKEN].abs().max()) > 0


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

    def recording(dims, config):
        step = make_step(dims, config)

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
    from olmoasr_tpu_torch.training import train_loop

    for kw in ({"fsdp_size": 2}, {"eval_every": 1}, {"profile_dir": "p"}):
        with pytest.raises(NotImplementedError):
            train_loop.main(device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        ttrain.make_optimizer(ttrain.TrainConfig(mu_dtype=torch.bfloat16), [])
    args = train_loop.build_cli_parser().parse_args(["--max_steps_this_run", "3",
                                                     "--remat", "false"])
    assert args.max_steps_this_run == 3 and args.remat is False and args.device == "cuda"
