"""The plain reference against the port at micro widths in fp32 on the CPU,
its frozen token tables against the port's, and its independence: it
imports nothing of the port or of JAX."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpubench import core, weights
from gpubench.drivers import train as train_driver
from gpubench.reference import whisper_ref as ref
from gpubench_micro import MICRO

TOKENS = json.load(open(os.path.join(core.HERE, "reference", "tokens.json")))


def close(ours, theirs, rel):
    """Agreement by the norm of the difference: the port's fp32 CPU path
    (its kernels' plain twins) sits 1e-4 to 5e-4 from float64, the reference
    about 3e-7, so elements near zero differ by more than their size."""
    ours, theirs = ours.detach().double(), theirs.detach().double()
    err = float((ours - theirs).norm() / theirs.norm())
    assert err < rel, err


@pytest.fixture(scope="module")
def model_and_sd():
    from olmoasr_tpu_torch.api import OLMoASR
    from olmoasr_tpu_torch.models.dims import ModelDimensions

    sd = weights.make_state_dict(MICRO, 2 ** 40 + 3, "cpu", torch.float32, padding_row=True)
    model = OLMoASR(ModelDimensions(**MICRO), True, device="meta", dtype=torch.float32)
    model.load_state_dict({k: v.clone() for k, v in sd.items()}, assign=True)
    return model, sd


def test_log_mel_matches_port():
    from olmoasr_tpu_torch import audio

    x = torch.randn(2, 480000, generator=torch.Generator().manual_seed(1)) * 0.2
    assert np.array_equal(ref.mel_filters(), audio.mel_filters_np())
    torch.testing.assert_close(ref.log_mel(x), audio.log_mel_spectrogram(x), atol=1e-5, rtol=0)


def test_int8_rows_match_port():
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    x = torch.randn(3, 50, 64, generator=torch.Generator().manual_seed(2))
    q, s = _quantize_rows(x)
    torch.testing.assert_close(ref.round_rows(x, 8), q.float() * s[..., None], atol=0, rtol=0)
    assert (ref.round_rows(x, 4) - x).abs().max() > 4 * (ref.round_rows(x, 8) - x).abs().max()


def test_encoder_and_decoder_match_port(model_and_sd):
    from olmoasr_tpu_torch.models import whisper as wm

    model, sd = model_and_sd
    mel = ref.log_mel(torch.randn(2, 480000, generator=torch.Generator().manual_seed(3)) * 0.1)
    ours = ref.encode(sd, MICRO, mel)
    theirs = wm.encode_train(model, mel, compute_dtype=torch.float32)
    close(ours, theirs, 1e-3)
    ti, _ = train_driver.reference_ids(["abc de", "fgh"], 448, TOKENS)
    tokens = torch.tensor(np.stack([ti, ti]))
    bias = torch.where(tokens == weights.PADDING_TOKEN, float("-inf"), 0.0)
    ours = ref.decode(sd, MICRO, tokens, theirs, bias)
    theirs = wm.decode_train(model, tokens, theirs, bias)
    n = int((tokens[0] != weights.PADDING_TOKEN).sum())
    close(ours[:, :n], theirs[:, :n], 1e-3)


def test_kv_cache_decode_matches_teacher_forcing(model_and_sd):
    """The port's cached greedy logits (prompt prefill, then steps) are the
    reference's teacher-forced logits over the same tokens."""
    from olmoasr_tpu_torch.models import whisper as wm

    model, sd = model_and_sd
    mel = ref.log_mel(torch.randn(1, 480000, generator=torch.Generator().manual_seed(4)) * 0.1)
    audio = wm.encode_train(model, mel, compute_dtype=torch.float32)
    toks = TOKENS["prompt"] + [97, 98, 99, 100]
    cache = wm.init_cache(model, audio, max_len=16)
    steps = [wm.decode_step(model, torch.tensor([toks[:2]]), cache)[:, -1]]
    for t in toks[2:-1]:
        steps.append(wm.decode_step(model, torch.tensor([[t]]), cache)[:, 0])
    theirs = torch.stack(steps, dim=1)
    ours = ref.decode(sd, MICRO, torch.tensor([toks[:-1]]), audio)[:, 1:]
    close(ours, theirs, 1e-3)


def test_train_steps_match_port(model_and_sd):
    """Two fp32 steps of the port's train step (its AdamW, the clip, the
    schedule) against the reference's loss and AdamW."""
    from olmoasr_tpu_torch.api import OLMoASR
    from olmoasr_tpu_torch.models.dims import ModelDimensions
    from olmoasr_tpu_torch.training import train as tm

    _, sd = model_and_sd
    opt = json.load(open(os.path.join(core.HERE, "traffic", "train-mb16x2.json")))["optimizer"]
    config = tm.TrainConfig(train_steps=opt["train_steps"], peak_lr=opt["peak_lr"] * 1000,
                            micro_batch_size=2, compute_dtype=torch.float32, remat=False)
    model = OLMoASR(ModelDimensions(**MICRO), True, device="meta", dtype=torch.float32)
    model.load_state_dict({k: v.clone() for k, v in sd.items()}, assign=True)
    state = tm.TrainState(model.train(), tm.make_optimizer(config, model.parameters()))
    step = tm.make_train_step(ModelDimensions(**MICRO), config)
    g = torch.Generator().manual_seed(5)
    pcm = (torch.randn(3, 2, 2, 480000, generator=g) * 3000).to(torch.int16)
    texts = [["abc def", "gh"], ["ij klm"], ["nopq"], ["rs", "tu vw", "xy"]]
    ids = [train_driver.reference_ids(t, 448, TOKENS) for t in texts]
    ti = torch.tensor(np.stack([i for i, _ in ids])).view(2, 2, 448)
    tt = torch.tensor(np.stack([o for _, o in ids])).view(2, 2, 448)
    bias = torch.where(ti == weights.PADDING_TOKEN, float("-inf"), 0.0)
    p = {k: v.clone().requires_grad_(True) for k, v in sd.items()
         if k != "encoder.positional_embedding"}
    adam = ref.AdamW(dict(opt, peak_lr=opt["peak_lr"] * 1000))
    for k in range(3):
        batch = {"mel": pcm[k], "text_input": ti, "text_target": tt, "padding_mask": bias}
        state, metrics = step(state, batch)
        loss = 0.0
        for m in range(2):
            n_valid = int((tt[m] != weights.PADDING_TOKEN).sum())
            block = ref.token_loss_sum(p, MICRO, pcm[k, m].float() / 32768, ti[m], tt[m],
                                       remat=False) / n_valid
            block.backward()
            loss += float(block.detach())
        adam.step(p, {n: v.grad / 2 for n, v in p.items()})
        for v in p.values():
            v.grad = None
        # the port's fp32 CPU path sits 1e-4 to 5e-4 from float64 (see close)
        assert float(metrics["loss"]) == pytest.approx(loss / 2, rel=1e-4)
    for name, v in state.model.named_parameters():
        moved = (p[name].detach() - sd[name]).norm()
        err = (v.detach() - p[name].detach()).norm()
        assert err <= 0.02 * moved + 1e-6, (name, float(err), float(moved))


def test_reference_ids_match_the_loader():
    from olmoasr_tpu_torch.training import dataset as ds

    samples = train_driver.make_samples(
        dict(samples=4, seconds=[1.0, 2.0], gain=[0.1, 0.2], cues=[1, 12], chars=[60, 200]),
        2 ** 35 + 1, "cpu")
    rows = [ds.Sample(audio=s["pcm"], transcript={(train_driver._ts(a), train_driver._ts(b)): t
                                                  for (a, b), t in zip(s["times"], s["texts"])})
            for s in samples]
    data = ds.AudioTextDataset(rows, 448, device_mel=True, only_no_ts_mode=True)
    for i, s in enumerate(samples):
        ti, tt = train_driver.reference_ids(s["texts"], 448, TOKENS)
        item = data[i]
        assert np.array_equal(item["text_input"], ti) and np.array_equal(item["text_target"], tt)
        n = len(s["pcm"])
        assert np.array_equal(item["mel"][:n], s["pcm"]) and not item["mel"][n:].any()
        assert 60 <= int((tt != weights.PADDING_TOKEN).sum()) <= 230


def test_token_tables_match_the_port():
    from olmoasr_tpu_torch import decoding
    from olmoasr_tpu_torch.tokenizer import get_tokenizer

    tok = get_tokenizer(multilingual=False, num_languages=99, language="en", task="transcribe")
    opts = decoding.DecodingOptions(**core.load_cell("short-small-b128").traffic["decode"])
    prompt = decoding._resolve_prompt(tok, opts)
    assert prompt == TOKENS["prompt"] and tok.eot == TOKENS["eot"]
    cfg = decoding.build_filter_config(tok, opts, len(prompt), 51864)
    ring = torch.full((1, 8), tok.eot)
    for step, extra in ((0, TOKENS["blocked_first"]), (1, [])):
        out = decoding.apply_filters(torch.zeros(1, 51864), ring, step, cfg)[0]
        blocked = set(torch.nonzero(torch.isinf(out)).flatten().tolist())
        want = {i for a, b in TOKENS["blocked"] for i in range(a, b + 1)} | set(extra)
        assert blocked == want


def test_reference_imports_nothing_of_the_port():
    allowed = {"__future__", "math", "typing", "numpy", "torch", "torch.nn.functional",
               "torch.utils.checkpoint"}
    folder = os.path.join(core.HERE, "reference")
    for f in os.listdir(folder):
        if f.endswith(".py"):
            tree = ast.parse(open(os.path.join(folder, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    assert {a.name for a in node.names} <= allowed, f
                elif isinstance(node, ast.ImportFrom):
                    assert node.module in allowed, (f, node.module)
    code = ("import sys; sys.path.insert(0, '.'); import gpubench.reference.whisper_ref;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'olmoasr_tpu_torch',"
            " 'olmoasr_tpu', 'olmoasr', 'jax', 'jaxlib', 'flax', 'optax', 'orbax'}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "[]", r.stderr
