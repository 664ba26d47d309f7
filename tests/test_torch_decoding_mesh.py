"""Decoding split across ranks (``decoding.set_infer_mesh``) on CPU ``gloo``
ranks at micro dims, against the port's unsplit ``decode`` and the JAX
package's ``decode`` without a mesh; the transcribe CLI and the eval harness
under a process group against one process.

The ranks are processes of ``tests/torch_dist_worker.py`` (torch and the
port only, no JAX) joined through a ``file://`` rendezvous, or, for the CLI,
launched by torchrun. The model and the windows are
``tests/test_decoding_mesh.py``'s (``PRNGKey(0)`` weights, 8 windows of
``PRNGKey(1)`` noise, ``SAMPLE_LEN`` tokens) at fp32, and so are its
tolerances: ``no_speech_prob`` within 1e-5, ``avg_logprob`` within 1e-4.
Tokens are held equal. At 2 ranks: greedy over 8 windows and beam 2; a
sampled decode at T=0.8 with ``best_of=2`` over 8 identical windows, whose
two shards must draw differently; 3 windows, which cannot split and decode
whole without a collective; the same decode with no mesh registered, which
issues none. At 4 ranks, a (2, 2) mesh whose rank grid is transposed
(``[[0, 2], [1, 3]]``): shard i is the i-th rank of the grid read row-major,
so rank 1 decodes the third quarter of the windows and the results still
come back in window order.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch

from olmoasr_tpu import decoding as jdec
from olmoasr_tpu.models import whisper as jm
from olmoasr_tpu.models.dims import ModelDimensions as JaxDims
from olmoasr_tpu_torch import decoding
from olmoasr_tpu_torch.api import _new_model
from olmoasr_tpu_torch.models import convert
from olmoasr_tpu_torch.models.dims import ModelDimensions

MICRO = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
             n_vocab=51864, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)
SAMPLE_LEN = 12  # tests/test_decoding_mesh.py's
NO_SPEECH_TOL, LOGPROB_TOL = 1e-5, 1e-4  # tests/test_decoding_mesh.py's
EOT = 50256
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
FP32 = dict(sample_len=SAMPLE_LEN, fp16=False, without_timestamps=True)
GREEDY = dict(temperature=0.0, **FP32)
BEAM = dict(temperature=0.0, beam_size=2, **FP32)
SAMPLED = dict(temperature=0.8, best_of=2, **FP32)
LAYOUT_4 = [[0, 2], [1, 3]]  # rank grid of the (2, 2) mesh: shard order 0, 2, 1, 3


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (REPO, env.get("PYTHONPATH"))))
    return env


@pytest.fixture(scope="module")
def params():
    return jm.init_params(jax.random.PRNGKey(0), JaxDims(**MICRO), include_padding_token=False)


@pytest.fixture(scope="module")
def mel():
    return np.array(jax.random.normal(jax.random.PRNGKey(1), (8, 80, 3000)) * 0.5)


@pytest.fixture(scope="module")
def state_dict(params):
    return convert.state_dict_from_jax_params(jax.tree.map(np.asarray, params),
                                              ModelDimensions(**MICRO))


@pytest.fixture(scope="module")
def model(state_dict):
    m = _new_model(ModelDimensions(**MICRO), False, "cpu", torch.float32)
    m.load_state_dict(state_dict)
    return m.eval()


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """5 LibriSpeech-format utterances of 2-8 s noise with seeded texts."""
    root = tmp_path_factory.mktemp("eval")
    chap = root / "LibriSpeech" / "test-clean" / "19" / "198"
    chap.mkdir(parents=True)
    rng = np.random.default_rng(3)
    lines = []
    for i in range(5):
        utt = f"19-198-{i:04d}"
        wav = (rng.standard_normal(int(16000 * rng.uniform(2, 8))) * 1000).astype(np.int16)
        wavfile.write(str(chap / f"{utt}.wav"), 16000, wav)
        lines.append(f"{utt} " + " ".join(rng.choice(["A", "B", "SPEECH", "THE"], 4)))
    (chap / "19-198.trans.txt").write_text("\n".join(lines))
    return str(root)


@pytest.fixture(scope="module")
def byte_ckpt(params, tmp_path_factory):
    """The weights as an ``.npz``, the token embedding's text rows past the
    byte tokens zeroed, so that the offline tokenizer's text is not empty."""
    sd = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, params),
                                            ModelDimensions(**MICRO))
    sd["decoder.token_embedding.weight"][256:EOT] = 0.0
    path = str(tmp_path_factory.mktemp("ckpt") / "micro.npz")
    convert.save_npz_checkpoint(path, sd, ModelDimensions(**MICRO))
    return path


def _spawn(job: dict, layout, tmp) -> list:
    """The decode job on the ranks of ``layout``, each its own process;
    every rank's results, in rank order."""
    world = int(np.asarray(layout).size)
    path = str(tmp / f"decode{world}.pt")
    torch.save({**job, "kind": "decode", "layout": layout, "dims": MICRO}, path)
    procs = [subprocess.Popen([sys.executable, WORKER, path, str(r), str(world),
                               str(tmp / f"rdzv{world}")], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [torch.load(f"{path}.out{r}", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(state_dict, mel, byte_ckpt, eval_tree, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks2")
    m = torch.from_numpy(mel)
    same = m[:1].expand(8, -1, -1).contiguous()
    cases = {"greedy": (m, GREEDY, True), "beam": (m, BEAM, True),
             "sampled": (same, SAMPLED, True), "ragged": (m[:3], GREEDY, True),
             "no_mesh": (m, GREEDY, False)}
    job = {"state_dict": state_dict, "cases": cases, "sample_len": SAMPLE_LEN,
           "eval": ["--eval_set", "librispeech_clean", "--eval_dir", eval_tree, "--ckpt",
                    byte_ckpt, "--batch_size", "4", "--device", "cpu"],
           "eval_out": str(tmp / "eval_rank")}
    return _spawn(job, [[0], [1]], tmp), tmp


def _unsplit(model, mel, options):
    return decoding.decode(model, torch.from_numpy(np.asarray(mel)),
                           decoding.DecodingOptions(**options))


def _assert_same(case: dict, want):
    assert case["tokens"] == [r.tokens for r in want]
    np.testing.assert_allclose(case["no_speech_prob"], [r.no_speech_prob for r in want],
                               atol=NO_SPEECH_TOL)
    np.testing.assert_allclose(case["avg_logprob"], [r.avg_logprob for r in want],
                               atol=LOGPROB_TOL)


@pytest.mark.parametrize("name", ["greedy", "beam"])
def test_two_ranks_match_unsplit_and_jax(two_ranks, model, params, mel, name):
    """Both ranks' results equal each other's (every rank gathers), the
    port's unsplit decode's and the JAX decode's without a mesh; the audio
    features are gathered in window order."""
    ranks, _ = two_ranks
    options = GREEDY if name == "greedy" else BEAM
    got = [r["cases"][name] for r in ranks]
    assert got[0]["tokens"] == got[1]["tokens"]
    assert got[0]["avg_logprob"] == got[1]["avg_logprob"]
    assert torch.equal(got[0]["audio_features"], got[1]["audio_features"])
    assert got[0]["gathers"] == 4  # tokens, log-probs, no-speech, features: after the loop
    want = _unsplit(model, mel, options)
    _assert_same(got[0], want)
    feats = torch.stack([r.audio_features for r in want])
    torch.testing.assert_close(got[0]["audio_features"], feats, rtol=0, atol=1e-5)
    jdec.set_infer_mesh(None)
    _assert_same(got[0], jdec.decode(params, JaxDims(**MICRO), mel,
                                     jdec.DecodingOptions(**options)))


def test_two_ranks_sample_from_their_own_generators(two_ranks):
    """T=0.8, best_of=2 over 8 identical windows: it completes, both ranks
    hold the same results, and the two shards' draws differ (each rank's
    generator is derived from the caller's and its shard index)."""
    ranks, _ = two_ranks
    got = [r["cases"]["sampled"] for r in ranks]
    assert got[0]["tokens"] == got[1]["tokens"] and len(got[0]["tokens"]) == 8
    assert got[0]["tokens"][:4] != got[0]["tokens"][4:]


def test_ragged_batch_and_no_mesh_decode_whole(two_ranks, model, mel):
    """3 windows over 2 ranks decode whole on each rank, and with no mesh
    registered nothing is split: neither issues a collective, and both equal
    the unsplit decode."""
    ranks, _ = two_ranks
    assert decoding._usable_infer_mesh(8) is None  # this process registers none
    for name, windows in (("ragged", mel[:3]), ("no_mesh", mel)):
        want = _unsplit(model, windows, GREEDY)
        for r in ranks:
            assert r["cases"][name]["gathers"] == 0, name
            _assert_same(r["cases"][name], want)


def test_four_ranks_keep_the_row_major_shard_order(state_dict, model, mel, tmp_path):
    """A (2, 2) mesh over the rank grid [[0, 2], [1, 3]]: rank r's shard
    index is its row-major position in the grid, and the gathered greedy
    results equal the unsplit decode, window for window."""
    ranks = _spawn({"state_dict": state_dict,
                    "cases": {"greedy": (torch.from_numpy(mel), GREEDY, True)}},
                   LAYOUT_4, tmp_path)
    assert [r["shard_index"] for r in ranks] == [0, 2, 1, 3]
    want = _unsplit(model, mel, GREEDY)
    for r in ranks:
        assert r["cases"]["greedy"]["gathers"] == 4
        _assert_same(r["cases"]["greedy"], want)


def test_harness_main_at_two_ranks_matches_one_process(two_ranks, byte_ckpt, eval_tree,
                                                       tmp_path):
    """``eval.harness.main`` in a 2-rank group (5 utterances in batches of
    4: one split batch, one ragged batch of 1 that decodes whole): rank 0's
    results files are those of ``short_form_eval`` in one process, the
    real-time factor apart; rank 1 writes nothing."""
    from olmoasr_tpu_torch import load_model
    from olmoasr_tpu_torch.eval import harness

    _, tmp = two_ranks
    assert not os.path.exists(tmp / "eval_rank1")
    model = load_model(byte_ckpt, device="cpu", inference=True)
    decode = model.decode
    model.decode = lambda mel, options: decode(mel, dataclasses.replace(
        options, fp16=False, sample_len=SAMPLE_LEN))
    want = harness.short_form_eval(model, "librispeech_clean", eval_tree, batch_size=4)
    assert any(r["hyp"] for r in want.per_sample)
    harness.write_results(want, str(tmp_path), "micro.npz")
    for suffix in (".txt", ".json", "_per_sample.csv"):
        name = f"librispeech_clean_micro.npz{suffix}"
        got, ref = (tmp / "eval_rank0" / name).read_text(), (tmp_path / name).read_text()
        if suffix == ".json":
            got, ref = ({k: v for k, v in json.loads(t).items() if k != "rtfx"}
                        for t in (got, ref))
        elif suffix == ".txt":
            got, ref = ([line for line in t.splitlines() if not line.startswith("rtfx=")]
                        for t in (got, ref))
        assert got == ref, suffix


def test_transcribe_cli_under_torchrun_writes_one_processs_outputs(byte_ckpt, tmp_path,
                                                                   monkeypatch):
    """``transcribe.cli`` under torchrun on 2 gloo ranks (two files, one
    round of 2 windows split 1 + 1, beam 5 at t=0, fp32): rank 0 writes the
    five outputs of each file, equal to the one-process CLI's; rank 1 writes
    nothing."""
    rng = np.random.default_rng(8)
    wavs = []
    for name, seconds in (("a", 3), ("b", 5)):
        wavs.append(str(tmp_path / f"{name}.wav"))
        wavfile.write(wavs[-1], 16000, (rng.standard_normal(16000 * seconds) * 3000)
                      .astype(np.int16))

    def argv(out):
        return [*wavs, "--model", byte_ckpt, "-o", str(out), "--device", "cpu", "--batch_size",
                "2", "--temperature_increment_on_fallback", "None", "--verbose", "False"]

    job = {"argv": argv(tmp_path / "rank{rank}"), "sample_len": SAMPLE_LEN}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           WORKER, "cli", json.dumps(job)]
    proc = subprocess.run(cmd, env=_env(), capture_output=True, text=True, timeout=300,
                          cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr

    from olmoasr_tpu_torch import transcribe as tr

    monkeypatch.setattr(tr, "DecodingOptions", lambda **kw: decoding.DecodingOptions(
        **{**kw, "fp16": False, "sample_len": SAMPLE_LEN}))
    tr.cli(argv(tmp_path / "one"))
    names = sorted(f"{n}.{e}" for n in ("a", "b") for e in ("txt", "vtt", "srt", "tsv", "json"))
    assert not os.path.exists(tmp_path / "rank1")
    assert sorted(os.listdir(tmp_path / "rank0")) == sorted(os.listdir(tmp_path / "one")) == names
    for name in names:
        assert (tmp_path / "rank0" / name).read_text() == (tmp_path / "one" / name).read_text()
    assert any(json.loads((tmp_path / "one" / f"{n}.json").read_text())["text"] for n in "ab")
