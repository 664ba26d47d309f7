"""Multi-rank training of the port (``train.shard_train_state``,
``make_train_step`` with a mesh, ``train_loop.main`` under torchrun) on CPU
``gloo`` ranks at micro dims, against one process and against the JAX
package's sharded step.

Each multi-rank run spawns its ranks as processes of their own
(``tests/torch_dist_worker.py``: torch and the port only, no JAX), joined
through a ``file://`` rendezvous under the test's temporary directory; the
``train_loop.main`` case goes through torchrun (``--standalone`` picks a free
port). 2 ranks run DDP (fsdp_size 1), FSDP2 ``full`` and ``grad_op``
(fsdp_size 2); 4 ranks a 2 x 2 hybrid. Each takes two steps of two
accumulated micro-batches of 4 samples, the ranks' rows holding different
numbers of valid tokens.

Against one process over the same global batch (``make_train_step`` without
a mesh), at fp32 on the flash route, which rounds nothing (the kernel
route's bf16 rounding of P and ds can flip a last-bit difference into 1e-3,
see ``tests/test_torch_training.py``): loss, accuracy, grad norm and lr of
each step within 1e-6 relative. The ranks sum each gradient in another order
than one process does, so where a leaf's rows nearly cancel (the LayerNorm
parameters) its last gradients differ by up to 3.3e-6 of its largest, held
to 1e-5, and Adam's normalised update turns that into up to 3.6e-5 of a
leaf's move: each leaf's difference, in the L2 norm, is held to 1e-4 of how
far one process moved it. One DDP run on the kernel route is held against
one process on it at tests/test_torch_training.py's tolerances (TOL,
GRAD_TOL, 1% of the move). Against the JAX package:
``make_sharded_train_step`` on the conftest's CPU devices with the mesh of
each run, (2, 1), (1, 2), (1, 2) with ``zero2``, (2, 2), XLA attention on
both sides (``OLMOASR_TRAIN_FLASH_MULTICHIP=0``), within
``tests/test_torch_training.py``'s TOL for the metrics, and per leaf the
parameters' difference within 1% of JAX's move.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from olmoasr_tpu.models import whisper as jm
from olmoasr_tpu.models.dims import ModelDimensions as JaxDims
from olmoasr_tpu.parallel import mesh as jmesh
from olmoasr_tpu.training import train as jtrain
from olmoasr_tpu_torch.models import convert
from olmoasr_tpu_torch.models import whisper as tm
from olmoasr_tpu_torch.models.dims import ModelDimensions
from olmoasr_tpu_torch.training import train as ttrain

MICRO = dict(n_mels=80, n_audio_ctx=40, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
             n_vocab=51864, n_text_ctx=24, n_text_state=128, n_text_head=2, n_text_layer=2)
TOL, GRAD_TOL = 2e-4, 4e-3  # tests/test_torch_training.py's (see there)
# multi-rank against one process on the flash route (see the module docstring)
RANKS_TOL = 1e-6  # loss, accuracy, grad norm, lr: relative (1.6e-7 seen)
RANKS_GRAD_TOL = 1e-5  # the last gradients, per leaf against its largest (3.3e-6 seen)
RANKS_MOVE_TOL = 1e-4  # parameters, per leaf: L2 of the difference against the move's (3.6e-5)
KERNEL_TOL = 1e-2  # the kernel route's parameters: the difference within 1% of the move
ACCUM, GLOBAL_MICRO, STEPS = 2, 4, 2
CONFIG = dict(train_steps=10, eff_batch_size=ACCUM * GLOBAL_MICRO,
              micro_batch_size=GLOBAL_MICRO, peak_lr=1e-3, remat=True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
# (name, ranks, fsdp_size, zero2, attention) and the JAX mesh of each
RUNS = (("ddp", 2, 1, False, "flash"), ("full", 2, 2, False, "flash"),
        ("grad_op", 2, 2, True, "flash"), ("ddp_kernel", 2, 1, False, "kernel"),
        ("hybrid", 4, 2, False, "flash"))
JAX_MESH = {"ddp": (2, 1), "full": (1, 2), "grad_op": (1, 2), "hybrid": (2, 2)}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (REPO, env.get("PYTHONPATH"))))
    return env


def _batches():
    """STEPS global batches of (ACCUM, GLOBAL_MICRO) samples with PADDING_TOKEN
    suffixes of different lengths: each rank's rows hold their own count of
    valid tokens."""
    out = []
    T = MICRO["n_text_ctx"]
    for step in range(STEPS):
        rng = np.random.default_rng(100 + step)
        n = ACCUM * GLOBAL_MICRO
        mel = rng.standard_normal((n, 80, 2 * MICRO["n_audio_ctx"])).astype(np.float32)
        lens = rng.integers(2, T + 1, n)
        lens[::GLOBAL_MICRO] = T  # rank 0's first row unpadded, the others shorter
        tokens = rng.integers(0, 50000, (n, T + 1))
        pad = np.arange(T)[None] >= lens[:, None]
        b = {"mel": mel,
             "text_input": np.where(pad, jm.PADDING_TOKEN, tokens[:, :-1]).astype(np.int32),
             "text_target": np.where(pad, jm.PADDING_TOKEN, tokens[:, 1:]).astype(np.int32),
             "padding_mask": np.where(pad, -np.inf, 0.0).astype(np.float32)}
        out.append({k: v.reshape(ACCUM, GLOBAL_MICRO, *v.shape[1:]) for k, v in b.items()})
    return out


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), JaxDims(**MICRO),
                                                   include_padding_token=True))


def _spawn(job: dict, world: int, tmp) -> dict:
    """The job's runs on ``world`` gloo ranks, each its own process; rank 0's
    results."""
    path = str(tmp / f"job{world}.pt")
    torch.save(job, path)
    procs = [subprocess.Popen([sys.executable, WORKER, path, str(r), str(world),
                               str(tmp / f"rdzv{world}")], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return torch.load(path + ".out", weights_only=False)


@pytest.fixture(scope="module")
def ranks(params, tmp_path_factory):
    """Every run of RUNS: {name: {"metrics": [per step], "params": state dict}}."""
    tmp = tmp_path_factory.mktemp("ranks")
    dims = ModelDimensions(**MICRO)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches()]
    job = {"dims": MICRO, "config": CONFIG, "batches": batches,
           "state_dict": convert.state_dict_from_jax_params(params, dims)}
    out = {}
    for world in sorted({r[1] for r in RUNS}):
        runs = [(name, fsdp, zero2, attn) for name, w, fsdp, zero2, attn in RUNS if w == world]
        out.update(_spawn({**job, "runs": runs}, world, tmp))
    return out


def _one_process(params, attention):
    dims = ModelDimensions(**MICRO)
    model = tm.empty_model(dims, include_padding_token=True)
    model.load_state_dict(convert.state_dict_from_jax_params(params, dims))
    model.train()
    cfg = ttrain.TrainConfig(**CONFIG, compute_dtype=torch.float32, attention=attention)
    state = ttrain.TrainState(model, ttrain.make_optimizer(cfg, model.parameters()))
    step = ttrain.make_train_step(dims, cfg)
    metrics = []
    for b in _batches():
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, model.state_dict(), {k: p.grad for k, p in model.named_parameters()}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_ranks_match_one_process(ranks, params, name):
    """Loss, accuracy, grad norm and lr of each step, the last step's
    gradients and every parameter after it equal one process's over the
    global batch."""
    attention = next(r[4] for r in RUNS if r[0] == name)
    want_metrics, want, want_grads = _one_process(params, attention)
    got = ranks[name]
    flash = attention == "flash"
    for step, (g, w) in enumerate(zip(got["metrics"], want_metrics)):
        for key in ("loss", "accuracy", "grad_norm", "lr"):
            err = _rel(g[key], w[key])
            assert err <= (RANKS_TOL if flash else TOL), (name, step + 1, key, g[key], w[key])
    assert got["grads"].keys() == want_grads.keys() and got["params"].keys() == want.keys()
    for k, w in want_grads.items():
        assert _rel(got["grads"][k], w) <= (RANKS_GRAD_TOL if flash else GRAD_TOL), (name, k)
    init = convert.state_dict_from_jax_params(params, ModelDimensions(**MICRO))
    for k, w in want.items():
        diff, moved = float((got["params"][k] - w).norm()), float((w - init[k]).norm())
        assert diff <= (RANKS_MOVE_TOL if flash else KERNEL_TOL) * moved, (name, k, diff, moved)


@pytest.mark.parametrize("name", list(JAX_MESH))
def test_ranks_match_jax_sharded_step(ranks, params, name, monkeypatch):
    """The JAX package's ``make_sharded_train_step`` over the run's mesh
    shape (``zero2`` for grad_op), from the same parameters and batches."""
    monkeypatch.setenv("OLMOASR_TRAIN_FLASH_MULTICHIP", "0")  # XLA attention, no global mesh
    n_data, n_fsdp = JAX_MESH[name]
    mesh = jmesh.make_mesh(n_data, n_fsdp, devices=jax.devices()[:n_data * n_fsdp])
    cfg = jtrain.TrainConfig(**{**CONFIG, "remat": False}, compute_dtype=jnp.float32)
    opt = jtrain.make_optimizer(cfg)
    jp = jax.tree.map(jnp.asarray, params)
    state = jtrain.TrainState(jp, opt.init(jp), jnp.zeros((), jnp.int32))
    state, shardings = jtrain.shard_train_state(state, mesh, zero2=name == "grad_op")
    step = jtrain.make_sharded_train_step(JaxDims(**MICRO), cfg, opt, mesh, shardings)
    got = ranks[name]
    dims = ModelDimensions(**MICRO)
    for i, b in enumerate(_batches()):
        state, want = step(state, b)
        for key in ("loss", "accuracy", "grad_norm", "lr"):
            assert _rel(got["metrics"][i][key], float(want[key])) <= TOL, (name, i + 1, key)
    leaves = jax.tree_util.tree_flatten_with_path(
        convert.jax_params_from_state_dict(got["params"], dims))[0]
    for (path, g), w, p0 in zip(leaves, jax.tree.leaves(state.params), jax.tree.leaves(params)):
        w = np.asarray(w)
        diff, moved = np.linalg.norm(g - w), np.linalg.norm(w - p0)
        assert diff <= 1e-2 * moved, (name, jax.tree_util.keystr(path), diff, moved)


ENTRY = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=1, n_audio_layer=1,
             n_vocab=51864, n_text_ctx=448, n_text_state=64, n_text_head=1, n_text_layer=1)


@pytest.fixture
def shard_dir(tmp_path):
    """8 samples of seeded int16 noise with VTT transcripts in one shard."""
    import gzip

    d = tmp_path / "shards"
    d.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i in range(8):
        path = d / f"a{i}.npy"
        np.save(path, (rng.standard_normal(int(16000 * rng.uniform(2, 6))) * 2000).astype(np.int16))
        cue = f"00:00:00.000 --> 00:00:01.500\nhello {i} world"
        rows.append({"audio_file": str(path), "transcript": f"WEBVTT\n\n{cue}\n", "ext": "vtt"})
    with gzip.open(d / "shard0.jsonl.gz", "wt") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return d


def test_train_loop_under_torchrun_resumes_across_world_sizes(shard_dir, tmp_path, monkeypatch):
    """One step on one process, then ``train_loop.main`` under torchrun on 2
    gloo ranks (FSDP2 ``grad_op``, async eval) resuming it for one step, then
    one process resuming that for a third. The ranks' checkpoint holds the
    gathered state (bf16 moments), its ``eval_2.npz`` loads in both
    packages, and rank 0 alone logged."""
    from olmoasr_tpu.models.convert import load_npz_checkpoint
    from olmoasr_tpu_torch import load_model
    from olmoasr_tpu_torch.training import checkpoint, train_loop

    monkeypatch.chdir(tmp_path)
    flags = dict(train_shards=str(shard_dir / "*.jsonl.gz"), exp_name="dist", train_steps=10,
                 eff_batch_size=4, ckpt_dir="ckpt", ckpt_every=0, log_every=1, device="cpu",
                 mu_dtype="bfloat16")
    kw = {**flags, "variant": ModelDimensions(**ENTRY)}
    assert train_loop.main(**kw, micro_batch_size=4, max_steps_this_run=1)["global_step"] == 1
    ranks_kw = {**flags, "dims": ENTRY, "micro_batch_size": 2, "max_steps_this_run": 1,
                "fsdp_size": 2, "fsdp_strategy": "grad_op", "eval_every": 2,
                "eval_dir": str(tmp_path / "no_eval_set")}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           WORKER, "loop", json.dumps(ranks_kw)]
    proc = subprocess.run(cmd, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    mgr = checkpoint.CheckpointManager("ckpt/dist")
    assert mgr.latest_step() == 2
    with open("logs/dist_metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f if '"train/loss"' in line]
    assert steps == [1, 2]  # one line a step: the one process's, then rank 0's
    jparams, jdims = load_npz_checkpoint("ckpt/dist/eval_2.npz")
    assert jdims.to_dict() == ENTRY
    model = load_model("ckpt/dist/eval_2.npz", device="cpu")
    cfg = ttrain.TrainConfig(train_steps=10, mu_dtype=torch.bfloat16)
    state, meta = mgr.restore(ttrain.init_train_state(42, ModelDimensions(**ENTRY), cfg,
                                                      device="cpu"))
    assert state.step == 2 and meta["global_step"] == 2
    sd = state.model.state_dict()
    for k, v in model.state_dict().items():
        want = sd[k][:jm.PADDING_TOKEN] if k == "decoder.token_embedding.weight" else sd[k]
        assert torch.equal(v, want), k
    np.testing.assert_array_equal(np.asarray(jparams["decoder"]["blocks"]["mlp_w1"][0]),
                                  sd["decoder.blocks.0.mlp.0.weight"].numpy().T)
    moments = {t.dtype for st in state.optimizer.state.values()
               for t in (st["exp_avg"], st["exp_avg_sq"])}
    assert moments == {torch.bfloat16, torch.float32}  # mu bf16, nu fp32
    out = train_loop.main(**kw, micro_batch_size=4, max_steps_this_run=1)
    assert out["global_step"] == 3 and np.isfinite(out["train/loss"])
