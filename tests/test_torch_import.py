"""The port imports torch and never jax, optax, orbax or anything of the JAX
package (``olmoasr_tpu``) or of the top-level ``olmoasr`` shim bound to it;
chip_smoke.py refuses to run without a CUDA device or outside a checkout."""

from __future__ import annotations

import os
import pkgutil
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    import olmoasr_tpu_torch

    names = ["olmoasr_tpu_torch"]
    for info in pkgutil.walk_packages(olmoasr_tpu_torch.__path__, "olmoasr_tpu_torch."):
        names.append(info.name)
    return names


# the modules the port must never load: jax and its optimizer and checkpoint
# libraries, the JAX package itself (even its modules free of jax) and the
# top-level ``olmoasr`` shim over it (the port's own is ``olmoasr_tpu_torch.olmoasr``)
FORBIDDEN = ("jax", "optax", "orbax", "olmoasr_tpu", "olmoasr")
LEAKED = (f"leaked = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
          "assert not leaked, leaked\n")


def _assert_imports_no_jax(names):
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        + LEAKED
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


def test_port_never_imports_jax():
    names = _port_modules()
    assert "olmoasr_tpu_torch.ops.attention" in names and len(names) >= 12
    assert "olmoasr_tpu_torch.transcribe" in names and "olmoasr_tpu_torch.serve" in names
    for name in ("training.train", "training.train_loop", "training.dataset",
                 "training.checkpoint", "training.logging_utils", "data.transcripts",
                 "tokenizer", "writers", "utils", "models.dims", "training.validate",
                 "eval.harness", "eval.datasets", "eval.wer", "eval.analysis", "eval.figures",
                 "normalizers", "normalizers.english", "normalizers.basic",
                 "normalizers.build_spelling", "data.segment", "data.align", "olmoasr",
                 "olmoasr.model", "olmoasr.inf_model", "olmoasr.transcribe",
                 "olmoasr.preprocess", "olmoasr.utils", "demo.demo", "parallel.mesh",
                 "data.jsonl", "data.sampling", "data.filtering", "data.tagging",
                 "data.audio_lang", "data.qa_video", "data.yodas", "eval.get_eval_set",
                 "models.gen_inf_ckpt", "integrations.hf", "eval.parity", "tokenizer_native",
                 "cpp", "cpp.build", "tracing"):
        assert f"olmoasr_tpu_torch.{name}" in names, name
    _assert_imports_no_jax(names)


def test_entry_points_import_no_jax():
    """The server module, the trainer, the eval harness, the compat surface,
    the demo and ``python -m olmoasr_tpu_torch.transcribe --help``."""
    _assert_imports_no_jax(["olmoasr_tpu_torch.serve"])
    _assert_imports_no_jax(["olmoasr_tpu_torch.training.train_loop"])
    _assert_imports_no_jax(["olmoasr_tpu_torch.eval.harness", "olmoasr_tpu_torch.normalizers"])
    _assert_imports_no_jax(["olmoasr_tpu_torch.olmoasr", "olmoasr_tpu_torch.demo.demo"])
    code = (
        "import runpy, sys\n"
        "sys.argv = ['transcribe', '--help']\n"
        "try:\n"
        "    runpy.run_module('olmoasr_tpu_torch.transcribe', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        + LEAKED
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, timeout=120,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert "--beam_size" in proc.stdout and "--device" in proc.stdout


def test_extra_entry_points_run_without_jax(tmp_path):
    """``gen_inf_ckpt``, the HF export's state dict, the parity harness's
    ``--help``, the demo's checkpoint flow and the native BPE (built and
    run) load nothing of jax or of the JAX package."""
    code = (
        "import runpy, sys, torch\n"
        "from olmoasr_tpu_torch.models.dims import VARIANT_TO_DIMS\n"
        "from olmoasr_tpu_torch.api import _new_model\n"
        "from olmoasr_tpu_torch.models import convert\n"
        "from olmoasr_tpu_torch.models.gen_inf_ckpt import gen_inf_ckpt\n"
        "from olmoasr_tpu_torch.integrations.hf import params_to_hf_state_dict\n"
        "from olmoasr_tpu_torch.demo.demo import ensure_checkpoint, export_hf\n"
        "from olmoasr_tpu_torch import tokenizer_native\n"
        "dims = VARIANT_TO_DIMS['tiny.en']\n"
        "model = _new_model(dims, True, 'cpu', torch.float32)\n"
        f"path = {str(tmp_path / 'tiny.pt')!r}\n"
        "torch.save({'dims': dims.to_dict(), 'model_state_dict': model.state_dict()}, path)\n"
        "gen_inf_ckpt(path, path[:-3] + '.npz')\n"
        "assert len(params_to_hf_state_dict(model.state_dict(), dims)) > 100\n"
        "if tokenizer_native.native_available():\n"
        "    assert tokenizer_native.NativeBPE(None).encode('ab') == [97, 98]\n"
        "sys.argv = ['parity', '--help']\n"
        "try:\n"
        "    runpy.run_module('olmoasr_tpu_torch.eval.parity', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        + LEAKED
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, timeout=120,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert "--allow_fallback_tokenizer" in proc.stdout and "--device" in proc.stdout


def test_long_form_entry_points_import_no_jax():
    """The long-form engine on its own (its JAX counterpart imports jax at
    its top): the module, and the package's lazy ``transcribe_many``."""
    _assert_imports_no_jax(["olmoasr_tpu_torch.transcribe"])
    import olmoasr_tpu_torch
    from olmoasr_tpu_torch import transcribe

    assert olmoasr_tpu_torch.transcribe_many.__module__ == "olmoasr_tpu_torch"
    assert callable(transcribe.transcribe_many)


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_cuda_device():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
