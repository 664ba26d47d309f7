"""The port imports torch and never jax; chip_smoke.py refuses to run without
a CUDA device or outside a checkout."""

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


def _assert_imports_no_jax(names):
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "leaked = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not leaked, leaked\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


def test_port_never_imports_jax():
    names = _port_modules()
    assert "olmoasr_tpu_torch.ops.attention" in names and len(names) >= 11
    assert "olmoasr_tpu_torch.transcribe" in names
    _assert_imports_no_jax(names)


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
