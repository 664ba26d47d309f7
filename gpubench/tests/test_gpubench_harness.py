"""The harness on the CPU: every cell's files are found by name, the names
and units keep to the allowed characters, a new cell is new files and new
entries, the measured path refuses a machine without a card, and the check
for JAX's modules compares whole top-level names."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from gpubench import core

ROOT = core.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"] and BENCH["command"][1] == "gpubench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/") and LINE.match(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        # every cell that reports the metric reports the metric it moves
        moved = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m.get("workloads", CELLS)) <= set(moved)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]] + [
            w["config"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for dirpath, _, files in os.walk(os.path.join(ROOT, "gpubench")):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = core.load_cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.config["reduced"] == [c for c in BENCH["configs"]
                                      if c["name"] == cell.workload["config"]][0]["reduced"]
    assert os.path.isfile(os.path.join(ROOT, "gpubench", "drivers",
                                       f"{cell.traffic['kind']}.py"))
    for m in cell.per_layer:
        assert callable(core.load_metric(m["name"]))
    assert cell.limits["numbers"]
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_new_cell_needs_no_edit(tmp_path):
    """A cell added as new files and new entries, in a copy of the tree."""
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in map(str, (tmp_path / "gpubench").rglob("*"))
              if os.path.isfile(p)}
    bench = json.loads(json.dumps(BENCH))
    g = tmp_path / "gpubench"
    (g / "configs" / "medium.en.json").write_text(json.dumps(
        {"name": "medium.en", "dims": dict(core.load_cell(CELLS[0]).dims, n_audio_state=1024,
                                           n_text_state=1024), "reduced": []}))
    (g / "traffic" / "short-b32.json").write_text(json.dumps(
        dict(core.load_cell(CELLS[0]).traffic, batch=32)))
    (g / "limits" / "short-medium-b32.json").write_text(json.dumps(
        core.load_cell(CELLS[0]).limits))
    (g / "metrics" / "windows_per_batch.py").write_text(
        "def read(ctx):\n    return 32.0\n")
    bench["configs"].append({"name": "medium.en", "source": "https://example.org",
                             "file": "gpubench/configs/medium.en.json", "reduced": [],
                             "why": "w"})
    bench["workloads"].append({"name": "short-medium-b32", "config": "medium.en",
                               "traffic": "short-b32", "chips": 1, "why": "w"})
    bench["end_to_end"].append({"name": "audio_s_per_s.medium", "unit": "audio-s/s",
                                "better": "higher", "bound": 0.1, "source": "host_clock",
                                "workloads": ["short-medium-b32"]})
    bench["per_layer"].append({"name": "windows_per_batch", "unit": "windows", "better": "higher",
                               "source": "program_counter", "layer": "host loop",
                               "moves": "audio_s_per_s.medium", "workloads": ["short-medium-b32"]})
    bench["per_layer"].append({"name": "device_idle_pct.transcribe.medium", "unit": "%",
                               "better": "lower", "source": "device_trace", "layer": "device",
                               "moves": "audio_s_per_s.medium", "workloads": ["short-medium-b32"]})
    cell = core.load_cell("short-medium-b32", root=str(tmp_path), bench=bench)
    assert cell.traffic["batch"] == 32 and cell.dims["n_audio_state"] == 1024
    assert sorted(m["name"] for m in cell.end_to_end) == ["audio_s_per_s.medium", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["windows_per_batch",
                                                   "device_idle_pct.transcribe.medium"]
    assert core.load_metric("windows_per_batch", root=str(tmp_path))(None) == 32.0
    # a quantity in new cells: its value and its reader are the base metric's
    assert core.prefixes("audio_s_per_s.medium")[1] == "audio_s_per_s"
    assert callable(core.load_metric("device_idle_pct.transcribe.medium", root=str(tmp_path)))
    assert all(open(p, "rb").read() == data for p, data in before.items())


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the run prints no result and fails; there is no
    CPU fallback."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "gpubench/run.py", "--workload", CELLS[0], "--seed",
                        str(2 ** 33 + 5), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 2 and r.stdout.strip() == ""
    assert "CUDA card" in r.stderr


def test_only_benchmark_files_fail(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone (no
    program) gives no result."""
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "gpubench/run.py", "--workload", CELLS[0], "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_forbidden_top_level_names():
    assert core.forbidden_modules(["olmoasr_tpu_torch", "olmoasr_tpu_torch.api"]) == []
    assert core.forbidden_modules(["olmoasr_tpu.models.whisper"]) == ["olmoasr_tpu"]
    assert core.forbidden_modules(["olmoasr", "olmoasr.model"]) == ["olmoasr"]
    assert core.forbidden_modules(["jaxlib.xla_client", "flax", "optax", "orbax.checkpoint",
                                   "jax_utils"]) == ["flax", "jaxlib", "optax", "orbax"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_harness_reads_no_tpu_benchmark_or_jax():
    """No file of the benchmark imports JAX or the JAX package, or names
    the TPU benchmark's files."""
    for dirpath, _, files in os.walk(os.path.join(ROOT, "gpubench")):
        for f in files:
            path = os.path.join(dirpath, f)
            if f.endswith(".py"):
                assert core.forbidden_modules(list(_imports(path))) == [], path
            text = open(path, errors="replace").read()
            if "tests" not in dirpath:
                for name in ("bench.py", "chip_smoke", "BENCH_r", "MULTICHIP_", "perf/"):
                    assert name not in text, (path, name)


def test_run_loads_no_jax():
    """A run's imports (the harness, the drivers, the program) load no
    module of JAX or the JAX package."""
    code = ("import sys; sys.path.insert(0, '.');"
            "from gpubench import core, cost, trace, weights;"
            "import gpubench.drivers.transcribe, gpubench.drivers.train;"
            "import olmoasr_tpu_torch.api, olmoasr_tpu_torch.decoding,"
            " olmoasr_tpu_torch.training.train, olmoasr_tpu_torch.training.dataset;"
            "print(core.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
