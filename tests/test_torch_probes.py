"""The port's H100 probes of the training attention
(``olmoasr_tpu_torch/perf/probe_pack.py``, ``probe_pipe.py``,
``probe_bwd.py``) against the TPU probes they port (``perf/probe_*.py``,
read as source: they run at import) and against the production twins.

On the CPU every probe wrapper runs its plain version. At a micro shape
(B=2, T=130, D=128, 2 heads) each variant's plain version must equal
``train_attention_fwd_plain`` / ``train_attention_bwd_plain`` exactly (the
same operations on the same inputs), the score probe its stated definition,
and each ablation the JAX probe's ``make_ablate`` body written out in numpy.
The probes' useful-FLOP counts are the JAX probes' expressions evaluated at
the same shape. The kernels themselves are held to the twins by the gpu
tests in ``tests/test_torch_train_attention.py``.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from olmoasr_tpu_torch.ops import train_attention as ta
from olmoasr_tpu_torch.perf import _probes as P
from olmoasr_tpu_torch.perf import probe_bwd, probe_pack, probe_pipe

JAX_PERF = Path(__file__).resolve().parents[1] / "perf"
HEADS = 2


def _src(name: str) -> str:
    return (JAX_PERF / f"{name}.py").read_text()


@pytest.fixture(scope="module")
def micro():
    return P.inputs(4, shape=(2, 130, 64 * HEADS), seed=1, device="cpu")


def test_modules_import_without_cuda():
    for mod in (probe_pack, probe_pipe, probe_bwd):
        assert mod.VARIANTS and callable(mod.main)
    assert all(w.launches == 0 for w in P.WRAPPERS)


@pytest.mark.parametrize("probe, mod", [("probe_pack", probe_pack), ("probe_pipe", probe_pipe),
                                        ("probe_bwd", probe_bwd)])
def test_variant_names_are_the_jax_probes(probe, mod):
    """Every name the JAX probe dispatches on is a variant here, with the
    H100's tile sizes."""
    src = _src(probe)
    prefixes = set(re.findall(r'variant\.startswith\("(\w+)"\)', src))
    exact = set(re.findall(r'variant == "(\w+)"', src))
    assert prefixes and all(any(v.startswith(p) for v in mod.VARIANTS) for p in prefixes)
    assert exact <= set(mod.VARIANTS)
    for variant in mod.VARIANTS:  # each accepted before anything runs
        {"probe_pack": probe_pack.parse, "probe_pipe": probe_pipe.cases,
         "probe_bwd": probe_bwd.check}[probe](variant)


def test_unknown_variants_raise():
    for bad in ("seq256", "pack512", "rawd96x64", "warp64"):
        with pytest.raises(ValueError):
            probe_pack.parse(bad)
    for bad in ("pipe512", "fuse128"):
        with pytest.raises(ValueError):
            probe_pipe.cases(bad)
    for bad in ("bq256", "row512", "col64"):
        with pytest.raises(ValueError):
            probe_bwd.check(bad)


def test_ablate_sets_are_the_jax_probes():
    tree = ast.parse(_src("probe_pipe"))
    loops = [n for n in ast.walk(tree) if isinstance(n, ast.For)
             and isinstance(n.target, ast.Name) and n.target.id == "drop"]
    assert len(loops) == 1
    jax_sets = [frozenset(ast.literal_eval(e)) if not isinstance(e, ast.Call) else frozenset()
                for e in loops[0].iter.elts]
    assert jax_sets == [drop for drop, _ in P.ABLATE][:len(jax_sets)]
    names = [name for name, _, _ in probe_pipe.cases("ablate")]
    assert names[0] == "sb128 -none" and len(set(names)) == len(P.ABLATE)


@pytest.mark.parametrize("probe, var, products", [
    ("probe_pack", "flops_fwd", 2), ("probe_pipe", "flops_fwd", 2), ("probe_bwd", "flops_bwd", 5)])
def test_useful_flops_are_the_jax_probes(probe, var, products):
    expr = re.search(rf"^{var} = ([^#\n]+)", _src(probe), re.M)[1]
    n, t, dh = P.B * P.H, P.T, P.DH
    env = {"N": n, "Tq": t, "Tk": t, "Tq_pad": t, "Tk_pad": t, "dh": dh}
    assert eval(expr, {}, env) == P.useful_flops(products) == 2 * products * n * t * t * dh
    assert P.useful_flops(1) * 2 == P.useful_flops(2)  # the score product alone


@pytest.mark.parametrize("variant", [v for v in probe_pack.VARIANTS if not v.startswith("raw")])
def test_pack_variants_plain_equal_the_twin(micro, variant):
    q, k, v, _ = micro
    got = probe_pack.call(variant, q, k, v, HEADS)
    assert torch.equal(got, ta.train_attention_fwd_plain(q, k, v, HEADS))


@pytest.mark.parametrize("variant", [v for v in probe_pack.VARIANTS if v.startswith("raw")]
                         + ["raw64"])
def test_score_probe_plain_is_its_definition(micro, variant):
    """out[b, i, h*64 + j] = sum over key tiles t of s[b, h, i, 64 t + j],
    with s the pre-scaled q times K^T in fp32 and keys past the end 0."""
    q, k, _, _ = micro
    got = probe_pack.call(variant, q, k, None, HEADS)
    scale = ta._scale(64, q.dtype)
    qh = (q.view(2, 130, HEADS, 64) * scale).float().numpy().astype(np.float64)
    kh = k.view(2, 130, HEADS, 64).float().numpy().astype(np.float64)
    s = np.einsum("bihd,bjhd->bhij", qh, kh)
    want = np.zeros((2, HEADS, 130, 64))
    for t0 in range(0, 130, 64):
        tile = s[..., t0:t0 + 64]
        want[..., :tile.shape[-1]] += tile
    want = want.transpose(0, 2, 1, 3).reshape(2, 130, HEADS * 64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("variant", [v for v in probe_pipe.VARIANTS if v != "ablate"])
def test_pipe_variants_plain_equal_the_twin(micro, variant):
    q, k, v, _ = micro
    bias = torch.zeros((1, 130))
    for _, fn, attends in probe_pipe.cases(variant):
        assert attends
        assert torch.equal(fn(q, k, v, bias, HEADS), ta.train_attention_fwd_plain(q, k, v, HEADS))


def _ablate_numpy(q, k, v, bias, drop):
    """``make_ablate``'s kernel body (perf/probe_pipe.py) per head, in numpy."""
    bf = lambda x: torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()
    scale = ta._scale(64, q.dtype)
    out = np.zeros((2, 130, HEADS * 64), np.float32)
    for h in range(HEADS):
        cols = slice(64 * h, 64 * h + 64)
        qh = bf(q[..., cols].float().numpy() * scale)
        kh, vh = k[..., cols].float().numpy(), v[..., cols].float().numpy()
        s = qh @ kh.transpose(0, 2, 1)
        if "bias" not in drop:
            s = s + bias
        if "max" not in drop:
            s = s - s.max(-1, keepdims=True)
        if "exp" in drop:
            p = s
        elif "bf16exp" in drop:
            p = bf(np.exp(bf(s)))
        elif "exp2" in drop:
            p = np.exp2(s * 1.4426950408889634)  # the exp, to the last bits
        else:
            p = np.exp(s)
        l = p.sum(-1, keepdims=True) if "sum" not in drop else 1.0
        o = bf(p) @ vh
        out[..., cols] = o / l if "div" not in drop else o
    return bf(out)


@pytest.mark.parametrize("drop", [drop for drop, _ in P.ABLATE],
                         ids=lambda d: ",".join(sorted(d)) or "none")
def test_ablations_plain_match_make_ablate(micro, drop):
    q, k, v, _ = micro
    bias = torch.full((1, 130), -0.5)
    got = P.probe_ablate(q, k, v, HEADS, drop, bias).float().numpy()
    want = _ablate_numpy(q, k, v, bias.numpy(), drop)
    # the same roundings; sums in another order (numpy against torch) move
    # an element by at most a bf16 step
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7 * np.abs(want).max())
    if not drop:
        assert torch.equal(torch.from_numpy(got), ta.train_attention_fwd_plain(
            q, k, v, HEADS).float())


@pytest.mark.parametrize("variant", probe_bwd.VARIANTS)
def test_bwd_variants_plain_equal_the_twin(micro, variant):
    q, k, v, do = micro
    want = ta.train_attention_bwd_plain(q, k, v, do, HEADS)
    for got, w in zip(probe_bwd.call(variant, q, k, v, do, HEADS), want):
        assert torch.equal(got, w)


def test_cpu_calls_launch_nothing(micro):
    q, k, v, do = micro
    before = [w.launches for w in P.WRAPPERS]
    probe_pack.call("pack64", q, k, v, HEADS)
    probe_bwd.call("row64", q, k, v, do, HEADS)
    assert [w.launches for w in P.WRAPPERS] == before
