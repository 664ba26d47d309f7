"""Build and load the hand-written CUDA kernels (``olmoasr_tpu_torch/csrc``).

Each ``csrc/*.cu`` source compiles with its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects link into one shared
library with a plain C interface, loaded with :mod:`ctypes`. The library is
built at first use into ``build/olmoasr_tpu_torch/`` at the root of the
checkout, under a name that carries the hash of the sources and flags, so an
edited source rebuilds and an unchanged one is reused.

Nothing here runs at import: ``nvcc``, ``ctypes`` and the library are touched
only when a kernel wrapper is handed a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "olmoasr_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# element-type codes of the C interface (csrc/common.cuh: olm::DType)
F32, BF16, I8 = 0, 1, 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # a, w, bias, resid, out, ws, M, N, K, splits, dtype, out_f32, gelu, stream
    "olm_linear": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, g, b, out, M, K, eps, dtype, stream
    "olm_layer_norm": (_P, _P, _P, _P, _I, _I, _F, _I, _P),
    # q, k, v, ks, vs, m_part, l_part, acc_part, out, B, T, D, H, kv_group,
    # kv_dtype, out_dtype, qscale, stream
    "olm_cross_attention": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    # q, k_new, v_new, row_stride, k_ring, v_ring, anc, m_part, l_part,
    # acc_part, out, L, layer, B, C, offset, D, H, beam_k, dtype, qscale, stream
    "olm_self_attention": (
        _P, _P, _P, _L, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
        _P,
    ),
    "olm_decode_attention_chunks": (_I,),
    # x, ln1_g, ln1_b, wqkv, bqkv, wo1, bo1, ln2_g, ln2_b, wq, bq, wo2, bo2,
    # k_ring, v_ring, ck, cv, cks, cvs, out, kv_new, scratch, L, layer, B, C,
    # offset, D, H, T, dtype, qscale, stream
    "olm_layer_block": (*(_P,) * 22, *(_I,) * 9, _F, _P),
    # B, D, H, T, offset, dtype -> scratch floats
    "olm_layer_block_scratch": (_I, _I, _I, _I, _I, _I),
    # q, k, v, bias, bias_bstride, out, B, H, Tq, Tk, D, causal, scale, dtype, stream
    "olm_attention_fwd": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # q, k, v, dout, bias, bias_bstride, dq, dk, dv, stats, B, H, Tq, Tk, D, causal, scale,
    # dtype, stream
    "olm_attention_bwd": (*(_P,) * 5, _I, *(_P,) * 4, *(_I,) * 6, _F, _I, _P),
}

_RESTYPES = {"olm_layer_block_scratch": ctypes.c_longlong}  # the others return c_int

_lock = threading.Lock()
_loaded: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> Tuple[Path, ...]:
    return tuple(sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libolmoasr_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(cmds) -> str:
    """Run the commands in parallel and wait for every one; raise on the
    first that failed, with its messages; return all messages."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile the kernels unless this exact build exists; returns the
    library's path and the compiler's messages (``-Xptxas -v`` register and
    spill report when ``verbose``). One ``nvcc`` per source runs in
    parallel, then one links."""
    out = library_path()
    if out.exists() and not verbose:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    log = _run_all([
        [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()), "-c", "-o", str(obj), str(src)]
        for src, obj in zip(srcs, objs)
    ])
    tmp = out.with_name(f"{tag}.so.tmp")
    log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, log


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _loaded
    with _lock:
        if _loaded is None:
            handle = ctypes.CDLL(str(build()[0]))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            handle.olm_error_string.argtypes = [ctypes.c_int]
            handle.olm_error_string.restype = ctypes.c_char_p
            _loaded = handle
    return _loaded


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = lib().olm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    import torch

    codes = {torch.float32: F32, torch.bfloat16: BF16, torch.int8: I8}
    if dtype not in codes:
        raise TypeError(f"the CUDA kernels take float32, bfloat16 or int8, not {dtype}")
    return codes[dtype]
