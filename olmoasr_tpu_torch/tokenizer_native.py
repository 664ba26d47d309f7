"""ctypes bindings for the port's C++ BPE core (``cpp/bpe.cpp``).

Counterpart of ``olmoasr_tpu/tokenizer_native.py``, the JAX package's native
counterpart of tiktoken's Rust core. The pure-Python engine in
``olmoasr_tpu_torch.tokenizer`` defines the exact semantics and is what the
port's paths call; this gives the same ids (``tests/test_torch_entry_extras.py``)
at about the same speed on short texts, where the ctypes call costs what the
merges save (``chip_smoke._bpe_throughput``, PERF.md). The library is built
with the host's C++ compiler at first use (``cpp/build.py``).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

_lib = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    from olmoasr_tpu_torch.cpp.build import build

    so = build().get("libbpe")
    if not so:
        return None
    lib = ctypes.CDLL(so)
    lib.bpe_create.restype = ctypes.c_void_p
    lib.bpe_create.argtypes = [ctypes.c_char_p]
    lib.bpe_create_byte_fallback.restype = ctypes.c_void_p
    lib.bpe_encode.restype = ctypes.c_int
    lib.bpe_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.bpe_free.argtypes = [ctypes.c_void_p]
    lib.bpe_n_vocab.restype = ctypes.c_int
    lib.bpe_n_vocab.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeBPE:
    """Handle to a C++ BPE encoder. ``rank_file=None`` -> byte-fallback mode."""

    def __init__(self, rank_file: Optional[str] = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native BPE library unavailable (no g++?)")
        self._lib = lib
        if rank_file is None:
            self._handle = lib.bpe_create_byte_fallback()
        else:
            self._handle = lib.bpe_create(rank_file.encode())
        if not self._handle:
            raise RuntimeError(f"failed to load rank file: {rank_file}")
        self._buf_size = 8192
        self._buf = (ctypes.c_int * self._buf_size)()

    @property
    def n_vocab(self) -> int:
        return self._lib.bpe_n_vocab(self._handle)

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        n = self._lib.bpe_encode(self._handle, data, len(data), self._buf, self._buf_size)
        if n > self._buf_size:
            self._buf_size = n + 64
            self._buf = (ctypes.c_int * self._buf_size)()
            n = self._lib.bpe_encode(self._handle, data, len(data), self._buf, self._buf_size)
        return list(self._buf[:n])

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.bpe_free(self._handle)
        except Exception:
            pass


def native_available() -> bool:
    try:
        return _load() is not None
    except Exception:
        return False
