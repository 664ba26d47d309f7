"""Build the port's native C++ cores with the host's C++ compiler (``g++ -O3
-shared -fPIC``), at first use, into ``build/olmoasr_tpu_torch/`` at the root
of the checkout, under a name that carries the hash of the sources: an
edited source rebuilds, an unchanged one is reused. Called by
``olmoasr_tpu_torch.tokenizer_native``, or by hand:

    python -m olmoasr_tpu_torch.cpp.build

``unicode_tables.inc``, which ``bpe.cpp`` includes, is generated into the
same directory first: the codepoint ranges of the character classes of the
port tokenizer's GPT-2 pattern (``tokenizer._GPT2_PAT``), from the same
``regex`` module that the tokenizer runs, so that the C++ pre-tokenizer
splits text as the Python engine does.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

CPP_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "olmoasr_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

TARGETS = {
    "libbpe": ["bpe.cpp"],
}

# the GPT-2 pattern's classes, as the C++ tables name them
_CLASSES = {"kLetter": r"\p{L}", "kNumber": r"\p{N}", "kSpace": r"\s"}


def generate_unicode_tables(path: Optional[str] = None, force: bool = False) -> str:
    """Write ``unicode_tables.inc`` (into the build directory by default):
    for each class of the GPT-2 pattern, its sorted codepoint ranges."""
    import regex

    from olmoasr_tpu_torch.tokenizer import _GPT2_PAT

    path = path or str(BUILD_DIR / "unicode_tables.inc")
    if os.path.isfile(path) and not force:
        return path
    lines = ["// generated by olmoasr_tpu_torch/cpp/build.py: codepoint ranges per"
             "\n// GPT-2 pattern class, derived from the Python `regex` module.\n"]
    for name, cls in _CLASSES.items():
        if cls not in _GPT2_PAT:
            raise ValueError(f"the tokenizer's pattern has no {cls}: {_GPT2_PAT!r}")
        pat = regex.compile(cls)
        ranges = []
        start = None
        for cp in range(0x110000):
            m = not 0xD800 <= cp <= 0xDFFF and pat.match(chr(cp)) is not None
            if m and start is None:
                start = cp
            elif not m and start is not None:
                ranges.append((start, cp - 1))
                start = None
        if start is not None:
            ranges.append((start, 0x10FFFF))
        body = ",".join(f"{{{a},{b}}}" for a, b in ranges)
        lines.append(
            f"static const uint32_t {name}[][2] = {{{body}}};\n"
            f"static const int {name}Count = {len(ranges)};\n"
        )
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}"
    with open(tmp, "w") as f:
        f.writelines(lines)
    os.replace(tmp, path)
    return path


def build(force: bool = False) -> Dict[str, Optional[str]]:
    """Compile every target; returns ``{target: path of the .so, or None
    when there is no C++ compiler or the build failed}``."""
    out: Dict[str, Optional[str]] = {}
    cxx = shutil.which("g++") or shutil.which("c++")
    tables = generate_unicode_tables(force=force)
    for target, sources in TARGETS.items():
        srcs = [CPP_DIR / s for s in sources]
        digest = hashlib.sha256(b"".join(
            [p.read_bytes() for p in srcs] + [Path(tables).read_bytes(),
                                               " ".join(CXX_FLAGS).encode()])).hexdigest()[:16]
        so_path = BUILD_DIR / f"{target}-{digest}.so"
        if so_path.is_file() and not force:
            out[target] = str(so_path)
            continue
        if cxx is None:
            out[target] = None
            continue
        tmp = f"{so_path}.{os.getpid()}"
        cmd = [cxx, *CXX_FLAGS, "-I", str(BUILD_DIR), "-o", tmp, *map(str, srcs)]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, so_path)
            out[target] = str(so_path)
        except subprocess.CalledProcessError as e:
            print(f"native build failed for {target}:\n{e.stderr.decode()}")
            out[target] = None
    return out


if __name__ == "__main__":
    print(build(force=True))
