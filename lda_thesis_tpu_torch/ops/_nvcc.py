"""Build a CUDA source into a shared library with ``nvcc`` and load it.

Each kernel of the port is one ``csrc/*.cu`` file with a plain C interface.
It is compiled at first use into ``lda_thesis_tpu_torch/_build/``, under a
name keyed by a hash of the source and the flags, and loaded with
``ctypes``.  Importing this module needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence, Tuple

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# -fmad=false: no a*b+c contraction, so a kernel rounds every operation where
# its plain PyTorch version does.  No fast-math: 1/x stays correctly rounded.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return str(path)


def build(source: Path, flags: Sequence[str] = NVCC_FLAGS) -> Tuple[Path, float, str]:
    """Compile ``source`` if its library is missing.

    Returns ``(library path, seconds spent compiling, compiler output)``;
    seconds is 0 and the output empty when the library was already built.
    """
    key = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    lib = BUILD_DIR / f"{source.stem}_{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, time.perf_counter() - t0, proc.stdout + proc.stderr


def load(source: Path, flags: Sequence[str] = NVCC_FLAGS) -> ctypes.CDLL:
    """Build ``source`` if needed and load its library."""
    path, _, _ = build(source, flags)
    return ctypes.CDLL(str(path))
