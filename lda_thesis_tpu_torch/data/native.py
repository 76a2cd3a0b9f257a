"""ctypes bridge to the native C++ preprocessing pipeline.

Counterpart of ``lda_thesis_tpu/data/native.py``.  The source is the repo's
host runtime, ``runtime/textproc.cpp`` (a plain C interface, no device
code).  At first use it is built with the system ``g++`` into
``lda_thesis_tpu_torch/_build/`` under a name keyed by a hash of the source
and the flags, and loaded with ``ctypes``.  Where ``g++`` or the source is
missing, or ``LDA_NO_NATIVE=1`` is set, :func:`preprocess_documents_native`
returns None and the caller runs the pure-Python pipeline, which gives the
same tokens (``tests/test_torch_corpus.py``); :func:`pipeline` names the one
that runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

__all__ = ["native_available", "pipeline", "preprocess_documents_native"]

SOURCE = Path(__file__).resolve().parents[2] / "runtime" / "textproc.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[Path]:
    """The library's path, compiled if missing; None where it cannot be."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    lib = BUILD_DIR / f"libldat_{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return lib
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("LDA_NO_NATIVE") or not SOURCE.exists():
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.ldat_preprocess.restype = ctypes.c_void_p
        lib.ldat_preprocess.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.ldat_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def pipeline() -> str:
    """The preprocessing pipeline that ``preprocess_documents`` runs here."""
    if native_available():
        return "native C++ (runtime/textproc.cpp)"
    why = "LDA_NO_NATIVE is set" if os.environ.get("LDA_NO_NATIVE") else "no native build"
    return f"pure Python ({why})"


def preprocess_documents_native(
    docs: List[str], stopwords
) -> Optional[List[List[str]]]:
    """Run the C++ pipeline; returns None if the native library is absent."""
    lib = _load()
    if lib is None:
        return None

    encoded = [d.encode("utf-8") for d in docs]
    buf = b"".join(encoded)
    offsets = (ctypes.c_int64 * (len(docs) + 1))()
    pos = 0
    for i, e in enumerate(encoded):
        offsets[i] = pos
        pos += len(e)
    offsets[len(docs)] = pos

    sw = "\n".join(sorted(stopwords)).encode("utf-8")
    ptr = lib.ldat_preprocess(buf, offsets, len(docs), sw, len(sw))
    if not ptr:
        return None
    try:
        raw = ctypes.string_at(ptr)
    finally:
        lib.ldat_free(ptr)
    parts = raw.decode("utf-8").split("\x1e")
    # trailing separator after the last doc -> drop the final empty part
    return [p.split(" ") if p else [] for p in parts[: len(docs)]]
