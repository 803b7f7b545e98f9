"""Compile-on-demand ctypes bindings for csrc/ (no pybind11 in this env).

The shared library is rebuilt only when the source hash changes; the build
is a single g++ -O3 invocation cached under ``build/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_CSRC = _REPO / "csrc"
_BUILD = _REPO / "build"
_SOURCES = ["sais.cpp", "merge.cpp"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_error: Exception | None = None


def _source_hash() -> str:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update((_CSRC / src).read_bytes())
    return h.hexdigest()[:16]


def _compile() -> Path:
    _BUILD.mkdir(exist_ok=True)
    so = _BUILD / f"libreadserver_native_{_source_hash()}.so"
    if so.exists():
        return so
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-fPIC",
        "-shared",
        "-std=c++17",
        *[str(_CSRC / s) for s in _SOURCES],
        "-o",
        str(so),
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return so


def _get_lib() -> ctypes.CDLL:
    global _lib, _load_error
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise _load_error
        try:
            lib = ctypes.CDLL(str(_compile()))
            lib.sais_int32.restype = ctypes.c_int
            lib.sais_int32.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_int64,
            ]
            lib.bwt_from_sa.restype = ctypes.c_int
            lib.bwt_from_sa.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_int64,
            ]
            lib.compute_lf.restype = ctypes.c_int
            lib.compute_lf.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_int64,
            ]
            lib.bwt_merge2.restype = ctypes.c_int
            lib.bwt_merge2.argtypes = [
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_int64,
            ]
            _lib = lib
            return lib
        except Exception as e:  # missing toolchain etc. — NumPy fallback
            _load_error = e
            raise


def native_available() -> bool:
    try:
        _get_lib()
        return True
    except Exception:
        return False


def sais_int32(text: np.ndarray, alphabet_size: int) -> np.ndarray:
    """Suffix array of an int32 text over alphabet [0, alphabet_size)."""
    lib = _get_lib()
    text = np.ascontiguousarray(text, dtype=np.int32)
    n = len(text)
    sa = np.empty(n, dtype=np.int32)
    rc = lib.sais_int32(
        text.ctypes.data, sa.ctypes.data, n, int(alphabet_size)
    )
    if rc != 0:
        raise RuntimeError(f"sais_int32 failed with code {rc}")
    return sa


def compute_lf_native(bwt: np.ndarray, C: np.ndarray) -> np.ndarray:
    """LF array (int32 [n]) in one native pass."""
    lib = _get_lib()
    bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
    C5 = np.ascontiguousarray(np.asarray(C[:5]), dtype=np.int64)
    lf = np.empty(len(bwt), dtype=np.int32)
    rc = lib.compute_lf(bwt.ctypes.data, C5.ctypes.data, lf.ctypes.data, len(bwt))
    if rc != 0:
        raise RuntimeError("LF overflows int32; shard the index")
    return lf


def bwt_merge2_native(
    b1: np.ndarray, m1: int, b2: np.ndarray, m2: int, max_passes: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Interleave-merge two multi-string BWTs → (merged, interleave, passes)."""
    lib = _get_lib()
    b1 = np.ascontiguousarray(b1, dtype=np.uint8)
    b2 = np.ascontiguousarray(b2, dtype=np.uint8)
    n = len(b1) + len(b2)
    merged = np.empty(n, dtype=np.uint8)
    interleave = np.empty(n, dtype=np.uint8)
    rc = lib.bwt_merge2(
        b1.ctypes.data,
        len(b1),
        int(m1),
        b2.ctypes.data,
        len(b2),
        int(m2),
        merged.ctypes.data,
        interleave.ctypes.data,
        int(max_passes),
    )
    if rc < 0:
        raise RuntimeError(f"bwt_merge2 failed with code {rc}")
    return merged, interleave, rc


def bwt_from_sa(
    text: np.ndarray, sa: np.ndarray, num_reads: int
) -> np.ndarray:
    """Collapsed multi-string BWT from (text, suffix array)."""
    lib = _get_lib()
    text = np.ascontiguousarray(text, dtype=np.int32)
    sa = np.ascontiguousarray(sa, dtype=np.int32)
    bwt = np.empty(len(text), dtype=np.uint8)
    rc = lib.bwt_from_sa(
        text.ctypes.data, sa.ctypes.data, bwt.ctypes.data, len(text), num_reads
    )
    if rc != 0:
        raise RuntimeError(f"bwt_from_sa failed with code {rc}")
    return bwt
