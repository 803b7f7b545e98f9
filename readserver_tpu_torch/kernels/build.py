"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources under ``readserver_tpu_torch/csrc/`` have a plain C interface,
so one ``nvcc -shared`` call builds them into a shared library in seconds
(no PyTorch headers).  The library lands in ``build/kernels/``, named by a
hash of its sources, and is built at first use.  Nothing here runs at
import: the CPU tests import every module on a host with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "kernels"
_SOURCES = ("rank.cu", "search.cu")
_HEADERS = ("rank.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C entry points: name → argtypes (every one returns cudaGetLastError())
SIGNATURES = {
    "rs_rank_occ": [_P, _P, _P, _P, _L, _L, _I, _I, _I, _P],
    "rs_backward_search": [
        _P, _P, _L, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I,
        _L, _I, _I, _I, _P, _P, _P, _P,
    ],
}


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in (*_SOURCES, *_HEADERS):
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


class _Library:
    """The built kernel library: compiled once per process, at first use."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.path: Path | None = None
        self.build_seconds: float | None = None
        self.build_log = ""

    def build(self) -> Path:
        """Compile the sources (if this hash is not built yet) → .so path.
        Raises ``RuntimeError`` with nvcc's output when the build fails."""
        _BUILD.mkdir(parents=True, exist_ok=True)
        so = _BUILD / f"libreadserver_kernels_{_source_hash()}.so"
        if so.exists():
            return so
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            *[str(_CSRC / s) for s in _SOURCES], "-o", str(tmp),
        ]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                + self.build_log
            )
        tmp.replace(so)
        return so

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.path = self.build()
                lib = ctypes.CDLL(str(self.path))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


LIBRARY = _Library()


class Kernel:
    """One C entry point of the library, with a count of its launches.

    ``launches`` grows by one each time the kernel is launched, and
    nowhere else; a refused launch raises instead of counting."""

    def __init__(self, symbol: str) -> None:
        self.symbol = symbol
        self.launches = 0

    def __call__(self, *args) -> None:
        import torch

        fn = getattr(LIBRARY.get(), self.symbol)
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA error {rc} at launch"
            )
        self.launches += 1


def on_cuda(t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain form); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain form for device {t.device}")


def ptr(t) -> int | None:
    """A tensor's device pointer for ctypes (None for a missing tensor)."""
    return None if t is None else t.data_ptr()
