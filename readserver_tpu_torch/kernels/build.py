"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources under ``readserver_tpu_torch/csrc/`` have a plain C interface,
so nvcc builds them into one shared library in seconds (no PyTorch
headers): one compile per source, all at once, then one link.  The
library lands in ``build/kernels/``, named by a hash of its sources, and
is built at first use.  Nothing here runs at import: the CPU tests import
every module on a host with no nvcc.
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
_SOURCES = ("rank.cu", "search.cu", "resolve.cu", "sharded.cu",
            "sharded_partial.cu", "compact.cu", "pack.cu")
_HEADERS = ("rank.cuh", "search.cuh", "walk.cuh", "shard_view.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_ulonglong

# the walk's tables, as csrc/resolve.cu's sweep entry points take them
# (RS_WALK_PARAMS; ops/resolve._walk_args builds them)
_WALK = [_P, _I, _P, _I, _P, _P, _P, _P, _L, _I, _I, _I, _P, _P, _L, _P, _L, _I]

# C entry points: name → argtypes (every one returns cudaGetLastError())
SIGNATURES = {
    "rs_rank_occ": [_P, _P, _P, _P, _L, _L, _I, _I, _I, _P],
    "rs_lut_level": [_P, _P, _P, _P, _L, _P, _P, _P, _L, _L, _I, _I, _I, _P],
    "rs_backward_search": [
        _P, _P, _L, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I,
        _L, _I, _I, _I, _P, _P, _P, _P,
    ],
    "rs_resolve_dsa": [_P, _P, _L, _I, _P, _I, _P, _L, _P, _P, _P, _P],
    "rs_resolve_fused": [_P, _P, _L, *_WALK, _P, _P, _P],
    "rs_resolve_walk": [_I, _P, _P, _L, *_WALK, _P, _P, _P],
    "rs_exact_histogram": [_P, _P, _L, _L, _I, *_WALK, _P, _L, _I, _P, _P],
    # a yardstick for chip_smoke.py, launched by no path of the port
    "rs_chase": [_P, _I, _L, _P, _L, _I, _P, _P],
    # the rank walks' one-round limit, for scripts/torch_walk_ab.py's sweep
    "rs_walk_one_round_max": [_I],
    # the interval-sharded index (csrc/sharded.cu); the first argument is
    # the address of an ops/sharded.ShardView
    "rs_shard_occ": [_P, _I, _P, _P, _P, _L, _P],
    "rs_sharded_search": [_P, _P, _P, _L, _I, _P, _I, _I, _P, _P, _P, _P],
    "rs_sharded_lut_level": [_P, _P, _P, _L, _P, _P, _L, _P],
    "rs_sharded_resolve": [
        _P, _I, _P, _P, _L, _P, _P, _P, _P, _P, _L, _L, _I, _P, _P,
    ],
    # one rank's partials over its run of the shards and the walk steps
    # (csrc/sharded_partial.cu); the second argument is the address of an
    # ops/sharded.RunKeys, a walk's the address of an ops/sharded.WalkBuffers
    "rs_shard_occ_partial": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _L, _P,
                             _P],
    "rs_shard_lookup_partial": [_P, _P, _I, _P, _P, _L, _P, _P],
    "rs_sharded_lut_level_partial": [_P, _P, _P, _P, _L, _I, _P, _L, _P],
    "rs_walk_lf_step": [_P, _P, _P, _I, _U, _P],
    "rs_walk_slow_step": [_P, _P, _P, _I, _I, _U, _P],
    # the walks' live flag, a mapped host word
    "rs_host_word": [_P, _P],
    "rs_host_word_free": [_P],
    # the row-budget compaction and the capped histogram (csrc/compact.cu)
    "rs_row_compact": [_P, _P, _I, _L, _I, _L, _P, _P, _P, _P],
    "rs_row_gather": [_P, _L, _I, _L, _P, _P, _I, _P, _L, _P, _P, _P, _P,
                      _P],
    "rs_capped_histogram": [_P, _P, _L, _I, _P, _L, _I, _P, _P],
    # the served answer's sparse pack and the cohort merge (csrc/pack.cu);
    # the merge's first three arguments are host arrays
    "rs_sparse_pack": [_P, _P, _P, _P, _L, _I, _P, _P, _P, _I, _L, _L, _I,
                       _P, _P, _L, _P, _L, _P],
    "rs_merge_pack": [_P, _P, _P, _P, _I, _L, _I, _I, _I, _L, _L, _P, _P,
                      _L, _P, _L, _P],
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
        objs = [so.with_suffix(f".{os.getpid()}.{s}.o") for s in _SOURCES]
        flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
        t0 = time.perf_counter()
        # one nvcc per source, all started together, then one link
        cmds = [
            [_nvcc(), *flags, "-Xptxas", "-v", "-c", str(_CSRC / s),
             "-o", str(o)]
            for s, o in zip(_SOURCES, objs)
        ]
        procs = [
            subprocess.Popen(c, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for c in cmds
        ]
        logs = [p.communicate()[0] for p in procs]
        self.build_log = "".join(logs)
        for cmd, proc, out in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n" + out
                )
        link = [_nvcc(), *flags, "-shared", *map(str, objs), "-o", str(tmp)]
        proc = subprocess.run(link, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        for o in objs:
            o.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(link)}\n"
                + proc.stdout + proc.stderr
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
        self._fn = None  # the bound entry point, at the first launch

    def __call__(self, *args, device) -> None:
        """Launch on ``device`` (the device of the tensors in ``args``), on
        that device's current stream.  The calling thread's current device
        may be another one (the dispatcher's worker thread): then the launch
        runs under ``torch.cuda.device(device)``."""
        import torch

        fn = self._fn
        if fn is None:
            fn = self._fn = getattr(LIBRARY.get(), self.symbol)
        current = torch.cuda.current_device()
        index = current if device.index is None else device.index
        if index == current:
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
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


def check_int32(name: str, t, device, shape=None) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous int32 tensor on
    ``device`` (of ``shape`` when given): what a kernel may read."""
    import torch

    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous int32 tensor on {device}, got "
            f"{t.dtype} on {t.device}"
        )
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
