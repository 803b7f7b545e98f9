"""Shared pieces of the port's parity tests (tests/test_torch_*.py).

Each test feeds the same NumPy inputs, made from a seed, to the JAX package
(on the CPU) and to its torch counterpart, and compares exactly: every
output of the count path is an integer.
"""

import gc

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, for kernel-vs-plain tests; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def thaw_heap():
    """Imported by each test module that warms an engine (autouse there):
    ``warmup()`` freezes everything alive into the collector's permanent
    generation (``serve/engine._settle_heap``), so each test ends with the
    heap thawed, and no test's frozen engines stay held, never collected,
    for the rest of the worker's life."""
    yield
    gc.unfreeze()


def t32(x, device="cpu") -> torch.Tensor:
    """NumPy (or JAX) integer array → int32 torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x), dtype=np.int32)).to(device)


def np_of(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()
