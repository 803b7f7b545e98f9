"""Shared pieces of the port's parity tests (tests/test_torch_*.py).

Each test feeds the same NumPy inputs, made from a seed, to the JAX package
(on the CPU) and to its torch counterpart, and compares exactly: every
output of the count path is an integer.
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, for kernel-vs-plain tests; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def t32(x, device="cpu") -> torch.Tensor:
    """NumPy (or JAX) integer array → int32 torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x), dtype=np.int32)).to(device)


def np_of(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()
