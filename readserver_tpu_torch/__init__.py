"""readserver_tpu_torch — the PyTorch/CUDA port of ``readserver_tpu``.

The JAX package stays as the reference; this package gives the same answers
for the same on-disk artifact, with its device side in PyTorch and its hot
loops in CUDA C++ kernels written for Hopper (``csrc/*.cu``).

* Host layer (``alphabet``, ``config``, ``native``, ``index``, ``corpus``,
  ``oracle``): NumPy and C++ copies of the JAX package's modules, differing
  only in their import lines (importing ``readserver_tpu`` would import jax,
  which the card's machine does not have).
* Device layer (``ops``, ``serve``, ``kernels``): torch tensors on an
  explicit ``device``.  Each kernel's wrapper launches the CUDA kernel for
  CUDA tensors and runs the plain torch form beside it for CPU tensors.

This package imports torch and numpy, never jax.
"""

from readserver_tpu_torch.config import IndexConfig, ServeConfig
from readserver_tpu_torch import alphabet

__version__ = "0.1.0"

__all__ = ["IndexConfig", "ServeConfig", "alphabet", "__version__"]
