"""The port's hand-written CUDA kernels (sources in ``csrc/``).

* ``RANK_OCC`` (K1, ``csrc/rank.cu``): batched occ over a rank-row table;
  launched by ``ops/rank.occ_rows`` for CUDA tensors.
* ``BACKWARD_SEARCH`` (K2, ``csrc/search.cu``): the whole backward search,
  one thread per query; launched by the search functions of
  ``ops/search.py`` for CUDA tensors.

Each is a :class:`~readserver_tpu_torch.kernels.build.Kernel` carrying its
launch count in ``launches``.
"""

from readserver_tpu_torch.kernels.build import LIBRARY, Kernel

RANK_OCC = Kernel("rs_rank_occ")
BACKWARD_SEARCH = Kernel("rs_backward_search")
KERNELS = {"rank_occ": RANK_OCC, "backward_search": BACKWARD_SEARCH}

__all__ = ["BACKWARD_SEARCH", "KERNELS", "LIBRARY", "Kernel", "RANK_OCC"]
