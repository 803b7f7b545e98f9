"""Device-side query ops: rank, backward search, prefix LUT.

Functions over a :class:`DeviceIndex` of torch tensors.  For CUDA tensors
they launch the port's kernels (``kernels/``); for CPU tensors they run the
plain torch forms beside them.
"""

from readserver_tpu_torch.ops.types import DeviceIndex, lut_from_numpy
from readserver_tpu_torch.ops.rank import occ, occ_rows
from readserver_tpu_torch.ops.search import (
    backward_search,
    backward_search_lut,
    backward_search_pair,
    canonical_empty,
    encode_query_batch,
    prefix_ids,
)
from readserver_tpu_torch.ops.lut import build_prefix_lut, default_lut_order

__all__ = [
    "DeviceIndex",
    "lut_from_numpy",
    "occ",
    "occ_rows",
    "backward_search",
    "backward_search_lut",
    "backward_search_pair",
    "build_prefix_lut",
    "canonical_empty",
    "default_lut_order",
    "encode_query_batch",
    "prefix_ids",
]
