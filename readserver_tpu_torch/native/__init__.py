"""Native (C++) build components, bound via ctypes.

Per the task's native-component checklist (SURVEY.md §2.2): the reference's
C/C++ build stack maps to ``csrc/sais.cpp`` (ropebwt2 / SGA suffix sorting)
and ``csrc/merge.cpp`` (bwt-merge interleave merge) here; the serve-time hot
path needs no host native code because it runs on-chip (XLA/Pallas).
"""

from readserver_tpu_torch.native.build import (
    bwt_from_sa,
    bwt_merge2_native,
    compute_lf_native,
    native_available,
    sais_int32,
)

__all__ = [
    "sais_int32",
    "bwt_from_sa",
    "bwt_merge2_native",
    "compute_lf_native",
    "native_available",
]
