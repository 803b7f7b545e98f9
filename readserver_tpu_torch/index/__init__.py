"""Index construction + artifact (reference L1 analog, SURVEY.md §1-§2).

The reference builds per-sample RLE-BWTs with ropebwt2, merges them with
bwt-merge, and loads metadata into RocksDB (SURVEY.md §3.4).  Here the build
is one host-side pipeline: reads → suffix array (native C++ SAIS, NumPy
fallback) → multi-string BWT → bit-packed rank blocks + payload arrays →
versioned directory artifact.
"""

from readserver_tpu_torch.index.builder import PackedIndex, build_index
from readserver_tpu_torch.index.artifact import load_artifact, save_artifact

__all__ = ["PackedIndex", "build_index", "save_artifact", "load_artifact"]
