"""DeviceIndex: the on-device form of a packed index, as torch tensors."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from readserver_tpu_torch.config import IndexConfig
from readserver_tpu_torch.index.builder import PackedIndex

# tensor fields, in the JAX package's DeviceIndex order (ops/types.py there)
ARRAY_FIELDS = (
    "rank_rows", "sym4", "C", "dollar_map", "read_to_sample", "read_lengths",
    "lf", "mark_rank", "sample_pairs", "dsa", "fused_rows",
    "rank2_rows", "C2", "rank3_rows", "C3",
)
STATIC_FIELDS = (
    "n", "num_reads", "num_samples", "num_blocks", "block_size",
    "words_per_block", "max_read_len", "sample_rate", "dsa_bits",
)


def to_device(arr, device) -> torch.Tensor:
    """NumPy array → torch tensor on ``device``.  uint32 tables become int32
    views of the same bits (torch has no uint32 bit work on the CPU; the
    kernels read the words back as uint32), and int64 bucket starts become
    int32 (every position of a single-device index is < 2^31)."""
    a = np.ascontiguousarray(arr)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int32:
        a = a.astype(np.int32)
    if not a.flags.writeable:  # a read-only mmap: torch wants its own copy
        a = a.copy()
    return torch.from_numpy(a).to(device)


@dataclass(frozen=True)
class DeviceIndex:
    """Device-resident index tensors + static layout metadata.

    Same fields as the JAX package's ``DeviceIndex``.  ``rank_rows`` is the
    fused rank-block table flattened to ``[NUM_SYMBOLS * (NB+1), row_words]``
    so that row ``c * (NB+1) + block`` holds checkpoint + bitplane words.
    Every uint32 table is held as an int32 tensor over the same bits.
    """

    # tensors
    rank_rows: torch.Tensor      # int32 (uint32 bits) [5*(NB+1), row_words]
    sym4: torch.Tensor           # int32 (uint32 bits) [ceil(n/8)]
    C: torch.Tensor              # int32 [6]
    dollar_map: torch.Tensor     # int32 [num_reads]
    read_to_sample: torch.Tensor # int32 [num_reads]
    read_lengths: torch.Tensor   # int32 [num_reads]
    lf: torch.Tensor | None = None           # int32 [n]; sign bit = sampled
    mark_rank: torch.Tensor | None = None    # uint32 bits [NB+1, row_words]
    sample_pairs: torch.Tensor | None = None # int32 [n_marked, 2]
    dsa: torch.Tensor | None = None          # uint32 bits [n]
    fused_rows: torch.Tensor | None = None   # uint32 bits [NB, fused_words]
    rank2_rows: torch.Tensor | None = None   # uint32 bits [16*(NB+1), rw]
    C2: torch.Tensor | None = None           # int32 [16]
    rank3_rows: torch.Tensor | None = None   # uint32 bits [64*(NB+1), rw]
    C3: torch.Tensor | None = None           # int32 [64]
    # static metadata
    n: int = 0
    num_reads: int = 0
    num_samples: int = 0
    num_blocks: int = 0
    block_size: int = 256
    words_per_block: int = 8
    max_read_len: int = 256
    sample_rate: int = 0
    dsa_bits: int = 0

    @property
    def log2_block(self) -> int:
        return self.block_size.bit_length() - 1

    @property
    def rows_per_symbol(self) -> int:
        return self.num_blocks + 1

    @property
    def device(self) -> torch.device:
        return self.rank_rows.device

    @classmethod
    def from_packed(
        cls,
        packed: PackedIndex,
        device,
        tiers: frozenset[str] | set[str] | None = None,
    ) -> "DeviceIndex":
        """``tiers`` (from ``index/budget.plan_tiers``) selects which
        OPTIONAL tiers ship to the device: 'marks', 'fused', 'dsa', 'rank2',
        'rank3', 'lf'.  ``None`` ships everything the artifact carries.
        Dropping a tier only changes rank counts, never answers."""
        cfg: IndexConfig = packed.config
        nb1 = packed.rank_blocks.shape[1]
        if packed.n >= (1 << 31):
            raise ValueError("single-device index must fit int32 positions")

        def want(t: str) -> bool:
            return tiers is None or t in tiers

        has_marks = (
            packed.mark_rank is not None
            and packed.sample_rate > 0
            and want("marks")
        )
        has_fused = (
            packed.fused_rows is not None
            and packed.sample_rate > 0
            and want("fused")
        )
        # both walk tiers resolve terminals through the sampled-pair table
        has_pairs = (has_marks or has_fused) and packed.sample_pairs is not None
        # the lf fast walk needs the mark-rank table for its terminal slot
        has_lf = packed.lf is not None and has_marks and want("lf")
        has_dsa = packed.dsa is not None and want("dsa")
        has_r2 = packed.rank2_blocks is not None and want("rank2")
        has_r3 = packed.rank3_blocks is not None and want("rank3")
        rw = cfg.row_words
        arrays = {
            "rank_rows": packed.rank_blocks.reshape(-1, rw),
            "sym4": packed.sym4,
            "C": packed.C,
            "dollar_map": packed.dollar_map,
            "read_to_sample": packed.read_to_sample,
            "read_lengths": packed.read_lengths,
            "lf": packed.lf if has_lf else None,
            "mark_rank": packed.mark_rank if has_marks else None,
            "sample_pairs": packed.sample_pairs if has_pairs else None,
            "dsa": packed.dsa if has_dsa else None,
            "fused_rows": packed.fused_rows if has_fused else None,
            "rank2_rows": (
                packed.rank2_blocks.reshape(-1, rw) if has_r2 else None
            ),
            "C2": packed.C2 if has_r2 else None,
            "rank3_rows": (
                packed.rank3_blocks.reshape(-1, rw) if has_r3 else None
            ),
            "C3": packed.C3 if has_r3 else None,
        }
        meta = dict(
            n=int(packed.n),
            num_reads=int(packed.num_reads),
            num_samples=int(packed.num_samples),
            num_blocks=int(nb1 - 1),
            block_size=cfg.block_size,
            words_per_block=cfg.words_per_block,
            max_read_len=(
                int(packed.read_lengths.max()) if packed.num_reads else 1
            ),
            sample_rate=(
                int(packed.sample_rate) if (has_marks or has_fused) else 0
            ),
            dsa_bits=int(packed.dsa_bits) if has_dsa else 0,
        )
        return cls.from_numpy(arrays, meta, device)

    @classmethod
    def from_numpy(
        cls, arrays: dict[str, np.ndarray | None], meta: dict, device
    ) -> "DeviceIndex":
        """State carried across from any holder of the index arrays — e.g.
        the JAX package's ``DeviceIndex``, as ``{field: np.asarray(leaf)}``
        plus its static fields.  Missing or None arrays stay None."""
        unknown = set(arrays) - set(ARRAY_FIELDS)
        unknown |= set(meta) - set(STATIC_FIELDS)
        if unknown:
            raise ValueError(f"unknown DeviceIndex fields {sorted(unknown)}")
        if int(meta.get("n", 0)) >= (1 << 31):
            raise ValueError("single-device index must fit int32 positions")
        tensors = {
            name: (
                to_device(arrays[name], device)
                if arrays.get(name) is not None
                else None
            )
            for name in ARRAY_FIELDS
        }
        return cls(**tensors, **{k: int(v) for k, v in meta.items()})

    def device_bytes(self) -> int:
        return sum(
            getattr(self, f).nbytes
            for f in ARRAY_FIELDS
            if getattr(self, f) is not None
        )


def lut_from_numpy(lut: np.ndarray, device) -> torch.Tensor:
    """A prefix LUT (int32 [4^p, 2], e.g. ``np.asarray`` of the JAX
    package's ``build_prefix_lut``) → tensor on ``device``."""
    lut = np.asarray(lut)
    if lut.ndim != 2 or lut.shape[1] != 2:
        raise ValueError(f"prefix LUT must be [4^p, 2], got {lut.shape}")
    return to_device(lut, device)
