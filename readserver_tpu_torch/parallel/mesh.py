"""Placement of the interval-sharded index: the ``(dp, shard)`` mesh the
engine reads, laid over the ranks of a process group.

The JAX package spreads the ``'shard'`` axis over devices and merges the
shards' contributions with a ``psum``, and splits the batch over ``'dp'``.
Here each rank of a ``torch.distributed`` group drives one device.  The
``S`` shards (``shape["shard"]``) are spread over ``ranks["shard"]`` ranks,
a contiguous run of ``S / ranks["shard"]`` shards on each; the ranks that
hold the runs of one dp row form its shard subgroup and sum their partials
by one all-reduce a step (``parallel/sharded.py``).  The batch's ``dp``
rows (``shape["dp"]``) are spread over ``ranks["dp"]`` such subgroups, a
rank taking its subgroup's ``dp / ranks["dp"]`` rows in turn.  A mesh of
one rank (no group) holds every shard on its device, where the one-device
kernels serve the shards without collectives unless ``per_step`` asks for
the cross-rank program.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch


@dataclass(frozen=True)
class Mesh:
    """``shape["dp"]`` batch rows and ``shape["shard"]`` index shards, as
    the engine reads a JAX mesh's axes; ``ranks`` the ranks along each
    axis and ``coords`` this rank's place on them; ``shard_group`` the
    ranks of this rank's dp row (None: this rank alone), ``dp_group`` the
    ranks of its shard coordinate (None: this rank alone); ``device`` the
    rank's one device; ``per_step`` runs the cross-rank program on a mesh
    whose shard axis has one rank."""

    shape: dict = field(default_factory=lambda: {"dp": 1, "shard": 1})
    device: torch.device = torch.device("cuda")
    ranks: dict = field(default_factory=lambda: {"dp": 1, "shard": 1})
    coords: dict = field(default_factory=lambda: {"dp": 0, "shard": 0})
    shard_group: Any = None
    dp_group: Any = None
    per_step: bool = False

    @property
    def shards_per_rank(self) -> int:
        return int(self.shape["shard"]) // int(self.ranks["shard"])

    @property
    def first_shard(self) -> int:
        """The first shard of this rank's run."""
        return int(self.coords["shard"]) * self.shards_per_rank

    @property
    def rows_per_rank(self) -> int:
        """The dp rows this rank takes, in turn."""
        return int(self.shape["dp"]) // int(self.ranks["dp"])

    @property
    def cross_rank(self) -> bool:
        """Whether queries run the per-step program with its all-reduces."""
        return int(self.ranks["shard"]) > 1 or self.per_step

    @property
    def lead(self) -> bool:
        """The rank of its dp row that adds the terms no shard owns."""
        return int(self.coords["shard"]) == 0


def make_mesh(
    data_parallel: int = 1,
    num_shards: int = 1,
    devices: list | None = None,
    *,
    device="cuda",
    per_step: bool = False,
) -> Mesh:
    """A ``(dp, shard)`` mesh of ``num_shards`` interval shards and
    ``data_parallel`` batch rows on one rank: every shard on ``device``
    (the card unless the caller asks for the CPU) and the dp rows run in
    turn.  ``devices``, when given, must name that one device (a rank
    drives one; :func:`~readserver_tpu_torch.parallel.multihost.make_global_mesh`
    lays a mesh over a process group).  ``per_step``: the cross-rank
    program, its all-reduces over this rank alone."""
    if devices is not None:
        if len(devices) != 1:
            raise ValueError(
                "a rank drives one device: lay a mesh over several with "
                "make_global_mesh in a process group of one rank a device")
        device = devices[0]
    if data_parallel < 1:
        raise ValueError(f"data_parallel must be >= 1, got {data_parallel}")
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return Mesh(shape={"dp": int(data_parallel), "shard": int(num_shards)},
                device=torch.device(device), per_step=per_step)
