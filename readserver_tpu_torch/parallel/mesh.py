"""Placement of the interval-sharded index: the ``(dp, shard)`` shape the
engine reads, on one device.

The JAX package spreads the ``'shard'`` axis over devices and merges the
shards' contributions with a ``psum``.  Here all S shards stay resident on
one device and the kernels sum them (each position has one owner), so a
placement is the axis sizes and that device.  Several devices, hosts or a
``dp`` axis above 1 are ROADMAP P11's layer above this one.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

_P11 = (
    "interval shards across devices or hosts, and a dp axis above 1, are "
    "not ported yet (ROADMAP P11): every shard lives on one device"
)


@dataclass(frozen=True)
class Mesh:
    """``shape["dp"]`` and ``shape["shard"]``, as the engine reads a JAX
    mesh's axes, and the one device every shard lives on."""

    shape: dict = field(default_factory=lambda: {"dp": 1, "shard": 1})
    device: torch.device = torch.device("cuda")


def make_mesh(
    data_parallel: int = 1,
    num_shards: int = 1,
    devices: list | None = None,
    *,
    device="cuda",
) -> Mesh:
    """A ``(dp, shard)`` placement of ``num_shards`` interval shards on
    ``device`` (the card unless the caller asks for the CPU).  ``devices``,
    when given, must name that one device; more than one device, or
    ``data_parallel > 1``, raises ``NotImplementedError`` (ROADMAP P11)."""
    if devices is not None:
        if len(devices) != 1:
            raise NotImplementedError(_P11)
        device = devices[0]
    if data_parallel != 1:
        raise NotImplementedError(_P11)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return Mesh(shape={"dp": 1, "shard": int(num_shards)},
                device=torch.device(device))
