"""Distribution layer of the port: BWT-interval sharding with every shard
on one device (``mesh``, ``sharded``; the JAX package's ``make_mesh``,
``ShardedIndex``, ``build_sharded``, ``place_sharded``,
``make_sharded_query_fn`` and ``build_prefix_lut_sharded``) and the
analytic collective counts (``stats``, a copy of the JAX package's
module).  Shards across devices and hosts (ROADMAP P11) and document
sharding across devices (P9) are still to port."""

from readserver_tpu_torch.parallel.mesh import Mesh, make_mesh
from readserver_tpu_torch.parallel.sharded import (
    ShardedIndex,
    build_prefix_lut_sharded,
    build_sharded,
    make_sharded_query_fn,
    place_sharded,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "ShardedIndex",
    "build_sharded",
    "place_sharded",
    "make_sharded_query_fn",
    "build_prefix_lut_sharded",
]
