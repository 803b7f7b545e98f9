"""Distribution layer of the port: BWT-interval sharding (``mesh``,
``sharded``; the JAX package's ``make_mesh``, ``ShardedIndex``,
``build_sharded``, ``place_sharded``, ``make_sharded_query_fn`` and
``build_prefix_lut_sharded``) and document sharding (``doc_sharded``:
``DocShardedIndex``, ``build_doc_sharded``, ``place_doc_sharded``,
``make_doc_query_fn``), each with every shard on one device or a run of
them on each rank of a process group (``multihost``: ``init_multihost``,
``make_global_mesh``, ``host_local_queries``, ``gather_results``,
``gather_shards``, ``local_slice``), and the analytic collective counts
(``stats``, a copy of the JAX package's module)."""

from readserver_tpu_torch.parallel.mesh import Mesh, make_mesh
from readserver_tpu_torch.parallel.doc_sharded import (
    DocShardedIndex,
    build_doc_sharded,
    make_doc_query_fn,
    place_doc_sharded,
)
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
    "DocShardedIndex",
    "build_doc_sharded",
    "place_doc_sharded",
    "make_doc_query_fn",
]
