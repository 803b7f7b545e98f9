"""The process group: ``torch.distributed`` wiring of the JAX package's
``parallel/multihost.py``.

One process drives one device.  ``init_multihost`` joins the group,
``make_global_mesh`` lays the ``(dp, shard)`` mesh over its ranks (the
shard axis over consecutive ranks, dp across them), and
``host_local_queries`` / ``gather_results`` / ``local_slice`` are the
ingest and egress hops, and ``gather_shards`` the doc-sharded program's
gather of its hit sets.  The collectives the query programs and the engine
run go through :func:`all_reduce`, :func:`broadcast` and :func:`_gather`;
the all-reduces and the gathers over a group are counted in
``COLLECTIVES``.

The backend is the caller's: ``nccl`` when each rank has a GPU of its own,
``gloo`` when the caller asks for it (the CPU, or ranks sharing one card:
NCCL refuses two ranks on one device, "Duplicate GPU detected");
nothing switches from one to the other.  Both all-reduce CUDA tensors as
they are (gloo through the host); gloo gathers and broadcasts host tensors
here.

Testable without a cluster: N local processes with ``gloo`` on the CPU
form a real group (``tests/test_torch_multihost.py``).
"""

from __future__ import annotations

import math
from datetime import timedelta

import numpy as np
import torch

from readserver_tpu_torch.parallel.mesh import Mesh

BACKENDS = ("nccl", "gloo")
# all-reduces run since the count was last set to 0 (tests and
# chip_smoke.py compare it with parallel/stats.query_psum_estimate), and
# all-gathers over a group of more than this rank
COLLECTIVES = {"all_reduce": 0, "gather": 0}


def init_multihost(
    coordinator: str,
    num_processes: int,
    process_id: int,
    heartbeat_timeout_s: int | None = None,
    *,
    backend: str,
) -> None:
    """Join this process into the group (idempotent per process).

    ``coordinator`` is ``host:port`` of process 0 (a TCP rendezvous).
    ``heartbeat_timeout_s`` becomes the group's timeout: a collective whose
    peer died raises within it (gloo raises at once when the peer's
    connection closes), so a group never answers without a rank."""
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                         process_id):
            raise RuntimeError("this process already joined another group")
        return
    kw = {}
    if heartbeat_timeout_s is not None:
        kw["timeout"] = timedelta(seconds=heartbeat_timeout_s)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id, **kw)


def rank_device(device, process_id: int) -> torch.device:
    """The device a rank drives: ``device`` as given, or for a bare
    ``cuda`` the host's card ``process_id`` modulo the card count (one
    card a rank on a host of several; all ranks on the one card of a host
    of one, where only gloo serves them)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    return device


def make_global_mesh(num_shards: int | None = None, *, device="cuda",
                     per_step: bool = False) -> Mesh:
    """``(dp, shard)`` mesh over every rank of the group: ``num_shards``
    interval shards (default 1) spread over R consecutive ranks, R the
    largest count dividing both the shards and the group (the JAX mesh's
    shard axis where the shards divide the group, and a run of ``S / R``
    shards on each rank where there are more shards than ranks); the
    ``world / R`` groups of consecutive ranks are the dp rows.  Every
    rank must call it, in the same order as its other collectives (it
    makes the subgroups)."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    S = int(num_shards or 1)
    R = math.gcd(S, world)
    dp = world // R
    shard_groups = [_group(list(range(d * R, (d + 1) * R)), world)
                    for d in range(dp)]
    dp_groups = [_group(list(range(s, world, R)), world) for s in range(R)]
    coords = {"dp": rank // R, "shard": rank % R}
    return Mesh(shape={"dp": dp, "shard": S}, device=torch.device(device),
                ranks={"dp": dp, "shard": R}, coords=coords,
                shard_group=shard_groups[coords["dp"]],
                dp_group=dp_groups[coords["shard"]], per_step=per_step)


def _group(ranks: list[int], world: int):
    import torch.distributed as dist

    # every rank makes every group, in one order
    return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)


def _on_host(group) -> bool:
    import torch.distributed as dist

    return dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (None: this rank alone) and return
    it; counted either way."""
    COLLECTIVES["all_reduce"] += 1
    if group is None:
        return t
    import torch.distributed as dist

    dist.all_reduce(t, group=group)
    return t


def broadcast(a: np.ndarray, device) -> np.ndarray:
    """Rank 0's ``a`` on every rank of the group (every rank passes an
    array of the shape and dtype rank 0 sends)."""
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(a))
    if not _on_host(None):
        t = t.to(device)
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """The concatenation, in rank order, of every rank's ``t`` over
    ``group`` (None: ``t``), on ``t``'s device; bool through uint8."""
    if group is None:
        return t
    import torch.distributed as dist

    COLLECTIVES["gather"] += 1
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    src = src.cpu() if _on_host(group) else src.contiguous()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts).to(t.device)
    return out.bool() if t.dtype == torch.bool else out


def host_local_queries(mesh: Mesh, codes, lengths):
    """Per-rank ingest: this rank's batch slice → its dp rows.  Every rank
    contributes ``codes [B_local, K]`` and ``lengths [B_local]``; the
    global batch is their concatenation in rank order (B_local equal on
    every rank), so a dp row is that of its shard subgroup's ranks.  →
    (codes, lengths) int32 tensors on the mesh's device."""
    c = torch.as_tensor(np.ascontiguousarray(codes, dtype=np.int32))
    ln = torch.as_tensor(np.ascontiguousarray(lengths, dtype=np.int32))
    c, ln = c.to(mesh.device), ln.to(mesh.device)
    if int(mesh.ranks["shard"]) == 1:
        return c, ln
    return (_gather(c, mesh.shard_group).contiguous(),
            _gather(ln, mesh.shard_group).contiguous())


def gather_results(tree: dict, mesh: Mesh) -> dict:
    """Egress: every dp row's outputs on this rank as NumPy, the global
    batch in dp order (an all-gather over the ranks of this rank's shard
    coordinate; every rank of the group calls it)."""
    out = {}
    for k, v in tree.items():
        g = v if int(mesh.ranks["dp"]) == 1 else _gather(v, mesh.dp_group)
        out[k] = g.cpu().numpy()
    return out


def gather_shards(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The concatenation along dim 0, in rank order, of every rank's ``t``
    over this rank's shard group (``t`` itself on a mesh whose shard axis
    has one rank): the doc-sharded program's per-shard hit sets, stacked
    shard-major as the JAX program's output is."""
    if int(mesh.ranks["shard"]) == 1:
        return t
    return _gather(t.contiguous(), mesh.shard_group)


def local_slice(tree: dict, nq: int | None = None) -> dict:
    """This rank's rows of each output as NumPy, the first ``nq`` when
    given (the production egress: a rank answers only its dp rows)."""
    return {k: (v.cpu().numpy()[:nq] if nq is not None else v.cpu().numpy())
            for k, v in tree.items()}
