"""Scaling validation over every ``(dp, shard)`` factorisation of N.

Runs the full interval-sharded query program at every mesh of ``dp``
batch rows and ``shard`` index shards with ``dp * shard = N`` and the shard
count a power of two, all shards on one device and the dp rows in turn
(``parallel/mesh.make_mesh``), and asserts bit-exact answers across the
widths.  Each width runs in three forms: the one-device kernels, the
cross-rank program over this rank alone (``per_step=True``: each step's
partial and its all-reduce, as a rank of a process group runs them) on
the index as built, and the cross-rank program with the direct-resolve
tier dropped (the sampled-LF walk's collectives).  The cross-rank forms'
all-reduces, counted in ``parallel/multihost.COLLECTIVES``, must equal
``parallel/stats.query_psum_estimate`` for their route, once for each dp
row; the JAX package's compiled-HLO count has no counterpart here.

    python -m readserver_tpu_torch.bench.scaling_sim               # card
    python -m readserver_tpu_torch.bench.scaling_sim --device cpu  # host
    python -m readserver_tpu_torch.bench.scaling_sim --devices 4

One JSON line: each width's ``dp``, ``shards``, ``first_run_s`` (the
one-device form's first query call, the kernels' build included on the
card), ``parity``, ``kstep``, ``all_reduces`` (each cross-rank route's
counted all-reduces over the dp rows beside the estimate), and
``psums_per_batch``: the estimate the JAX package's module reports, of the
walk route (its arguments name no direct resolve, though the stand-in
index ships one, so that route's all-reduces are held to it); then
``devices`` and the ``device`` the run took.  Timing across factorisations
is benchmark work (``scripts/bench_scaling.py`` of the JAX package).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

# the cross-rank routes: the tiers the index drops for each
ROUTES = {"dsa": {}, "lf": dict(dsa_chunk=None, dsa_bits=0)}
KEYS = ("l", "u", "count", "read_id", "offset", "valid", "sample_hist",
        "hist_complete")


def widths(n: int) -> list[int]:
    """The shard counts of the meshes: powers of two dividing ``n``."""
    out, d = [], 1
    while d <= n:
        if n % d == 0:
            out.append(d)
        d *= 2
    return out


def run(devices: int = 8, device: str = "cuda") -> dict:
    """Every width's answers in the three forms, checked equal, and the
    cross-rank forms' all-reduces checked against the estimate → the JSON
    line's object.  Raises ``AssertionError`` on a disagreement."""
    import numpy as np
    import torch

    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.index.builder import build_index
    from readserver_tpu_torch.ops import encode_query_batch
    from readserver_tpu_torch.parallel import (
        build_prefix_lut_sharded,
        build_sharded,
        make_mesh,
        make_sharded_query_fn,
        place_sharded,
    )
    from readserver_tpu_torch.parallel import multihost as mh
    from readserver_tpu_torch.parallel.stats import query_psum_estimate

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu to run on the "
                           "host")
    corpus = simulate.simulate_config("wg", scale=2e-6)  # tiny stand-in
    packed = build_index(corpus.reads, sample_ids=corpus.sample_ids)
    k = corpus.spec.kmer_len
    kmers = simulate.sample_query_kmers(corpus, 64, k, seed=91, miss_frac=0.2)
    codes, lengths = encode_query_batch(kmers, k)
    codes_t = torch.from_numpy(codes).to(dev)
    lengths_t = torch.from_numpy(lengths).to(dev)
    kstep = (
        3 if packed.rank3_blocks is not None
        else 2 if packed.rank2_blocks is not None
        else 1
    )
    p = min(6, k)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def query(sidx, mesh):
        lut = build_prefix_lut_sharded(sidx, mesh, p)
        qfn = make_sharded_query_fn(sidx, mesh, max_hits=32, lut_p=p)
        for key in mh.COLLECTIVES:
            mh.COLLECTIVES[key] = 0
        t0 = time.perf_counter()
        out = qfn(sidx, lut, codes_t, lengths_t)
        sync()
        return ({key: out[key].cpu().numpy() for key in KEYS},
                time.perf_counter() - t0, mh.COLLECTIVES["all_reduce"])

    def same(a, b, what):
        for key in KEYS:
            assert np.array_equal(a[key], b[key]), f"{what}: {key}"

    reference = None
    results = []
    for shards in widths(devices):
        dp = devices // shards
        host = build_sharded(packed, shards)
        mesh = make_mesh(dp, shards, device=dev)
        got, first_s, reduces = query(place_sharded(host, mesh), mesh)
        assert reduces == 0, f"shards={shards}: the one-device form reduced"
        if reference is None:
            reference = got
        same(got, reference, f"shards={shards}")
        est = query_psum_estimate(
            k, lut_p=p, kstep=kstep,
            sample_rate=host.sample_rate,
            fast_resolve=host.has_fast_resolve,
            max_read_len=host.max_read_len,
        )
        all_reduces = {}
        for route, drop in ROUTES.items():
            mesh = make_mesh(dp, shards, device=dev, per_step=True)
            s = place_sharded(dataclasses.replace(host, **drop), mesh)
            got, _, reduces = query(s, mesh)
            same(got, reference, f"shards={shards} cross-rank {route}")
            want = query_psum_estimate(
                k, lut_p=p, kstep=kstep,
                sample_rate=s.sample_rate,
                fast_resolve=s.has_fast_resolve,
                max_read_len=s.max_read_len,
                direct_resolve=s.dsa_chunk is not None and s.dsa_bits > 0,
            )["total"] * dp
            assert reduces == want, (
                f"shards={shards} {route}: {reduces} all-reduces, the "
                f"estimate {want}")
            all_reduces[route] = {"counted": reduces, "estimate": want}
        assert all_reduces["lf"]["counted"] == est["total"] * dp
        results.append(dict(
            dp=dp,
            shards=shards,
            first_run_s=round(first_s, 2),
            parity="exact",
            kstep=kstep,
            all_reduces=all_reduces,
            psums_per_batch=est,
        ))
        print(
            f"# mesh(dp={dp}, shard={shards}): parity exact in 3 forms; "
            f"kstep={kstep} psums/batch={est['total']} (search "
            f"{est['search']} + resolve {est['resolve']}); all-reduces "
            + ", ".join(f"{r} {a['counted']} = {a['estimate']}"
                        for r, a in all_reduces.items()),
            file=sys.stderr,
        )
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {"scaling_sim": results, "devices": devices, "device": name}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="N: the meshes are the factorisations of N")
    ap.add_argument("--device", default="cuda",
                    help="the device every shard lives on (cuda or cpu)")
    args = ap.parse_args(argv)
    if args.devices < 1:
        ap.error("--devices must be >= 1")
    print(json.dumps(run(args.devices, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
