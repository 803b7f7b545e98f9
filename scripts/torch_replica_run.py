#!/usr/bin/env python
"""The port at n' = 2,090,700,000 on one card, every answer held exact.

E. coli 30x (``chip_smoke.py``'s artifact, built or loaded from ``data/``)
replicated 15-fold by ``scripts/torch_build_replica.py`` (copy j of every
read in sample j: n' = 15 n, past human chr20 30x's 1,939,200,000 and 97%
of 2^31) and served through the normal entry points, everything
``chip_smoke.py``'s phase 16 does and more:

* every single-device route, one engine at a time: dsa (K5), fused (K14,
  K6), marks, lf and slow (K14, ``rs_resolve_walk``), each with K1's level
  entry, K2, K7 and K8 on the path; counts, ``/reads`` and ``/samples``
  against the replica oracle (the E. coli engine's answers, each count 15
  times, each hit set expanded, under the engines' row budget and sweep
  cap), each kernel against its plain form on the card;
* a capped engine (``exact_attribution`` off: K14, K6, K15): hits against
  the oracle, each histogram the count of its hits by sample;
* the replica in 4 interval shards on the card (dsa and lf routes: the
  sharded search, K11, K10, K14's int64 entry), global rows near 2^31 and
  local rows int32, against the same oracle, K11's LUT equal to the
  single-device LUT;
* device times (profiler) and wrapper times (CUDA events) for K2 at
  B = 262,144 and K5, K6 and the walks at width 8192 beside their plain
  forms and bytes bounds, each engine's ship and LUT seconds, every
  path's launches.

    python3 scripts/torch_replica_run.py   # on the card, about 15 minutes

Writes its log lines (``#``) to stdout and one JSON object as the last
line (also to the file ``--out`` names, if any).  Needs one card with
about 25 GB free and about 90 GB of host memory.  Imports only the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

ALL_ROUTES = cs.REPLICA_ROUTES + (
    ("lf", ("dsa", "fused")), ("slow", ("dsa", "fused", "marks", "lf")))


def reading(fn, plain, kernel: str, nbytes: int, shape: str, card: str,
            what: str) -> dict:
    """One kernel's wrapper ms (CUDA events), device ms (profiler), plain
    ms and bytes bound at ``shape``."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms = float(np.median([cs.time_cuda(fn, 20) for _ in range(3)]))
    dev_ms = cs.kernel_device_ms(fn, 10, kernel)
    plain_ms = cs.time_cuda(plain, 3)
    bnd = cs.bound_ms(nbytes)
    cs.log(f"{what} ({shape}): wrapper {ms:.4f} ms, device "
           f"{cs.fmt_ms(dev_ms)} ms, plain {plain_ms:.4f} ms, needs "
           f"{nbytes} B: bytes bound {bnd:.4f} ms, device time at "
           f"{cs.ratio(bnd, dev_ms)} of it | {card}")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bnd,
                bytes=nbytes, shape=shape)


def time_route(rname: str, eng, bq, exp8192, card: str, out: dict) -> None:
    """The route's kernels at the main path's shapes on the replica."""
    import torch

    from readserver_tpu_torch.ops import resolve
    from readserver_tpu_torch.ops import search as search_ops

    idx, H, R = eng.index, eng.H, eng.row_budget
    out.setdefault("startup", {})[rname] = dict(eng.startup_seconds)
    l, u = cs.engine_intervals(eng, exp8192)
    rows, valid, _ = resolve.expand_intervals(l, u, H)
    if rname == "dsa":
        codes = torch.from_numpy(bq).to(idx.device)
        bad = eng._new_bad()
        nbytes, _, _ = cs.k2_needs(idx, codes, eng.lut, eng.lut_p)
        out["backward_search"] = reading(
            lambda: search_ops.backward_search_cuda(
                idx, codes, lut=eng.lut, p=eng.lut_p, kstep=True, bad=bad),
            lambda: search_ops.backward_search_pair_plain(
                idx, codes, eng.lut, eng.lut_p),
            "backward_search_kernel", nbytes,
            f"B={codes.shape[0]} 31-mers, LUT p={eng.lut_p} + "
            f"{'triples' if idx.rank3_rows is not None else 'pairs'}",
            card, "K2")
        rid = resolve.resolve_dsa_hits_plain(idx, l, u, H)[0]
        nbytes = (8192 * 8 + cs.distinct(rows[valid]) * 4
                  + cs.distinct(rid[rid >= 0]) * 4 + 3 * 8192 * H * 4)
        out["resolve_dsa"] = reading(
            lambda: resolve.resolve_dsa_hits(idx, l, u, H),
            lambda: resolve.resolve_dsa_hits_plain(idx, l, u, H),
            "resolve_dsa_kernel", nbytes,
            f"width 8192 x H={H}, {int(valid.sum())} hits", card, "K5")
        return
    crow, cval, _, _ = resolve.compact_rows(rows, valid, R)
    shape = (f"width 8192, {crow.shape[0]} compacted rows, "
             f"{int(cval.sum())} valid")
    if rname == "fused":
        wb, _ = cs.fused_walk_needs(idx, crow, cval)
        out["resolve_fused"] = reading(
            lambda: resolve.resolve_rows_fused(idx, crow, cval),
            lambda: resolve.resolve_rows_fused_plain(idx, crow, cval),
            "resolve_fused_kernel", crow.numel() * 13 + wb, shape, card,
            "K6")
        return
    walk, plain = cs.walk_forms()[rname]
    wb, _ = cs.rank_walk_needs(idx, rname, crow, cval)
    out[f"resolve_walk ({rname})"] = reading(
        lambda: walk(idx, crow, cval), lambda: plain(idx, crow, cval),
        "resolve_walk_kernel", crow.numel() * 13 + wb, shape, card,
        f"{rname} walk")


def sharded_rule(eng, budget: int):
    """The interval engine's cuts at padded width W: the row budget on
    every route, the sweep in windows of W·H."""
    H, cap = eng.H, eng.cfg.max_sweep_rows

    def rule(W: int):
        return ((budget if budget < W * H else None),
                -(-cap // (W * H)) * (W * H))
    return rule


def serve_capped(engine, rep, cfg, dev, kms: list[str]) -> int:
    """A fused engine with capped attribution (K14, K6, K15): one-strand
    ``/samples`` with hits; counts and hits equal the replica oracle, each
    histogram counts the query's hits by sample, complete iff every row of
    the interval was resolved → the queries checked."""
    from readserver_tpu_torch.kernels import KERNELS
    from readserver_tpu_torch.serve import QueryEngine

    rb = cs.replica_module()
    eng = QueryEngine(rep, dataclasses.replace(
        cfg, drop_tiers=("dsa",), exact_attribution=False), device=dev)
    eng.warmup()
    k15 = KERNELS["capped_histogram"].launches
    with cs.uncounted():
        one = engine.query_batch(kms)
    got = eng.query_batch(kms)
    W, H = eng.last_width, eng.H
    want = rb.replica_answers(one, cs.M_REPLICA, H, eng.sample_names, W,
                              eng.row_budget, None)
    names = eng.sample_names
    for g, w in zip(got, want):
        per = np.bincount([h["sample_id"] for h in w.hits],
                          minlength=len(names))
        cs.check((g.count, g.interval, g.hits, g.hits_truncated)
                 == (w.count, w.interval, w.hits, w.hits_truncated)
                 and g.sample_hist == {names[i]: int(c)
                                       for i, c in enumerate(per) if c}
                 and g.sample_hist_complete == (
                     w.count <= H and len(w.hits) == w.count),
                 f"capped replica engine: {g.kmer} differs from the oracle")
    cs.check(KERNELS["capped_histogram"].launches > k15,
             "K15 did not launch on the capped replica engine")
    cs.log(f"capped replica engine (K14, K6, K15): {len(kms)} one-strand "
           f"queries, hits equal to the oracle, histograms their hits' "
           f"samples, {sum(not g.sample_hist_complete for g in got)} "
           f"incomplete")
    return len(kms)


def serve_interval(engine, rep, cfg, dev, kms: dict, served: dict,
                   reads_served: dict, lut_single) -> dict:
    """The replica in 4 interval shards on the card, dsa and lf routes:
    counts, ``/reads`` and ``/samples`` against the replica oracle under
    the interval program's budget and sweep → the routes' launches."""
    import torch

    from readserver_tpu_torch.config import ServeConfig
    from readserver_tpu_torch.kernels import KERNELS
    from readserver_tpu_torch.parallel import make_mesh
    from readserver_tpu_torch.serve import QueryEngine

    m, H = cs.M_REPLICA, cfg.max_hits
    scfg = ServeConfig(batch_size=cfg.batch_size, num_shards=4,
                       warmup_query_lengths=cfg.warmup_query_lengths)
    budget = int(scfg.resolve_budget_frac * scfg.batch_size * H)
    drops = {"dsa": dict(lf=None, mark_rank=None, sample_pairs=None,
                         fused_rows=None),
             "lf": dict(dsa=None, dsa_bits=0, fused_rows=None)}
    launches = {}
    for route, drop in drops.items():
        for k in KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        eng = QueryEngine(dataclasses.replace(rep, **drop), scfg,
                          make_mesh(num_shards=4, device=dev), device=dev)
        eng.warmup()
        cs.log(f"interval replica engine, {route} route, 4 shards: up and "
               f"warm in {time.perf_counter() - t0:.3f}s (build_sharded "
               f"{eng.startup_seconds['build_sharded']:.3f}s, ship "
               f"{eng.startup_seconds['ship']:.3f}s, K11's LUT p="
               f"{eng.lut_p} {eng.startup_seconds['lut']:.3f}s)")
        cs.check(np.array_equal(eng.lut.cpu().numpy(),
                                lut_single.astype(np.int64)),
                 "K11's LUT differs from the single-device LUT")
        rule = sharded_rule(eng, budget)
        for name, both in (("1", False), ("256", False), ("4096x2", True)):
            got = eng.count_batch(kms[name], both_strands=both)
            cs.check([r.count for r in got]
                     == [m * int(c) for c in served[name]],
                     f"interval replica counts of {name} are not m x E. "
                     "coli's")
        top = max(r.interval[1] for r in got)
        for name, both in (("256", False), ("4096x2", True)):
            cut, capped, nh, dt = cs.replica_reads(
                engine, eng, route, rule, m, kms[name], both, True,
                reads_served[name])
            cs.log(f"interval replica {route} /reads of {name}: "
                   f"{dt * 1e3:.3f} ms, {nh} hits, {cut} cut by the budget, "
                   f"{capped} histograms cut: equal to the replica oracle")
        cut, capped, _, dt = cs.replica_reads(
            engine, eng, route, rule, m, kms["256"], True, False)
        cs.log(f"interval replica {route} /samples of 256 x 2: "
               f"{dt * 1e3:.3f} ms, equal to the replica oracle")
        launches[route] = {n: k.launches for n, k in KERNELS.items()}
        cs.log(f"interval {route} launches: {launches[route]}; global rows "
               f"up to {top}")
        for kname in ("sharded_search", "sharded_lut_level",
                      "sharded_resolve", "row_compact", "row_gather"):
            cs.check(launches[route][kname] > 0,
                     f"{kname} did not launch on the interval replica")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="E. coli genome fraction of the source")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on the card only",
              file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    from readserver_tpu_torch.config import ServeConfig
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.index import artifact, build_index
    from readserver_tpu_torch.kernels import KERNELS, LIBRARY
    from readserver_tpu_torch.native import native_available
    from readserver_tpu_torch.oracle.naive import window_multiset_counts
    from readserver_tpu_torch.serve import QueryEngine

    card = cs.card_line()
    cs.log(f"card: {card}")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    LIBRARY.get()
    corpus = simulate.simulate_config("ecoli", scale=args.scale)
    packed = cs.load_or_build(
        corpus, REPO / "data" / "chip_smoke" / f"ecoli_s{args.scale:g}",
        build_index, artifact, native_available)
    cfg = ServeConfig(batch_size=8192, warmup_query_lengths=(cs.KMER,))
    engine = QueryEngine(packed, cfg, device=dev)
    engine.warmup()
    pool = simulate.sample_query_kmers_fast(
        corpus, 4096 + 256 + 1, cs.KMER, seed=args.seed, miss_frac=0.15)
    qs = (pool[:1], pool[1:257], pool[257:])
    kms = {"1": cs.decode_all(qs[0]), "256": cs.decode_all(qs[1]),
           "4096x2": cs.decode_all(qs[2])}
    served, reads_served = {}, {}
    for name, both in (("1", False), ("256", False), ("4096x2", True)):
        served[name] = np.array(
            [r.count for r in engine.count_batch(kms[name],
                                                 both_strands=both)])
        reads_served[name] = engine.query_batch(kms[name], both_strands=both)
    # the source answers against the read windows (chip_smoke's phase 5)
    want = window_multiset_counts(np.stack(corpus.reads), qs[1])
    cs.check(np.array_equal(served["256"], want),
             "the E. coli engine's counts differ from the windows")
    cs.log("E. coli engine: 256 counts exact against the read windows")

    rep, built = cs.build_replica(args, packed)
    path = {}

    def zero():
        for k in KERNELS.values():
            k.launches = 0

    def read_launches(name):
        path[name] = {n: k.launches for n, k in KERNELS.items()}
        cs.log(f"launches during the {name} path: {path[name]}")
        return path[name]

    times: dict = {}
    bq = cs.simulate_bq(corpus, args.seed)
    exp8192 = cs.rb_expand(kms["4096x2"], True)[0]
    lut_single = {}

    def on_engine(rname, eng):
        if rname == "dsa":
            lut_single["lut"] = eng.lut.cpu().numpy()
        time_route(rname, eng, bq, exp8192, card, times)

    res = cs.serve_replica(args, corpus, engine, rep, cfg, dev, qs, served,
                           reads_served, zero, read_launches,
                           routes=ALL_ROUTES, on_engine=on_engine)
    zero()
    n_capped = serve_capped(engine, rep, cfg, dev, kms["4096x2"])
    path["capped"] = {n: k.launches for n, k in KERNELS.items()}
    interval = serve_interval(engine, rep, cfg, dev, kms, served,
                              reads_served, lut_single["lut"])
    out = dict(
        card=card, n=rep.n, m=cs.M_REPLICA, reads=rep.num_reads,
        samples=rep.num_samples, build=built,
        seconds=time.perf_counter() - t_all,
        max_abs_err=res["errs"], launches=path, interval_launches=interval,
        capped_queries=n_capped, kernels=times)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    cs.log(f"every route, the capped and the interval engines equal to the "
           f"replica oracle in {out['seconds']:.3f}s")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
