"""The port's interval sharding (``readserver_tpu_torch.parallel``, every
shard on one device) against the JAX package's sharded program on the
8 simulated CPU devices of ``tests/conftest.py``.

Every test of ``tests/test_sharded.py`` has its counterpart here at dp = 1:
where the JAX test runs dp = 2, the port runs dp = 1 on the same queries.
Inputs are made from seeds with numpy; every answer (``l, u, count,
read_id, offset, valid, sample_hist, hist_complete``) must equal the JAX
program's bit for bit, dtypes included (tolerance 0: all are integers).
On the CPU the port runs the plain torch forms of its kernels
(``ops/sharded.py``); the kernels themselves are held against those forms
on the card (``tests/test_torch_kernels.py``).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from readserver_tpu import cli as jax_cli
from readserver_tpu.config import ServeConfig as JaxServeConfig
from readserver_tpu.corpus import simulate as jax_simulate
from readserver_tpu.corpus.simulate import sample_query_kmers
from readserver_tpu.index.builder import build_index
from readserver_tpu.ops import DeviceIndex, backward_search, encode_query_batch
from readserver_tpu.ops import build_prefix_lut
from readserver_tpu.ops import resolve as jax_resolve
from readserver_tpu.oracle import OracleFMIndex
from readserver_tpu import parallel as jp
from readserver_tpu.parallel.sharded import _ShardLocal, sharding_specs
from readserver_tpu.serve import QueryEngine as JaxQueryEngine
from readserver_tpu_torch import cli
from readserver_tpu_torch import parallel as tp
from readserver_tpu_torch.config import ServeConfig
from readserver_tpu_torch.ops import sharded as sops
from readserver_tpu_torch.ops.search import canonical_empty, run_kstep
from readserver_tpu_torch.parallel.stats import query_psum_estimate
from readserver_tpu_torch.serve import QueryEngine
from torch_common import thaw_heap  # noqa: F401 (autouse)

MAX_HITS = 32
KEYS = ("l", "u", "count", "read_id", "offset", "valid", "sample_hist",
        "hist_complete")


@pytest.fixture(scope="module")
def packed(tiny_corpus):
    return build_index(tiny_corpus.reads, sample_ids=tiny_corpus.sample_ids)


@pytest.fixture(scope="module")
def fm(tiny_corpus):
    return OracleFMIndex(tiny_corpus.reads)


def jax_mesh(dp, shards):
    return jp.make_mesh(data_parallel=dp, num_shards=shards,
                        devices=jax.devices()[: dp * shards])


def jax_sidx(packed, dp, shards):
    mesh = jax_mesh(dp, shards)
    return mesh, jp.place_sharded(jp.build_sharded(packed, shards), mesh)


def port_sidx(packed, shards):
    mesh = tp.make_mesh(num_shards=shards, device="cpu")
    return mesh, tp.place_sharded(tp.build_sharded(packed, shards), mesh)


def jax_run(packed, dp, shards, codes, lengths, lut=None, sidx=None, **kw):
    mesh, s = jax_sidx(packed, dp, shards)
    s = sidx(s) if sidx else s
    fn = jp.make_sharded_query_fn(s, mesh, max_hits=MAX_HITS, **kw)
    return {k: np.asarray(v) for k, v in fn(s, lut, codes, lengths).items()}


def port_run(packed, shards, codes, lengths, lut=None, sidx=None, **kw):
    mesh, s = port_sidx(packed, shards)
    s = sidx(s) if sidx else s
    fn = tp.make_sharded_query_fn(s, mesh, max_hits=MAX_HITS, **kw)
    lut = None if lut is None else torch.from_numpy(np.array(lut))
    out = fn(s, lut, torch.from_numpy(codes), torch.from_numpy(lengths))
    return {k: v.numpy() for k, v in out.items()}


def assert_same(got, want, keys=KEYS):
    for k in keys:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def queries(corpus, n, seed, miss_frac=0.2):
    k = corpus.spec.kmer_len
    kmers = sample_query_kmers(corpus, n, k, seed=seed, miss_frac=miss_frac)
    codes, lengths = encode_query_batch(kmers, k)
    return kmers, codes, lengths


def check_oracle(out, kmers, fm):
    for b, km in enumerate(kmers):
        ol, ou = fm.backward_search(km)
        assert (out["l"][b], out["u"][b]) == (ol, ou), f"query {b}"
        want = sorted(fm.resolve_row(r) for r in range(ol, ou))
        if len(want) > MAX_HITS:
            continue
        got = sorted(
            (int(r), int(o))
            for r, o, v in zip(out["read_id"][b], out["offset"][b],
                               out["valid"][b])
            if v
        )
        assert got == want, f"query {b}"


# ------------------------------------------------- test_sharded.py, at dp 1


@pytest.mark.parametrize("dp,shards", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_sharded_matches_oracle(packed, fm, tiny_corpus, dp, shards):
    kmers, codes, lengths = queries(tiny_corpus, 32, seed=21)
    got = port_run(packed, shards, codes, lengths)
    assert_same(got, jax_run(packed, dp, shards, codes, lengths))
    check_oracle(got, kmers, fm)


def test_sharded_matches_single_device(packed, tiny_corpus):
    _, codes, lengths = queries(tiny_corpus, 64, seed=22, miss_frac=0.25)
    sl, su = jax.jit(backward_search)(DeviceIndex.from_packed(packed), codes,
                                      lengths)
    got = port_run(packed, 4, codes, lengths)
    assert np.array_equal(got["l"], np.asarray(sl))
    assert np.array_equal(got["u"], np.asarray(su))
    assert got["l"].dtype == np.int64


def test_sample_attribution_sharded(packed, fm, tiny_corpus):
    kmers, codes, lengths = queries(tiny_corpus, 16, seed=23)
    got = port_run(packed, 4, codes, lengths)
    assert_same(got, jax_run(packed, 2, 4, codes, lengths))
    sample_of = tiny_corpus.sample_ids
    for b, km in enumerate(kmers):
        ol, ou = fm.backward_search(km)
        if ou - ol > MAX_HITS:
            continue
        want = np.zeros(got["sample_hist"].shape[1], dtype=np.int64)
        for r in range(ol, ou):
            rid, _ = fm.resolve_row(r)
            want[sample_of[rid]] += 1
        assert np.array_equal(got["sample_hist"][b], want), f"query {b}"


def test_shard_boundaries_block_aligned(packed):
    sidx = tp.build_sharded(packed, 8)
    assert np.all(sidx.starts % sidx.block_size == 0)
    assert sidx.lens.sum() == packed.n
    assert np.all(sidx.lens >= 0)


def test_sharded_lut_path(packed, fm, tiny_corpus):
    """LUT-started sharded search == plain sharded search == oracle, and
    the port's sharded LUT is the JAX one, as integers."""
    kmers, codes, lengths = queries(tiny_corpus, 32, seed=24)
    p = 5
    jmesh, js = jax_sidx(packed, 2, 4)
    jlut = np.asarray(jp.build_prefix_lut_sharded(js, jmesh, p))
    mesh, s = port_sidx(packed, 4)
    lut = tp.build_prefix_lut_sharded(s, mesh, p)
    assert lut.dtype == torch.int64 and np.array_equal(lut.numpy(), jlut)
    got_l = port_run(packed, 4, codes, lengths, lut=jlut, lut_p=p)
    got_p = port_run(packed, 4, codes, lengths)
    assert_same(got_l, got_p)
    assert_same(got_l, jax_run(packed, 2, 4, codes, lengths, lut=jlut,
                               lut_p=p))
    for b, km in enumerate(kmers):
        assert (int(got_l["l"][b]), int(got_l["u"][b])) == fm.backward_search(km)


def test_sharded_fast_resolve_used(packed):
    sidx = tp.build_sharded(packed, 8)
    assert sidx.has_fast_resolve
    assert sidx.slens.sum() == (np.asarray(packed.lf) < 0).sum()


def test_sharded_dsa_vs_lf_walk_parity(packed, tiny_corpus):
    """The dsa resolve equals the sampled-LF walk under sharding, and each
    equals the JAX program on its route."""
    _, codes, lengths = queries(tiny_corpus, 32, seed=63)
    no_dsa = lambda s: dataclasses.replace(s, dsa_chunk=None, dsa_bits=0)  # noqa: E731
    _, s = port_sidx(packed, 4)
    assert sops.walk_kind(s) == "dsa" and sops.walk_kind(no_dsa(s)) == "lf"
    a = port_run(packed, 4, codes, lengths)
    b = port_run(packed, 4, codes, lengths, sidx=no_dsa)
    assert_same(a, b)
    assert_same(b, jax_run(packed, 2, 4, codes, lengths, sidx=no_dsa))


def test_sharded_slow_walk_still_works(tiny_corpus, fm):
    packed_slow = build_index(tiny_corpus.reads,
                              sample_ids=tiny_corpus.sample_ids,
                              fast_resolve=False)
    kmers, codes, lengths = queries(tiny_corpus, 16, seed=25)
    _, s = port_sidx(packed_slow, 4)
    assert sops.walk_kind(s) == "slow"
    got = port_run(packed_slow, 4, codes, lengths)
    assert_same(got, jax_run(packed_slow, 2, 4, codes, lengths))
    check_oracle(got, kmers, fm)


def test_dollar_chunks_cover_all_reads(packed):
    sidx = tp.build_sharded(packed, 8)
    assert sidx.dlens.sum() == packed.num_reads
    got = np.concatenate(
        [sidx.dollar_chunk[s, : sidx.dlens[s]] for s in range(8)]
    )
    assert np.array_equal(got, np.asarray(packed.dollar_map, dtype=np.int32))


def test_sharded_kstep_matches_onestep_and_oracle(packed, fm, tiny_corpus):
    """Pair/triple-plane sharded search == 1-step == oracle, with and
    without the LUT and with early exit; each variant equals the JAX one."""
    kmers, codes, lengths = queries(tiny_corpus, 48, seed=31, miss_frac=0.3)
    p = 4
    _, s = port_sidx(packed, 4)
    assert s.rank2_rows is not None and s.rank3_rows is not None
    jmesh, js = jax_sidx(packed, 2, 4)
    lut = np.asarray(jp.build_prefix_lut_sharded(js, jmesh, p))
    variants = {
        "k1": (dict(kstep=1), None),
        "k3": (dict(), None),
        "k3_lut": (dict(lut_p=p), lut),
        "k3_ee": (dict(early_exit=True), None),
        "k2": (dict(kstep=2), None),
    }
    ref = None
    for name, (kw, lt) in variants.items():
        got = port_run(packed, 4, codes, lengths, lut=lt, **kw)
        assert_same(got, jax_run(packed, 2, 4, codes, lengths, lut=lt, **kw))
        ref = got if ref is None else ref
        assert_same(got, ref, ("l", "u", "count", "read_id", "offset",
                               "valid"))
    for b, km in enumerate(kmers):
        assert (int(ref["l"][b]), int(ref["u"][b])) == fm.backward_search(km)


def test_pinned_collective_budget():
    """The JAX program's pinned psum schedule, from the port's copy of
    ``parallel/stats.py`` (the numbers ``/info`` reports)."""
    e = query_psum_estimate(31, lut_p=6, kstep=3, sample_rate=32,
                            fast_resolve=True)
    assert (e["search"], e["resolve"], e["total"]) == (9, 35, 44)
    e16 = query_psum_estimate(31, lut_p=6, kstep=3, sample_rate=16,
                              fast_resolve=True)
    assert e16["resolve"] == 19
    e2 = query_psum_estimate(31, lut_p=6, kstep=2, sample_rate=16,
                             fast_resolve=True)
    assert e2["search"] == 13
    ed = query_psum_estimate(31, lut_p=6, kstep=3, direct_resolve=True)
    assert ed["resolve"] == 2 and ed["total"] == 11


def test_sharded_kstep_collective_accounting(packed, tiny_corpus):
    """The analytic estimate drops with tier depth.  The HLO count
    (``collective_stats``) has no counterpart on one device, where the
    shard sums run inside the kernels; the k-step program's answers are
    the JAX one's."""
    k = tiny_corpus.spec.kmer_len
    e1 = query_psum_estimate(k, kstep=1, sample_rate=packed.sample_rate,
                             fast_resolve=True)
    e3 = query_psum_estimate(k, kstep=3, sample_rate=packed.sample_rate,
                             fast_resolve=True)
    assert e3["search"] < e1["search"]
    assert e3["search"] <= -(-(k - 1) // 3) + 1
    kmers = sample_query_kmers(tiny_corpus, 16, k, seed=33)
    codes, lengths = encode_query_batch(kmers, k)
    assert_same(port_run(packed, 4, codes, lengths),
                jax_run(packed, 2, 4, codes, lengths))


@pytest.mark.parametrize("dp,shards", [(2, 4), (1, 8)])
def test_sharded_resolve_budget_and_walk_exit(packed, fm, tiny_corpus, dp,
                                              shards):
    """A resolve budget that does not bind changes no answer; one that
    binds drops lanes (incomplete, never wrong) exactly as the JAX program
    does at dp = 1."""
    _, codes, lengths = queries(tiny_corpus, 32, seed=77)
    B = 32
    ref = port_run(packed, shards, codes, lengths)
    assert_same(ref, jax_run(packed, dp, shards, codes, lengths))
    total_valid = int(ref["valid"].sum())
    gen = dict(resolve_budget=B * MAX_HITS - 1, walk_early_exit=True)
    assert total_valid < B * MAX_HITS - 1
    assert_same(port_run(packed, shards, codes, lengths, **gen), ref)
    tight = dict(resolve_budget=max(total_valid // 2, 1), walk_early_exit=True)
    t = port_run(packed, shards, codes, lengths, **tight)
    assert_same(t, jax_run(packed, 1, shards, codes, lengths, **tight))
    assert np.array_equal(t["l"], ref["l"]) and np.array_equal(t["u"], ref["u"])
    assert 0 < int(t["valid"].sum()) < total_valid
    for b in range(B):
        for r, o, v in zip(t["read_id"][b], t["offset"][b], t["valid"][b]):
            if v:
                assert (int(r), int(o)) in {
                    fm.resolve_row(x) for x in range(ref["l"][b], ref["u"][b])
                }
        if t["hist_complete"][b]:
            assert np.array_equal(t["sample_hist"][b], ref["sample_hist"][b])
    assert not t["hist_complete"].all()


@pytest.mark.parametrize("dp,shards", [(1, 8), (2, 4)])
def test_owner_routed_rank_parity(packed, fm, tiny_corpus, dp, shards):
    """``owner_route`` and an undersized ``route_capacity`` change no
    answer; K9's plain form equals the JAX clamped and routed ranks
    (capacity 8, so the JAX while_loop runs several rounds)."""
    kmers, codes, lengths = queries(tiny_corpus, 32, seed=91, miss_frac=0.25)
    ref = port_run(packed, shards, codes, lengths)
    assert_same(ref, jax_run(packed, dp, shards, codes, lengths,
                             owner_route=True))
    for kw in (dict(owner_route=True), dict(owner_route=True,
                                            route_capacity=8)):
        assert_same(port_run(packed, shards, codes, lengths, **kw), ref)
        assert_same(port_run(packed, shards, codes, lengths, kstep=1, **kw),
                    ref)
    rng = np.random.default_rng(5)
    X = 96
    cc = rng.integers(0, 5, size=X).astype(np.int32)
    ii = rng.integers(0, packed.n + 1, size=X).astype(np.int64)
    a, b = _jax_ranks(packed, dp, shards, cc, ii)
    _, s = port_sidx(packed, shards)
    got = sops.occ(s, "rank", torch.from_numpy(cc), torch.from_numpy(ii))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), a) and np.array_equal(a, b)
    for b_, km in enumerate(kmers):
        assert (int(ref["l"][b_]), int(ref["u"][b_])) == fm.backward_search(km)


def _jax_ranks(packed, dp, shards, cc, ii, table="rank_rows"):
    """The JAX ``occ_global`` and ``occ_global_routed`` (capacity 8) of the
    base table, or ``occ_plane_global`` of a plane table twice."""
    from functools import partial

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    mesh, sidx = jax_sidx(packed, dp, shards)

    def both(sidx, c, i, table):
        loc = _ShardLocal(sidx)
        if table == "rank_rows":
            return loc.occ_global(c, i), loc.occ_global_routed(
                loc.rank_rows, loc.sym_totals, sidx.rows_per_symbol, c, i, 8)
        if table == "mark_table":
            r = loc.mark_rank_global(i)
            return r, r
        r = loc.occ_plane_global(getattr(loc, table), c, i)
        return r, r

    a, b = jax.jit(jax.shard_map(
        partial(both, table=table), mesh=mesh,
        in_specs=(sharding_specs(sidx), P(), P()), out_specs=(P(), P()),
    ))(sidx, jnp.asarray(cc), jnp.asarray(ii))
    return np.asarray(a), np.asarray(b)


# ------------------------------------------------------------ host build


@pytest.fixture(scope="module")
def six_reads(tiny_corpus):
    """6 reads (n = 306): at S = 8 shards 5-7 are empty and start at an
    unaligned n, and shard 4 is the partial last block."""
    return build_index(tiny_corpus.reads[:6],
                       sample_ids=tiny_corpus.sample_ids[:6])


@pytest.mark.parametrize("case,shards", [("tiny", 1), ("tiny", 2),
                                         ("tiny", 4), ("tiny", 8),
                                         ("six reads", 8)])
def test_build_sharded_matches_jax_field_by_field(packed, six_reads, case,
                                                  shards):
    pk = packed if case == "tiny" else six_reads
    want = jp.build_sharded(pk, shards)
    got = tp.build_sharded(pk, shards)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if w is None or isinstance(w, int):
            assert g == w, f.name
            continue
        w, g = np.asarray(w), np.asarray(g)
        assert g.dtype == w.dtype and np.array_equal(g, w), f.name
    if case == "six reads":
        assert (got.lens == 0).sum() == 3


def test_place_sharded_prefixes(packed):
    host = tp.build_sharded(packed, 4)
    s = tp.place_sharded(host, tp.make_mesh(num_shards=4, device="cpu"))
    assert s.rank_rows.dtype == torch.int32 and s.starts.dtype == torch.int64
    assert np.array_equal(s.rank_rows.numpy().view(np.uint32), host.rank_rows)
    for pre, tot in (("sym_prefix", "sym_totals"), ("prefix2", "totals2"),
                     ("prefix3", "totals3"), ("mark_prefix", "slens")):
        p, t = getattr(s, pre).numpy(), getattr(host, tot)
        assert p.shape[0] == 5 and not p[0].any()
        assert np.array_equal(np.diff(p, axis=0), t), pre
    with pytest.raises(ValueError, match="shards"):
        tp.place_sharded(host, tp.make_mesh(num_shards=2, device="cpu"))


@pytest.mark.parametrize("table", ["rank_rows", "rank2_rows", "rank3_rows",
                                   "mark_table"])
def test_k9_edges_match_jax(six_reads, table):
    """K9's plain form at an empty shard, at i = 0, at shard starts, at
    i = n and past it equals the JAX clamped rank (S = 8, 3 shards
    empty)."""
    n = six_reads.n
    s = tp.build_sharded(six_reads, 8)
    P = {"rank_rows": 5, "rank2_rows": 16, "rank3_rows": 64,
         "mark_table": 1}[table]
    rng = np.random.default_rng(8)
    ii = np.concatenate([[0, 1, n - 1, n, n, 0], s.starts, s.starts + 1,
                         rng.integers(0, n + 1, size=64)]).astype(np.int64)
    cc = rng.integers(0, P, size=ii.size).astype(np.int32)
    want, _ = _jax_ranks(six_reads, 1, 8, cc, ii, table)
    _, ps = port_sidx(six_reads, 8)
    name = {"rank_rows": "rank", "rank2_rows": "rank2",
            "rank3_rows": "rank3", "mark_table": "marks"}[table]
    got = sops.occ(ps, name, torch.from_numpy(cc), torch.from_numpy(ii))
    assert np.array_equal(got.numpy(), want)
    if table == "rank_rows":  # i = n gives the totals; i = 0 gives 0
        assert got[3].item() == int(six_reads.symbol_counts[cc[3]])
        assert got[0].item() == 0


@pytest.mark.parametrize("shards", [1, 3, 4])
@pytest.mark.parametrize("table", ["rank_rows", "rank2_rows", "rank3_rows",
                                   "mark_table"])
def test_k9_shard_edges_match_jax(packed, table, shards):
    """K9's plain form with i at every shard edge (start - 1, start,
    start + 1, end - 1, end, end + 1), at 0 and at n equals the JAX
    clamped rank over 1, 3 (the last shard short) and 4 shards, every
    plane of the table."""
    n = packed.n
    s = tp.build_sharded(packed, shards)
    P = {"rank_rows": 5, "rank2_rows": 16, "rank3_rows": 64,
         "mark_table": 1}[table]
    st, en = s.starts, s.starts + s.lens
    ii = np.concatenate([[0, 1, n - 1, n], st - 1, st, st + 1, en - 1, en,
                         en + 1])
    ii = np.clip(ii, 0, n).astype(np.int64)
    cc = (np.arange(ii.size) % P).astype(np.int32)
    want, _ = _jax_ranks(packed, 1, shards, cc, ii, table)
    _, ps = port_sidx(packed, shards)
    name = {"rank_rows": "rank", "rank2_rows": "rank2",
            "rank3_rows": "rank3", "mark_table": "marks"}[table]
    got = sops.occ(ps, name, torch.from_numpy(cc), torch.from_numpy(ii))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)



def test_six_reads_every_route_matches_jax(six_reads, tiny_corpus):
    """Queries over an index with empty shards, on the dsa, lf and slow
    routes, with the LUT and the exact sweep."""
    reads = tiny_corpus.reads[:6]
    rng = np.random.default_rng(4)
    kms = []
    for _ in range(24):
        r = reads[int(rng.integers(0, 6))]
        a = int(rng.integers(0, len(r) - 12))
        kms.append(r[a : a + int(rng.integers(3, 13))])
    codes, lengths = encode_query_batch(kms, 12)
    no_dsa = lambda s: dataclasses.replace(s, dsa_chunk=None, dsa_bits=0)  # noqa: E731
    slow = lambda s: dataclasses.replace(  # noqa: E731
        no_dsa(s), lf_chunk=None, sample_rate=0)
    for route, fn in (("dsa", None), ("lf", no_dsa), ("slow", slow)):
        for kw in (dict(kstep=1), dict(kstep=1, exact_hist=True),
                   dict(kstep=1, lut_p=3)):
            lut = None
            if "lut_p" in kw:
                mesh, js = jax_sidx(six_reads, 1, 8)
                lut = np.asarray(jp.build_prefix_lut_sharded(js, mesh, 3))
                keep = lengths >= 3
                c, le = codes[keep], lengths[keep]
            else:
                c, le = codes, lengths
            got = port_run(six_reads, 8, c, le, lut=lut, sidx=fn, **kw)
            assert_same(got, jax_run(six_reads, 1, 8, c, le, lut=lut,
                                     sidx=fn, **kw))
            assert int(got["valid"].sum()) > 0, route


# -------------------------------------- the k-step schedule, shard edges


SCHEDULE_K = [2, 3, 4, 7, 31, 32]
SCHEDULE_S = (1, 3, 8)


@pytest.fixture(scope="module")
def schedule_cases(packed, six_reads):
    """Per index (tiny; 6 reads, whose S = 8 leaves 3 shards empty): the
    JAX DeviceIndex with every tier, and the port's index placed in S
    shards for each S of SCHEDULE_S."""
    out = {}
    for name, pk in (("tiny", packed), ("six reads", six_reads)):
        jd = DeviceIndex.from_packed(pk)
        out[name] = (pk, jd, {S: port_sidx(pk, S)[1] for S in SCHEDULE_S})
    assert (out["six reads"][2][8].lens == 0).sum() == 3
    return out


@pytest.mark.parametrize("kstep", [1, 2, 3])
@pytest.mark.parametrize("p", ["0", "1", "K-1"])
@pytest.mark.parametrize("K", SCHEDULE_K)
def test_sharded_kstep_schedule_matches_jax(schedule_cases, tiny_corpus, K,
                                            p, kstep):
    """The sharded search from a start of p columns (0: from C, 1: the
    JAX LUT of order 1, K - 1: the (K-1)-suffix's interval as the JAX
    search gives it), then the masked scan (kstep 1) or the schedule of
    pairs (2) or triples and pairs (3), at S = 1, 3 and 8 shards (empty
    ones included), equals the JAX package's search of the whole query."""
    pp = {"0": 0, "1": 1, "K-1": K - 1}[p]
    kms = sample_query_kmers(tiny_corpus, 48, K, seed=200 + K,
                             miss_frac=0.3)
    codes, lengths = encode_query_batch(kms, K)
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    for name, (pk, jd, placed) in schedule_cases.items():
        wl, wu = (np.asarray(x) for x in jax.jit(backward_search)(
            jd, codes, lengths))
        start = None
        if pp > 1:
            sl, su = jax.jit(backward_search)(
                jd, np.ascontiguousarray(codes[:, K - pp:]),
                np.full(len(codes), pp, np.int32))
            start = (torch.from_numpy(np.array(sl)).long(),
                     torch.from_numpy(np.array(su)).long())
        for S, s in placed.items():
            if pp <= 1:
                lut = None if not pp else torch.from_numpy(
                    np.array(build_prefix_lut(jd, 1))).long()
                l, u = sops.search_plain(s, c, ln, lut, pp, kstep)
            else:
                l, u = start
                step = lambda k, *a, s=s: sops.step_plain(s, k, *a)  # noqa: E731
                if kstep == 1:
                    for j in range(K - pp - 1, -1, -1):
                        l, u = step(1, c[:, j], l, u, l < u)
                else:
                    l, u = run_kstep(c, l, u, K - pp, kstep, step)
                l, u = canonical_empty(l, u)
            assert l.dtype == torch.int64, (name, S)
            assert np.array_equal(l.numpy(), wl), (name, S)
            assert np.array_equal(u.numpy(), wu), (name, S)


@pytest.mark.parametrize("route", ["dsa", "lf", "slow"])
@pytest.mark.parametrize("case,shards", [("tiny", 3), ("tiny", 8),
                                         ("six reads", 8)])
def test_sharded_resolve_at_shard_edges_matches_jax(packed, six_reads, case,
                                                    shards, route):
    """K10's plain walks on rows at every nonempty shard's first and last
    position, one past each start, and at 0 and n - 1 (with invalid lanes
    beside them) give the JAX package's walk of the same rows on the
    monolithic index, and each hit's sample."""
    pk = packed if case == "tiny" else six_reads
    _, s = port_sidx(pk, shards)
    tiers = {"dsa": {"dsa"}, "lf": {"marks", "lf"}, "slow": set()}[route]
    if route != "dsa":
        s = dataclasses.replace(s, dsa_chunk=None, dsa_bits=0)
    if route == "slow":
        s = dataclasses.replace(s, lf_chunk=None, sample_rate=0)
    assert sops.walk_kind(s) == route
    n = s.n
    st, ln = s.starts.numpy(), s.lens.numpy()
    rows = np.unique(np.concatenate([st[ln > 0], (st + ln - 1)[ln > 0],
                                     np.minimum(st[ln > 0] + 1, n - 1),
                                     [0, n - 1]])).astype(np.int64)
    rows = np.repeat(rows, 2)
    valid = np.tile([True, False], rows.size // 2)
    rid, off, smp = sops.resolve_plain(s, torch.from_numpy(rows),
                                       torch.from_numpy(valid))
    jd = DeviceIndex.from_packed(pk, tiers=tiers)
    fn = {"dsa": jax_resolve.resolve_rows_dsa,
          "lf": jax_resolve.resolve_rows_fast,
          "slow": jax_resolve.resolve_rows}[route]
    wr, wo = (np.asarray(x) for x in jax.jit(fn)(
        jd, rows.astype(np.int32), valid))
    assert np.array_equal(rid.numpy(), wr) and np.array_equal(off.numpy(), wo)
    rts = np.asarray(pk.read_to_sample)
    want_smp = rts[np.clip(wr, 0, pk.num_reads - 1)]
    assert np.array_equal(smp.numpy(), want_smp)
    assert (wr[valid] >= 0).any()


# ------------------------------------------------------ mesh, engine, CLI


def test_make_mesh_one_device_only():
    """A mesh of one rank: every shard on its one device, the dp rows run
    in turn; several devices are a process group's
    (``parallel.multihost.make_global_mesh``)."""
    m = tp.make_mesh(num_shards=4, device="cpu")
    assert m.shape == {"dp": 1, "shard": 4} and m.device.type == "cpu"
    assert tp.make_mesh().device.type == "cuda"  # the card by default
    m = tp.make_mesh(data_parallel=2, num_shards=4, device="cpu")
    assert m.shape == {"dp": 2, "shard": 4} and m.rows_per_rank == 2
    assert m.shards_per_rank == 4 and not m.cross_rank
    with pytest.raises(ValueError, match="one device"):
        tp.make_mesh(num_shards=2, devices=["cpu", "cpu"])


def fields(results) -> list[dict]:
    """Query results as dicts: the two packages' ``QueryResult`` classes
    differ, so their instances never compare equal themselves."""
    return [dataclasses.asdict(r) for r in results]


def _kmers(corpus, n, k, seed, min_len=None):
    kms = sample_query_kmers(corpus, n, k, seed=seed, miss_frac=0.25)
    if min_len is not None:
        lens = np.random.default_rng(seed).integers(min_len, k + 1, size=n)
        kms = [km[: int(L)] for km, L in zip(kms, lens)]
    return ["".join("ACGT"[c - 1] for c in km) for km in kms]


@pytest.fixture(scope="module")
def sharded_engines(packed):
    cfg = dict(batch_size=128, small_batch_sizes=(1, 16), num_shards=4)
    jeng = JaxQueryEngine(packed, JaxServeConfig(**cfg), mesh=jax_mesh(2, 4))
    eng = QueryEngine(packed, ServeConfig(**cfg),
                      tp.make_mesh(num_shards=4, device="cpu"), device="cpu")
    return jeng, eng


@pytest.mark.parametrize("case, n, k, min_len", [
    ("one uniform", 1, 15, None),
    ("uniform", 40, 15, None),
    ("short uniform (< p)", 16, 5, None),
    ("mixed >= p", 40, 15, 9),
    ("mixed, some < p", 60, 15, 2),
])
def test_engine_matches_jax_sharded_engine(sharded_engines, tiny_corpus, case,
                                           n, k, min_len):
    """``QueryEngine(..., num_shards=4)`` on every route (k-step or 1-step,
    LUT or plain) equals the JAX sharded engine: counts, intervals, hits,
    histograms, one strand and both."""
    jeng, eng = sharded_engines
    assert eng._sharded and jeng._sharded and eng.lut_p == jeng.lut_p
    kms = _kmers(tiny_corpus, n, k, seed=len(case), min_len=min_len)
    hits = 0
    for fn, kw in (("count_batch", {}), ("query_batch", {}),
                   ("query_batch", dict(both_strands=True)),
                   ("count_batch", dict(both_strands=True))):
        got = fields(getattr(eng, fn)(kms, **kw))
        assert got == fields(getattr(jeng, fn)(kms, **kw)), (fn, kw)
        hits += sum(len(r["hits"]) for r in got)
    assert hits > 0 or n == 1  # one query may miss


def test_engine_warmup_budget_and_refusal(sharded_engines, tiny_corpus):
    jeng, eng = sharded_engines
    eng.warmup()
    assert eng.tier_plan is None and "lut" in eng.startup_seconds
    with pytest.raises(ValueError, match="exceeds"):
        eng.count_batch(["A"] * 129)
    codes = np.full((2, 4), 5, dtype=np.int32)  # not a base code
    with pytest.raises(ValueError, match="code outside"):
        eng._query_fn_1(eng.sidx, None, torch.from_numpy(codes),
                        torch.full((2,), 4, dtype=torch.int32))
    # a dp axis of 2 on one rank: each half of the batch a row, budget
    # and all, as the JAX engine's (2, 4) mesh serves it
    cfg2 = dict(batch_size=32, small_batch_sizes=(16,), num_shards=4,
                data_parallel=2)
    jeng2 = JaxQueryEngine(eng.packed, JaxServeConfig(**cfg2),
                           mesh=jax_mesh(2, 4))
    eng2 = QueryEngine(eng.packed, ServeConfig(**cfg2),
                       tp.make_mesh(data_parallel=2, num_shards=4,
                                    device="cpu"), device="cpu")
    kms2 = _kmers(tiny_corpus, 20, 11, seed=5)
    assert fields(eng2.query_batch(kms2)) == fields(jeng2.query_batch(kms2))
    one = QueryEngine(eng.packed, ServeConfig(batch_size=128),
                      tp.make_mesh(device="cpu"), device="cpu")
    assert not one._sharded  # one shard, dp 1: the single-device path
    kms = ["ACGTA", "TTGCA"]
    assert fields(one.count_batch(kms)) == fields(eng.count_batch(kms))


@pytest.fixture(scope="module")
def cohort():
    corpus = jax_simulate.simulate_config("cohort", scale=0.004)
    packed = build_index(
        corpus.reads, sample_ids=corpus.sample_ids,
        sample_names=[f"s{i:03d}" for i in range(128)],
    )
    return corpus, packed


def test_cohort_attribution_sharded_matches_jax(cohort):
    """tests/test_cohort.py's sharded attribution: 128 samples, exact
    histograms, the port's engine equal to the JAX sharded engine's."""
    corpus, packed = cohort
    cfg = dict(batch_size=32, max_hits=64, num_shards=4)
    jeng = JaxQueryEngine(packed, JaxServeConfig(**cfg), mesh=jax_mesh(2, 4))
    eng = QueryEngine(packed, ServeConfig(**cfg),
                      tp.make_mesh(num_shards=4, device="cpu"), device="cpu")
    kms = _kmers(corpus, 12, corpus.spec.kmer_len, seed=72)
    got = eng.query_batch(kms)
    assert fields(got) == fields(jeng.query_batch(kms))
    assert sum(sum(r.sample_hist.values()) for r in got) > 0


def test_exact_attribution_beyond_hit_cap_sharded():
    """tests/test_cohort.py's interval case: count >> max_hits, the hit
    list capped, the histogram exact and complete, equal to JAX's."""
    rng = np.random.default_rng(42)
    k = 11
    motif = rng.integers(1, 5, size=k).astype(np.uint8)
    reads, sample_ids = [], []
    for s in range(16):
        for _ in range(20):
            r = rng.integers(1, 5, size=60).astype(np.uint8)
            off = int(rng.integers(0, 60 - k + 1))
            r[off : off + k] = motif
            reads.append(r)
            sample_ids.append(s)
    packed = build_index(reads, sample_ids=np.asarray(sample_ids, np.int32))
    cfg = dict(batch_size=8, max_hits=8, num_shards=4)
    jeng = JaxQueryEngine(packed, JaxServeConfig(**cfg), mesh=jax_mesh(2, 4))
    eng = QueryEngine(packed, ServeConfig(**cfg),
                      tp.make_mesh(num_shards=4, device="cpu"), device="cpu")
    km = "".join("ACGT"[c - 1] for c in motif)
    (r,) = eng.query_batch([km])
    assert fields([r]) == fields(jeng.query_batch([km]))
    want = OracleFMIndex(reads).count(motif)
    assert r.count == want > 8 and r.hits_truncated
    assert r.sample_hist_complete and sum(r.sample_hist.values()) == want


def test_cli_query_shards_matches_jax_cli(tmp_path, capsys):
    """``query --shards 4 --device cpu`` answers as the JAX CLI's sharded
    query (8 shards there: its mesh spans every simulated device)."""
    out = tmp_path / "idx"
    assert cli.main(["build", "--config", "tiny", "--out", str(out)]) == 0
    kms = ["ACGTAC", "GATTACA", "TTTT", "CAGGT"]
    runs = []
    for main, extra in ((cli.main, ["--shards", "4", "--device", "cpu"]),
                        (jax_cli.main, ["--shards", "8"]),
                        (cli.main, ["--device", "cpu"])):
        capsys.readouterr()
        assert main(["query", "--index", str(out), "--kmer", *kms, "--hits",
                     "--samples", "--both-strands", *extra]) == 0
        runs.append([json.loads(x) for x in
                     capsys.readouterr().out.splitlines()])
    assert runs[0] == runs[1]
    assert [r["count"] for r in runs[0]] == [r["count"] for r in runs[2]]
