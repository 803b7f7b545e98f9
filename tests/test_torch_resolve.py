"""Port's resolve (ops/resolve.py) against the JAX package's on the same
PackedIndex: every walk on every row, resolve_intervals with and without a
row budget, the exact per-sample histogram through every walk (capped, and
with int64 totals), the capped histogram, the bit-rank helpers, the slow
walk's hooks, and hit sets against the naive scan.  Every output is an
integer, so every comparison is exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from readserver_tpu.corpus import simulate as jax_simulate
from readserver_tpu.index import build_index
from readserver_tpu.ops import DeviceIndex as JaxDeviceIndex
from readserver_tpu.ops import backward_search as jax_backward_search
from readserver_tpu.ops import encode_query_batch
from readserver_tpu.ops import rank as jax_rank
from readserver_tpu.ops import resolve as jax_resolve
from readserver_tpu_torch.oracle import naive_find_reads
from readserver_tpu_torch.ops import DeviceIndex
from readserver_tpu_torch.ops import rank as rank_ops
from readserver_tpu_torch.ops import resolve
from torch_common import np_of, t32

# walk name → (tier set shipped, JAX walk, port walk)
WALKS = {
    "dsa": ({"dsa"}, jax_resolve.resolve_rows_dsa, resolve.resolve_rows_dsa),
    "fused": ({"fused"}, jax_resolve.resolve_rows_fused,
              resolve.resolve_rows_fused),
    "marks": ({"marks"}, jax_resolve.resolve_rows_marked,
              resolve.resolve_rows_marked),
    "lf": ({"marks", "lf"}, jax_resolve.resolve_rows_fast,
           resolve.resolve_rows_fast),
    "slow": (set(), jax_resolve.resolve_rows, resolve.resolve_rows),
}


@pytest.fixture(scope="module")
def packed(tiny_corpus):
    return build_index(tiny_corpus.reads, sample_ids=tiny_corpus.sample_ids)


def _pair(packed, tiers):
    return (JaxDeviceIndex.from_packed(packed, tiers=tiers),
            DeviceIndex.from_packed(packed, "cpu", tiers=tiers))


@pytest.fixture(scope="module")
def cohort():
    corpus = jax_simulate.simulate_config("cohort", scale=0.004)
    assert corpus.spec.num_samples == 128
    packed = build_index(
        corpus.reads, sample_ids=corpus.sample_ids,
        sample_names=[f"s{i:03d}" for i in range(128)],
    )
    return corpus, packed


def _intervals(corpus, jdev, n, seed, miss_frac=0.2):
    k = corpus.spec.kmer_len
    kms = jax_simulate.sample_query_kmers(corpus, n, k, seed=seed,
                                          miss_frac=miss_frac)
    codes, lengths = encode_query_batch(kms, k)
    l, u = jax.jit(jax_backward_search)(jdev, codes, lengths)
    return kms, np.array(l), np.array(u)


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_of(g), np.asarray(w))


@pytest.mark.parametrize("walk", sorted(WALKS))
def test_walk_matches_jax_on_every_row(packed, walk):
    tiers, jax_walk, port_walk = WALKS[walk]
    jdev, tdev = _pair(packed, tiers)
    rows = np.arange(packed.n, dtype=np.int32)
    valid = np.random.default_rng(3).random(packed.n) > 0.1
    want = jax.jit(jax_walk)(jdev, rows, valid)
    got = port_walk(tdev, t32(rows), t32(valid).bool())
    _same(got, want)
    rid = np_of(got[0])
    assert (rid[~valid] == -1).all()
    # the slow walk gives up on the rows of the $ suffixes (a read's length
    # in steps, past max_read_len when that read is the longest)
    assert (rid[valid] >= 0).all() or walk == "slow"


def test_fused_walk_past_sample_rate_matches_jax(packed):
    """With the mark plane cleared, a walk ends only at its read's $: those
    needing fewer than sample_rate steps resolve, those needing exactly
    sample_rate steps or more come back -1 — the same in both packages."""
    jdev, tdev = _pair(packed, {"fused"})
    W = tdev.words_per_block
    fused = np.asarray(packed.fused_rows).copy()
    fused[:, 6 + 3 * W : 6 + 4 * W] = 0
    jdev = dataclasses.replace(jdev, fused_rows=jnp.asarray(fused))
    tdev = dataclasses.replace(tdev, fused_rows=t32(fused.view(np.int32)))
    rows = np.arange(packed.n, dtype=np.int32)
    valid = np.ones(packed.n, dtype=bool)
    want = jax.jit(jax_resolve.resolve_rows_fused)(jdev, rows, valid)
    got = resolve.resolve_rows_fused(tdev, t32(rows), t32(valid).bool())
    _same(got, want)
    off = np_of(got[1])
    sr = tdev.sample_rate
    assert (off == sr - 1).any() and (off == -1).any() and off.max() == sr - 1


def test_fused_walk_marked_dollar_row_matches_jax(packed):
    """A $ row that is also marked ends its walk as a marked row (its
    sampled pair), in both packages."""
    jdev, tdev = _pair(packed, {"fused"})
    W = tdev.words_per_block
    fused = np.asarray(packed.fused_rows).copy()
    fused[:, 6 + 3 * W : 6 + 4 * W] |= fused[:, 6 : 6 + W]
    jdev = dataclasses.replace(jdev, fused_rows=jnp.asarray(fused))
    tdev = dataclasses.replace(tdev, fused_rows=t32(fused.view(np.int32)))
    rows = np.arange(packed.n, dtype=np.int32)
    valid = np.ones(packed.n, dtype=bool)
    want = jax.jit(jax_resolve.resolve_rows_fused)(jdev, rows, valid)
    got = resolve.resolve_rows_fused(tdev, t32(rows), t32(valid).bool())
    _same(got, want)
    plain = resolve.resolve_rows_fused(_pair(packed, {"fused"})[1],
                                       t32(rows), t32(valid).bool())
    assert not np.array_equal(np_of(got[0]), np_of(plain[0]))


def test_dsa_word_with_bit_31_set():
    """A dsa word past 2^31 (chr20-scale read ids) decodes as uint32."""
    words = np.array([0xFFFFFFFF, 0x80000001, 0x7FFFFFFF, 5], dtype=np.uint32)
    jdev = JaxDeviceIndex(
        rank_rows=jnp.zeros((5, 4), jnp.uint32), sym4=jnp.zeros(1, jnp.uint32),
        C=jnp.zeros(6, jnp.int32), dollar_map=jnp.zeros(1, jnp.int32),
        read_to_sample=jnp.zeros(1, jnp.int32),
        read_lengths=jnp.zeros(1, jnp.int32), dsa=jnp.asarray(words),
        n=4, dsa_bits=7,
    )
    tdev = DeviceIndex.from_numpy({"dsa": words}, {"n": 4, "dsa_bits": 7},
                                  "cpu")
    rows = np.array([0, 1, 2, 3, 0], dtype=np.int32)
    valid = np.array([1, 1, 1, 1, 0], dtype=bool)
    want = jax_resolve.resolve_rows_dsa(jdev, rows, valid)
    got = resolve.resolve_rows_dsa(tdev, t32(rows), t32(valid).bool())
    _same(got, want)
    assert np_of(got[0]).tolist() == [0x1FFFFFF, 0x1000000, 0xFFFFFF, 0, -1]


@pytest.mark.parametrize(
    "tiers, use_fast, budget",
    [
        (None, None, None),            # dsa, budget ignored
        (None, None, 64),              # dsa ignores even a tight budget
        ({"fused"}, None, None),
        ({"fused"}, None, 32 * 32),    # ample budget: nothing dropped
        ({"fused"}, None, 64),         # tight budget: rows dropped
        ({"marks"}, None, 100),
        ({"marks", "lf"}, True, None),
        ({"marks", "lf"}, True, 64),
        ({"marks", "lf"}, False, None),
        (None, False, None),
    ],
)
def test_resolve_intervals_matches_jax(packed, tiny_corpus, tiers, use_fast,
                                       budget):
    jdev, tdev = _pair(packed, tiers)
    _, l, u = _intervals(tiny_corpus, jdev, 32, seed=53)
    H = 32
    want = jax.jit(
        lambda d, l, u: jax_resolve.resolve_intervals(
            d, l, u, H, use_fast=use_fast, row_budget=budget)
    )(jdev, l, u)
    got = resolve.resolve_intervals(tdev, t32(l), t32(u), H,
                                    use_fast=use_fast, row_budget=budget)
    _same(got, want)
    if budget == 64 and tdev.dsa is None:
        assert int(np_of(got[2]).sum()) == 64 < int(np.minimum(u - l, H).sum())


@pytest.mark.parametrize("tiers", [None, {"fused"}, {"marks"},
                                   {"marks", "lf"}, set()])
@pytest.mark.parametrize("window, max_rows", [
    (64, None), (256, 1 << 20), (64, 100), (1000, 1), (16, 0),
])
def test_exact_histogram_matches_jax(cohort, tiers, window, max_rows):
    corpus, packed = cohort
    jdev, tdev = _pair(packed, tiers)
    _, l, u = _intervals(corpus, jdev, 48, seed=71, miss_frac=0.1)
    l[5], u[5] = 0, 300  # a long interval, past every cap below
    want = jax.jit(
        lambda d, l, u: jax_resolve.exact_sample_histogram(
            d, l, u, window=window, max_rows=max_rows)
    )(jdev, l, u)
    got = resolve.exact_sample_histogram(tdev, t32(l), t32(u), window,
                                         max_rows)
    _same(got, want)
    hist, complete = map(np_of, got)
    # the cap binds in whole windows: min(total, ceil(max_rows/window)·window)
    total = int((u - l).sum())
    reach = total if max_rows is None else -(-max_rows // window) * window
    assert hist.shape == (48, 128) and hist.sum() == min(total, reach)
    np.testing.assert_array_equal(complete, np.cumsum(u - l) <= reach)


def test_walk_kind_names_the_walk_select_walk_takes(packed):
    """walk_kind (what K7 sweeps through on the card) follows the JAX
    package's select_walk order: dsa > lf > fused > marks > slow."""
    want = {None: "dsa", ("marks", "lf", "fused"): "lf",
            ("fused", "marks"): "fused", ("marks",): "marks", (): "slow"}
    for tiers, kind in want.items():
        tdev = DeviceIndex.from_packed(
            packed, "cpu", tiers=None if tiers is None else set(tiers))
        assert resolve.walk_kind(tdev) == kind
        rows = t32(np.arange(0, packed.n, 7))
        valid = rows >= 0
        got = resolve.select_walk(tdev)(rows, valid)
        plain = resolve.select_walk(tdev, plain=True)(rows, valid)
        _same(got, [np_of(x) for x in plain])


def test_slow_walk_hooks_match_jax(packed):
    """The slow walk's rank_fn/sym_fn hooks (the sharded path's rank) run
    in the plain form as in the JAX package."""
    jdev, tdev = _pair(packed, set())
    rows = np.arange(0, packed.n, 3, dtype=np.int32)
    valid = np.ones(rows.shape, dtype=bool)
    calls = []

    def rank_fn(c, i):
        calls.append(c.shape[0])
        return rank_ops.occ(tdev, c, i)

    want = jax_resolve.resolve_rows(
        jdev, rows, valid, max_steps=40,
        rank_fn=lambda c, i: jax_rank.occ(jdev, c, i),
        sym_fn=lambda i: jax_rank.read_symbol(jdev, i))
    got = resolve.resolve_rows(tdev, t32(rows), t32(valid).bool(),
                               max_steps=40, rank_fn=rank_fn,
                               sym_fn=lambda i: rank_ops.read_symbol(tdev, i))
    _same(got, want)
    assert len(calls) == 40


def test_walk_kernels_refuse_what_they_do_not_take(packed, monkeypatch):
    """On CUDA tensors (stood in for here: the check comes before any
    launch) the slow walk's hooks raise NotImplementedError (plain-only:
    the sharded walks have their own kernel), through the walk and through the histogram sweep, and a walk's missing
    tier or a slow walk of no steps raises ValueError; no plain form
    runs."""
    tdev = DeviceIndex.from_packed(packed, "cpu", tiers=set())
    monkeypatch.setattr(resolve, "on_cuda", lambda t: True)
    for name in ("resolve_rows_plain", "exact_sample_histogram_plain"):
        monkeypatch.setattr(resolve, name, None)
    rows = t32(np.arange(8))
    valid = rows >= 0
    with pytest.raises(NotImplementedError, match="only in the plain form"):
        resolve.resolve_rows(tdev, rows, valid, rank_fn=lambda c, i: i)
    with pytest.raises(NotImplementedError, match="only in the plain form"):
        resolve.exact_sample_histogram(tdev, rows, rows + 1, 8,
                                       sym_fn=lambda i: i)
    with pytest.raises(ValueError, match="max_steps"):
        resolve.resolve_rows(tdev, rows, valid, max_steps=0)
    with pytest.raises(ValueError, match="marks walk tier"):
        resolve.resolve_rows_marked(tdev, rows, valid)
    with pytest.raises(ValueError, match="lf walk tier"):
        resolve.resolve_rows_fast(tdev, rows, valid)


def test_exact_histogram_int64_totals(packed):
    """Summed interval counts past 2^31 must not wrap the worklist prefix
    sums: with a small cap every query reports complete=False, and the
    swept rows land in the first query's histogram."""
    jdev, tdev = _pair(packed, None)
    l = np.zeros(3, dtype=np.int32)
    u = np.full(3, 1_200_000_000, dtype=np.int32)
    want = jax.jit(
        lambda d, l, u: jax_resolve.exact_sample_histogram(
            d, l, u, window=256, max_rows=1024)
    )(jdev, l, u)
    got = resolve.exact_sample_histogram(tdev, t32(l), t32(u), 256, 1024)
    _same(got, want)
    hist, complete = map(np_of, got)
    assert not complete.any() and hist[0].sum() == 1024 and hist[1:].sum() == 0


def test_sample_histogram_matches_jax(cohort):
    corpus, packed = cohort
    jdev, tdev = _pair(packed, None)
    _, l, u = _intervals(corpus, jdev, 40, seed=9)
    rid, _, valid = jax.jit(
        lambda d, l, u: jax_resolve.resolve_intervals(d, l, u, 16))(jdev, l, u)
    want = jax_resolve.sample_histogram(jdev, rid, valid)
    got = resolve.sample_histogram(tdev, t32(np.array(rid)),
                                   t32(np.array(valid)).bool())
    np.testing.assert_array_equal(np_of(got), np.asarray(want))


def test_resolve_hits_equals_intervals_plus_sample(cohort):
    """The engine's hit step (K5's plain form with dsa) equals
    resolve_intervals plus the clipped read_to_sample gather."""
    corpus, packed = cohort
    jdev, tdev = _pair(packed, None)
    _, l, u = _intervals(corpus, jdev, 40, seed=10)
    rid, off, smp, valid = resolve.resolve_hits(tdev, t32(l), t32(u), 8)
    jrid, joff, jvalid = jax_resolve.resolve_intervals(jdev, l, u, 8)
    jv = np.asarray(jvalid)
    np.testing.assert_array_equal(np_of(valid), jv)
    np.testing.assert_array_equal(np_of(rid), np.where(jv, jrid, -1))
    np.testing.assert_array_equal(np_of(off), np.where(jv, joff, -1))
    r2s = np.asarray(packed.read_to_sample)
    np.testing.assert_array_equal(
        np_of(smp), np.where(jv, r2s[np.clip(np.asarray(jrid), 0, None)], -1))


def test_bit_rank_and_read_symbol_match_jax(packed):
    jdev, tdev = _pair(packed, {"marks"})
    rng = np.random.default_rng(4)
    S = tdev.block_size
    i = np.concatenate([rng.integers(0, packed.n, size=4096),
                        [0, 1, S - 1, S, packed.n - 1]]).astype(np.int32)
    kw = dict(log2_block=tdev.log2_block,
              words_per_block=tdev.words_per_block)
    want = jax_rank.bit_rank_and_test(jdev.mark_rank, i, **kw)
    got = rank_ops.bit_rank_and_test(tdev.mark_rank, t32(i), **kw)
    _same(got, want)
    np.testing.assert_array_equal(
        np_of(rank_ops.read_symbol(tdev, t32(i))),
        np.asarray(jax_rank.read_symbol(jdev, i)))


def test_hits_match_naive(packed, tiny_corpus):
    """Hit sets through the port's default resolve against the naive scan
    of the reads (``oracle.naive_find_reads``)."""
    jdev, tdev = _pair(packed, None)
    kms, l, u = _intervals(tiny_corpus, jdev, 32, seed=7)
    H = 64
    rid, off, valid = map(np_of, resolve.resolve_intervals(
        tdev, t32(l), t32(u), H))
    checked = 0
    for b, km in enumerate(kms):
        want = naive_find_reads(tiny_corpus.reads, km)
        if len(want) > H:
            continue
        got = sorted((int(r), int(o))
                     for r, o, v in zip(rid[b], off[b], valid[b]) if v)
        assert got == want, b
        checked += 1
    assert checked >= 24
