"""The port's CUDA kernels against their plain torch forms, on the card.

This file imports no jax, so it also runs where jax is absent (the card's
machine), without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Every test but two needs a CUDA card and skips without one; the CPU parity
of the plain forms with the JAX package is in
test_torch_{rank,search,lut,resolve,compact,pack}.py.
"""

import contextlib
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from readserver_tpu_torch.config import ServeConfig
from readserver_tpu_torch.corpus import simulate
from readserver_tpu_torch.index import build_index
from readserver_tpu_torch.index.cohort import build_cohort, load_cohort
from readserver_tpu_torch.kernels import (
    BACKWARD_SEARCH,
    CAPPED_HISTOGRAM,
    EXACT_HISTOGRAM,
    LUT_LEVEL,
    MERGE_PACK,
    RANK_OCC,
    RESOLVE_DSA,
    RESOLVE_FUSED,
    RESOLVE_WALK,
    ROW_COMPACT,
    ROW_GATHER,
    SHARD_LOOKUP_PARTIAL,
    SHARD_OCC,
    SHARD_OCC_PARTIAL,
    SHARDED_LUT_LEVEL,
    SHARDED_LUT_LEVEL_PARTIAL,
    SHARDED_RESOLVE,
    SHARDED_SEARCH,
    SPARSE_PACK,
    WALK_LF_STEP,
    WALK_SLOW_STEP,
)
from readserver_tpu_torch.kernels import KERNELS
from readserver_tpu_torch.kernels import build as kbuild
from readserver_tpu_torch.ops import (
    DeviceIndex,
    backward_search,
    backward_search_lut,
    backward_search_pair,
    build_prefix_lut,
    encode_query_batch,
)
from readserver_tpu_torch.ops import lut as lut_ops
from readserver_tpu_torch.ops import pack as pack_ops
from readserver_tpu_torch.ops import rank as rank_ops
from readserver_tpu_torch.ops import resolve
from readserver_tpu_torch.ops import search as search_ops
from readserver_tpu_torch.ops import sharded as sops
from readserver_tpu_torch import parallel as shard_par
from readserver_tpu_torch.parallel import sharded as psh
from readserver_tpu_torch.serve import MultiEngine, QueryEngine
from readserver_tpu_torch.serve.engine import _copy_out
from torch_common import cuda_device, t32  # noqa: F401

P = 5
TABLES = {"base": ("rank_rows", 5), "rank2": ("rank2_rows", 16),
          "rank3": ("rank3_rows", 64)}


@pytest.fixture(scope="module")
def packed():
    corpus = simulate.simulate_config("small")
    return corpus, build_index(corpus.reads, sample_ids=corpus.sample_ids)


@pytest.fixture
def dev(packed, cuda_device):  # noqa: F811
    return DeviceIndex.from_packed(packed[1], cuda_device)


def _layout(d):
    return dict(rows_per_symbol=d.rows_per_symbol, log2_block=d.log2_block,
                words_per_block=d.words_per_block)


def _queries(corpus, n, k, seed, min_len=None):
    rng = np.random.default_rng(seed)
    kms = simulate.sample_query_kmers_fast(corpus, n, k, seed=seed,
                                           miss_frac=0.3)
    if min_len is None:
        return encode_query_batch(list(kms), k)
    lens = rng.integers(min_len, k + 1, size=n)
    return encode_query_batch([km[k - L:] for km, L in zip(kms, lens)], k)


@pytest.mark.cuda
@pytest.mark.parametrize("table", sorted(TABLES))
def test_rank_kernel_matches_plain(dev, table):
    field, planes = TABLES[table]
    rng = np.random.default_rng(planes)
    S = dev.block_size
    blocks = rng.integers(0, dev.n // S, size=1000)
    i = np.concatenate([rng.integers(0, dev.n + 1, size=100_000),
                        [0, dev.n], blocks * S, blocks * S + S - 1])
    c = rng.integers(0, planes, size=len(i))
    c_t, i_t = t32(c, dev.device), t32(i, dev.device)
    rows = getattr(dev, field)
    before = RANK_OCC.launches
    got = rank_ops.occ_rows(rows, c_t, i_t, **_layout(dev))
    want = rank_ops.occ_rows_plain(rows, c_t, i_t, **_layout(dev))
    torch.cuda.synchronize()
    assert RANK_OCC.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_lut_through_kernel_matches_plain(packed, dev):
    before = LUT_LEVEL.launches, RANK_OCC.launches
    lut = build_prefix_lut(dev, P)
    assert (LUT_LEVEL.launches, RANK_OCC.launches) == (before[0] + P - 1,
                                                       before[1])
    plain = build_prefix_lut(DeviceIndex.from_packed(packed[1], "cpu"), P)
    assert torch.equal(lut.cpu(), plain)
    before = LUT_LEVEL.launches
    on_card = lut_ops.build_prefix_lut_plain(dev, P)
    assert LUT_LEVEL.launches == before
    assert torch.equal(lut, on_card)


@pytest.mark.cuda
@pytest.mark.parametrize("p, max_chunk", [(12, 1 << 22), (8, 1000), (1, 1)])
def test_lut_level_entry_matches_plain(dev, p, max_chunk):
    """K1's level entry against the plain build: p = 12 (the E. coli
    engine's order, one launch a level) and a chunked build whose chunks
    are ragged (4^l is no multiple of 1000)."""
    before = LUT_LEVEL.launches
    got = build_prefix_lut(dev, p, max_chunk=max_chunk)
    want = lut_ops.build_prefix_lut_plain(dev, p, max_chunk=max_chunk)
    torch.cuda.synchronize()
    chunks = sum(-(-4**level // max_chunk) for level in range(1, p))
    assert LUT_LEVEL.launches == before + chunks
    assert torch.equal(got, want)
    empty = got[:, 0] >= got[:, 1]
    assert (got[empty] == 0).all()


@pytest.mark.cuda
def test_search_kernel_refuses_bad_codes(dev):
    """K2 reads no table for a query with a code outside 1..4 in a searched
    column: the wrapper raises, and the card keeps working."""
    K = 12
    ok = np.tile(np.arange(1, K + 1) % 4 + 1, (4, 1))
    lut = build_prefix_lut(dev, P)
    for col, code in ((0, 0), (K - 3, 5), (K - 1, -7)):
        bad = ok.copy()
        bad[2, col] = code
        with pytest.raises(ValueError, match="1 queries hold a code"):
            backward_search_pair(dev, t32(bad, dev.device), lut, P)
        with pytest.raises(ValueError, match="1 queries hold a code"):
            backward_search(dev, t32(bad, dev.device),
                            t32(np.full(4, K), dev.device))
    with pytest.raises(ValueError, match="2 queries hold a code"):
        backward_search(dev, t32(ok, dev.device),
                        t32([0, K, K + 1, K], dev.device))
    pad = ok.copy()
    pad[3, :K - 3] = 0
    with pytest.raises(ValueError, match="1 queries hold a code"):
        backward_search_lut(dev, lut, P, t32(pad, dev.device),
                            t32([K, K, K, 3], dev.device))
    got = backward_search_pair(dev, t32(ok, dev.device), lut, P)
    want = search_ops.backward_search_pair_plain(dev, t32(ok, dev.device),
                                                 lut, P)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("tiers", ["rank2+rank3", "rank2"])
def test_search_kernel_matches_plain(packed, dev, tiers):
    corpus, _ = packed
    d = dev if tiers == "rank2+rank3" else dataclasses.replace(
        dev, rank3_rows=None, C3=None)
    lut = build_prefix_lut(d, P)
    codes, _ = _queries(corpus, 4096, 15, seed=1)
    mixed, mixed_len = _queries(corpus, 4096, 15, seed=2, min_len=1)
    lmixed, lmixed_len = _queries(corpus, 4096, 15, seed=3, min_len=P)
    c, m, ml, lm, lml = (t32(x, d.device) for x in
                         (codes, mixed, mixed_len, lmixed, lmixed_len))
    before = BACKWARD_SEARCH.launches
    cases = [
        (backward_search_pair(d, c, lut, P),
         search_ops.backward_search_pair_plain(d, c, lut, P)),
        (backward_search_pair(d, c),
         search_ops.backward_search_pair_plain(d, c)),
        (backward_search(d, m, ml),
         search_ops.backward_search_plain(d, m, ml)),
        (backward_search_lut(d, lut, P, lm, lml),
         search_ops.backward_search_lut_plain(d, lut, P, lm, lml)),
    ]
    torch.cuda.synchronize()
    assert BACKWARD_SEARCH.launches == before + len(cases)
    for (l1, u1), (l2, u2) in cases:
        assert torch.equal(l1, l2) and torch.equal(u1, u2)


def _unaligned(x: np.ndarray, device) -> torch.Tensor:
    """``x`` on the card as a contiguous view that starts 4 bytes past a
    16-byte boundary of its storage."""
    flat = torch.zeros(x.size + 4, dtype=torch.int32, device=device)
    flat[1 : 1 + x.size] = t32(x.reshape(-1), device)
    view = flat[1 : 1 + x.size].view(x.shape)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("tiers", ["rank2+rank3", "rank2"])
@pytest.mark.parametrize("K", [1, 12, 31, 32])
def test_search_kernel_widths_and_edges(packed, dev, tiers, K):
    """K2 against the plain forms at widths K of 1, 12, 31 and 32, with a
    batch of 1001 queries (no multiple of the 32-query block, so the last
    block holds 9) in an unaligned view, in both modes and both tier sets;
    padding columns outside the searched range hold codes the guard would
    refuse if it read them."""
    corpus, _ = packed
    d = dev if tiers == "rank2+rank3" else dataclasses.replace(
        dev, rank3_rows=None, C3=None)
    p = min(P, K)
    lut = build_prefix_lut(d, p)
    B = 1001
    codes, _ = _queries(corpus, B, K, seed=K)
    mixed, mixed_len = _queries(corpus, B, K, seed=K + 1, min_len=1)
    lmixed, lmixed_len = _queries(corpus, B, K, seed=K + 2, min_len=p)
    dirty = mixed.copy()
    pad = np.arange(K)[None, :] < (K - mixed_len)[:, None]
    dirty[pad] = 7
    ml = t32(mixed_len, d.device)
    lml = t32(lmixed_len, d.device)
    c = t32(codes, d.device)
    k2 = search_ops.backward_search_cuda
    want = {
        "k-step": search_ops.backward_search_pair_plain(d, c),
        "k-step + LUT": search_ops.backward_search_pair_plain(d, c, lut, p),
        "1-step": search_ops.backward_search_plain(
            d, t32(mixed, d.device), ml),
        "1-step + LUT": search_ops.backward_search_lut_plain(
            d, lut, p, t32(lmixed, d.device), lml),
    }
    got = {
        "k-step": k2(d, _unaligned(codes, d.device), kstep=True),
        "k-step + LUT": k2(d, _unaligned(codes, d.device), lut=lut, p=p,
                           kstep=True),
        "1-step": k2(d, _unaligned(dirty, d.device), ml),
        "1-step + LUT": k2(d, _unaligned(lmixed, d.device), lml, lut=lut,
                           p=p),
    }
    for name, (l1, u1) in got.items():
        l2, u2 = want[name]
        assert torch.equal(l1, l2) and torch.equal(u1, u2), name


@pytest.mark.cuda
def test_search_kernel_deferred_guard(packed, dev):
    """With a ``bad`` counter K2 returns without a wait: refused queries
    come out (0, 0) and counted, the rest as the plain form gives them."""
    corpus, _ = packed
    codes, _ = _queries(corpus, 300, 15, seed=4)
    codes[[3, 100, 299], [0, 7, 14]] = [0, 5, -2]
    bad = torch.zeros(1, dtype=torch.int32, device=dev.device)
    l, u = search_ops.backward_search_cuda(
        dev, t32(codes, dev.device), kstep=True, bad=bad)
    assert int(bad.item()) == 3
    ok = codes.copy()
    ok[[3, 100, 299]] = 1
    want = search_ops.backward_search_pair_plain(dev, t32(ok, dev.device))
    keep = torch.ones(300, dtype=torch.bool, device=dev.device)
    keep[[3, 100, 299]] = False
    assert (l[~keep] == 0).all() and (u[~keep] == 0).all()
    assert torch.equal(l[keep], want[0][keep])
    assert torch.equal(u[keep], want[1][keep])


@pytest.mark.cuda
def test_engine_raises_refused_queries_at_its_copy(packed, cuda_device,
                                                   monkeypatch):  # noqa: F811
    """The engine's search does not wait: a refused query's count rides on
    the batch's one copy, and the engine raises there."""
    _, pk = packed
    engine = QueryEngine(pk, ServeConfig(batch_size=256), device=cuda_device)
    kms = ["ACGTACGTACGTAC"] * 5
    codes, lengths, nq = engine._pad_encode(kms)
    bad = engine._new_bad()
    codes[2, -1] = 9
    out = engine._dispatch_single(codes, lengths, nq, bad=bad)
    torch.cuda.synchronize()
    assert int(bad.item()) == 1 and out.shape[0] == codes.shape[0]
    buf = engine._counted(codes, lengths, nq)
    assert buf.shape == (2 * nq + 1,) and int(buf[-1]) == 1
    real = engine._pad_encode

    def pad_encode_one_bad(k):
        c, ln, n = real(k)
        c = c.copy()
        c[1, 0] = 0
        return c, ln, n

    monkeypatch.setattr(engine, "_pad_encode", pad_encode_one_bad)
    with pytest.raises(ValueError, match="1 queries hold a code"):
        engine.count_batch(kms)
    for hits in (True, False):
        with pytest.raises(ValueError, match="1 queries hold a code"):
            engine.query_batch(kms, include_hits=hits)


# ------------------------------------------------------------ launch device


def _c_entries():
    """Every ``extern "C"`` entry of the library's sources → its
    parameter count, the walk tables' macro expanded."""
    import re

    entries = {}
    for src in kbuild._SOURCES:
        text = (kbuild._CSRC / src).read_text()
        macro = re.search(r"#define RS_WALK_PARAMS((?:[^\n]*\\\n)*[^\n]*)",
                          text)
        if macro:
            text = text.replace("RS_WALK_PARAMS,", macro.group(1).replace(
                "\\\n", " ") + ",")
        for m in re.finditer(r'extern "C" \w+ (\w+)\(([^)]*)\)', text):
            entries[m.group(1)] = len(
                [a for a in m.group(2).split(",") if a.strip()])
    return entries


def test_signatures_match_the_sources():
    """Each C entry's ctypes argtypes count its parameters, the stream
    included: a missing one makes ctypes pass the stream as a 32-bit int,
    which faults the launch on the card."""
    entries = _c_entries()
    assert set(entries) == set(kbuild.SIGNATURES)
    for name, n in entries.items():
        assert len(kbuild.SIGNATURES[name]) == n, name
    assert len(kbuild._WALK) == 18


def test_kernel_launches_on_the_tensors_device(monkeypatch):
    """A wrapper called from a worker thread (the dispatcher's) launches
    under the tensors' device and on that device's current stream, whatever
    the thread's current device is.  Runs on the CPU with the library and
    torch.cuda's device and stream calls stood in for."""
    seen = []

    class FakeLib:
        def rs_rank_occ(self, *args):
            seen.append(("launch", threading.current_thread().name, args[-1]))
            return 0

    @contextlib.contextmanager
    def fake_device(d):
        seen.append(("device", str(torch.device("cuda", d))))
        yield

    monkeypatch.setattr(kbuild.LIBRARY, "get", lambda: FakeLib())
    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    kernel = kbuild.Kernel("rs_rank_occ")
    with ThreadPoolExecutor(1, thread_name_prefix="device-batch") as ex:
        ex.submit(kernel, 1, 2, device=torch.device("cuda:3")).result()
    assert seen == [("device", "cuda:3"), ("launch", "device-batch_0", 1003)]
    assert kernel.launches == 1


@pytest.mark.cuda
def test_rank_kernel_from_worker_thread(dev):
    rng = np.random.default_rng(5)
    i = t32(rng.integers(0, dev.n + 1, size=10_000), dev.device)
    c = t32(rng.integers(0, 5, size=10_000), dev.device)
    before = RANK_OCC.launches
    with ThreadPoolExecutor(1, thread_name_prefix="device-batch") as ex:
        got = ex.submit(rank_ops.occ_rows, dev.rank_rows, c, i,
                        **_layout(dev)).result()
    torch.cuda.synchronize()
    assert RANK_OCC.launches == before + 1
    assert torch.equal(got, rank_ops.occ_rows_plain(dev.rank_rows, c, i,
                                                    **_layout(dev)))


def _random_table(P, rps, row_words, seed, device):
    """A rank table of random words, checkpoints below 2^30: K1 reads any
    table, and its plain form on the same table is the reference."""
    rng = np.random.default_rng(seed)
    t = rng.integers(-(1 << 31), 1 << 31, size=(P * rps, row_words),
                     dtype=np.int64).astype(np.int32)
    t[:, 0] = rng.integers(0, 1 << 30, size=P * rps)
    return torch.from_numpy(t).to(device)


# (planes, rows a plane, row words, log2 block, words a block): a base-like
# and a pair-like table of 16-byte rows and one of 20-byte rows, each
# several of K1's 8 MiB regions (csrc/rank.cu kRegionBytes); K1 buckets a
# batch of at least max(2^22, table rows) ranks
BIG_TABLES = {"base": (5, 1_000_000, 4, 6, 2),
              "pair": (16, 300_000, 4, 6, 2),
              "20-byte rows": (5, 800_000, 5, 7, 4)}


def _k1_case(table, c, i, lay):
    """K1 on (c, i) against its plain form, one launch."""
    c_t, i_t = t32(c, table.device), t32(i, table.device)
    before = RANK_OCC.launches
    got = rank_ops.occ_rows(table, c_t, i_t, **lay)
    want = rank_ops.occ_rows_plain(table, c_t, i_t, **lay)
    torch.cuda.synchronize()
    assert RANK_OCC.launches == before + (1 if len(c) else 0)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [0, 1, 2, 3, 1023, 1025, 4097, 314_572])
@pytest.mark.parametrize("table", ["base", "rank2"])
def test_rank_kernel_direct_edges(dev, B, table):
    """K1's direct design: B = 0 and 1, B not a multiple of the four ranks
    a thread carries nor of a block's 1,024, ranks at i = 0 and i = n,
    every plane of the table."""
    field, planes = TABLES[table]
    rows = getattr(dev, field)
    rng = np.random.default_rng(B + planes)
    i = rng.integers(0, dev.n + 1, size=B)
    i[: min(B, 2)] = [0, dev.n][: min(B, 2)]
    c = np.arange(B) % planes
    assert rank_ops.scratch_bytes(B, rows, dev.log2_block) == 0
    _k1_case(rows, c, i, _layout(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("table", sorted(BIG_TABLES))
@pytest.mark.parametrize("side", ["below", "at", "above"])
def test_rank_kernel_bucket_switch(cuda_device, table, side):  # noqa: F811
    """K1 on each side of the switch to the bucketed design (max(2^22,
    table rows) ranks), every plane, i = 0 and i = n, a last tile that is
    not full."""
    P, rps, rw, lg, wpb = BIG_TABLES[table]
    t = _random_table(P, rps, rw, P + rw, cuda_device)
    switch = max(1 << 22, P * rps)
    B = {"below": switch - 1, "at": switch, "above": switch + 4096 + 3}[side]
    n = (rps << lg) - 1
    rng = np.random.default_rng(B)
    i = rng.integers(0, n + 1, size=B)
    i[:2] = [0, n]
    c = rng.integers(0, P, size=B)
    c[:P] = np.arange(P)
    nbytes = rank_ops.scratch_bytes(B, t, lg)
    assert (nbytes > 0) == (side != "below")
    _k1_case(t, c, i, dict(rows_per_symbol=rps, log2_block=lg,
                           words_per_block=wpb))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_rank_kernel_one_bucket(cuda_device, where):  # noqa: F811
    """Every rank of a bucketed batch in one bucket (the first region, one
    in the middle, the last and partial one): one tile's run is the whole
    tile, the other buckets' blocks find nothing."""
    P, rps, rw, lg, wpb = BIG_TABLES["base"]
    t = _random_table(P, rps, rw, 7, cuda_device)
    B = (1 << 23) + 5
    region = (8 << 20) // 16  # rows of one bucket
    first = {"first": 0, "middle": 2 * region,
             "last": (P * rps - 1) // region * region}[where]
    rows = np.random.default_rng(3).integers(
        first, min(first + region, P * rps), size=B)
    c, blk = rows // rps, rows % rps
    i = (blk << lg) + np.random.default_rng(4).integers(0, 1 << lg, size=B)
    i = np.minimum(i, (rps << lg) - 1)
    assert rank_ops.scratch_bytes(B, t, lg) > 0
    _k1_case(t, c, i, dict(rows_per_symbol=rps, log2_block=lg,
                           words_per_block=wpb))


# --------------------------------------------- K5, K6, the rank walks, K7


@pytest.fixture(scope="module")
def cohort():
    corpus = simulate.simulate_config("cohort", scale=0.004)
    return corpus, build_index(corpus.reads, sample_ids=corpus.sample_ids)


def _intervals(d, corpus, n, seed):
    codes, lens = _queries(corpus, n, corpus.spec.kmer_len, seed)
    return backward_search(d, t32(codes, d.device), t32(lens, d.device))


def _edge_intervals(l, u, n):
    """An empty interval, a count past H = 64, and a whole-table one."""
    l, u = l.clone(), u.clone()
    l[0], u[0] = 0, 0
    l[1], u[1] = 5, 5 + 200
    l[2], u[2] = 0, n
    return l, u


@pytest.mark.cuda
@pytest.mark.parametrize("W", [256, 8192])
def test_dsa_kernel_matches_plain(cohort, cuda_device, W):  # noqa: F811
    corpus, packed = cohort
    d = DeviceIndex.from_packed(packed, cuda_device)
    l, u = _edge_intervals(*_intervals(d, corpus, W, seed=W), d.n)
    before = RESOLVE_DSA.launches
    got = resolve.resolve_dsa_hits(d, l, u, 64)
    want = resolve.resolve_dsa_hits_plain(d, l, u, 64)
    rows = torch.arange(d.n, dtype=torch.int32, device=d.device)
    valid = torch.rand(d.n, device=d.device) > 0.1
    got_rows = resolve.resolve_rows_dsa(d, rows, valid)
    want_rows = resolve.resolve_rows_dsa_plain(d, rows, valid)
    torch.cuda.synchronize()
    assert RESOLVE_DSA.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got_rows, want_rows))
    assert (got[0][0] == -1).all() and (got[0][1] >= 0).all()


@pytest.mark.cuda
def test_dsa_kernel_bit_31(cuda_device):  # noqa: F811
    words = np.array([0xFFFFFFFF, 0x80000001, 0x7FFFFFFF, 5], dtype=np.uint32)
    d = DeviceIndex.from_numpy(
        {"dsa": words, "read_to_sample": np.arange(4)},
        {"n": 4, "dsa_bits": 7, "num_reads": 4}, cuda_device)
    l, u = t32([0, 2], cuda_device), t32([2, 4], cuda_device)
    got = resolve.resolve_dsa_hits(d, l, u, 3)
    want = resolve.resolve_dsa_hits_plain(d, l, u, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].tolist() == [[0x1FFFFFF, 0x1000000, -1], [0xFFFFFF, 0, -1]]


def _fused_variants(d):
    """The index itself; its mark plane cleared (walks end only at $, so
    those needing sample_rate steps or more give -1); and every $ row of
    the first blocks also marked (marked wins)."""
    W = d.words_per_block
    fr = d.fused_rows.clone()
    fr[:, 6 + 3 * W : 6 + 4 * W] = 0
    dm = d.fused_rows.clone()
    dm[:4096, 6 + 3 * W : 6 + 4 * W] |= dm[:4096, 6 : 6 + W]
    return {"index": d, "no marks": dataclasses.replace(d, fused_rows=fr),
            "$ also marked": dataclasses.replace(d, fused_rows=dm)}


@pytest.mark.cuda
def test_fused_kernel_matches_plain(cohort, cuda_device):  # noqa: F811
    corpus, packed = cohort
    d = DeviceIndex.from_packed(packed, cuda_device, tiers={"fused"})
    rows = torch.arange(d.n, dtype=torch.int32, device=d.device)
    valid = torch.rand(d.n, device=d.device) > 0.1
    offsets = {}
    for name, v in _fused_variants(d).items():
        before = RESOLVE_FUSED.launches
        got = resolve.resolve_rows_fused(v, rows, valid)
        want = resolve.resolve_rows_fused_plain(v, rows, valid)
        torch.cuda.synchronize()
        assert RESOLVE_FUSED.launches == before + 1, name
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name
        offsets[name] = got[1]
    # without marks: walks of sample_rate - 1 steps end, longer ones give -1
    off = offsets["no marks"]
    assert (off == d.sample_rate - 1).any() and (off[valid] == -1).any()


def _short_intervals(d, corpus, n, k, seed):
    """Intervals of ``n`` k-mers drawn from the reads, short enough that
    most intervals pass H = 64."""
    codes, lens = _queries(corpus, n, k, seed)
    return backward_search(d, t32(codes, d.device), t32(lens, d.device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full budget", "0 valid", "1 slot",
                                  "1013 slots", "past resident"])
def test_fused_kernel_slot_counts(cohort, cuda_device, case):  # noqa: F811
    """K6 at slot counts the sweep's claims must get right: a full budget
    (every compacted slot walks, more walks than the card holds lanes at
    once), no valid slot, one slot, a count no multiple of the warp's 32,
    and four passes over every row under a random mask."""
    corpus, packed = cohort
    d = DeviceIndex.from_packed(packed, cuda_device, tiers={"fused"})
    g = torch.Generator(device=d.device).manual_seed(7)
    if case == "full budget":
        rows, valid, _ = resolve.expand_intervals(
            *_short_intervals(d, corpus, 8192, 4, seed=11), 64)
        budget = int(0.6 * 8192 * 64)
        rows, valid, _, _ = resolve.compact_rows(rows, valid, budget)
        assert bool(valid.all()) and rows.shape[0] == budget
    else:
        R = {"0 valid": 1000, "1 slot": 1, "1013 slots": 1013,
             "past resident": 4 * d.n}[case]
        rows = torch.randint(0, d.n, (R,), generator=g, device=d.device,
                             dtype=torch.int32)
        valid = torch.rand(R, generator=g, device=d.device) > 0.1
        if case == "0 valid":
            valid[:] = False
        if case == "1 slot":
            valid[:] = True
    before = RESOLVE_FUSED.launches
    got = resolve.resolve_rows_fused(d, rows, valid)
    want = resolve.resolve_rows_fused_plain(d, rows, valid)
    torch.cuda.synchronize()
    assert RESOLVE_FUSED.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "0 valid":
        assert (got[0] == -1).all() and (got[1] == -1).all()


# the rank walks: kind → (tiers shipped, the walk, its plain form)
RANK_WALKS = {
    "marks": ({"marks"}, resolve.resolve_rows_marked,
              resolve.resolve_rows_marked_plain),
    "lf": ({"marks", "lf"}, resolve.resolve_rows_fast,
           resolve.resolve_rows_fast_plain),
    "slow": (set(), resolve.resolve_rows, resolve.resolve_rows_plain),
}
# K7's walks: dsa, fused, lf, marks, slow
HIST_TIERS = [None, {"fused"}, {"marks", "lf"}, {"marks"}, set()]


def _rank_walk_variants(d):
    """The index itself; its marks cleared (walks end only at $, so those
    needing sample_rate steps or more give -1); and every $ row also
    marked (marked wins).  The lf walk's marks are its sign bits and its
    mark table both."""
    W = d.words_per_block
    if d.mark_rank is None:
        return {"index": d}
    lf = d.lf
    dm = d.mark_rank.clone()
    dm[:, 1:1 + W] |= d.rank_rows[:d.rows_per_symbol, 1:1 + W]
    cleared = dict(mark_rank=torch.zeros_like(d.mark_rank))
    dollar = dict(mark_rank=dm)
    if lf is not None:
        cleared["lf"] = lf & 0x7FFFFFFF
        dollar["lf"] = torch.where((lf & 0x7FFFFFFF) < d.C[1],
                                   lf | (-(1 << 31)), lf)
    return {"index": d,
            "no marks": dataclasses.replace(d, **cleared),
            "$ also marked": dataclasses.replace(d, **dollar)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(RANK_WALKS))
def test_rank_walk_kernel_matches_plain(cohort, cuda_device, kind):  # noqa: F811
    """The marks, lf and slow walks' kernel against their plain forms on
    every row, with the marks cleared and with $ rows marked."""
    corpus, packed = cohort
    tiers, walk, plain = RANK_WALKS[kind]
    d = DeviceIndex.from_packed(packed, cuda_device, tiers=tiers)
    assert resolve.walk_kind(d) == kind
    rows = torch.arange(d.n, dtype=torch.int32, device=d.device)
    valid = torch.rand(d.n, device=d.device) > 0.1
    for name, v in _rank_walk_variants(d).items():
        before = RESOLVE_WALK.launches, RANK_OCC.launches
        got = walk(v, rows, valid)
        torch.cuda.synchronize()
        assert (RESOLVE_WALK.launches, RANK_OCC.launches) == (
            before[0] + 1, before[1]), name
        want = plain(v, rows, valid)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name
        if name == "no marks":
            off = got[1]
            assert (off == d.sample_rate - 1).any() and (off[valid] == -1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(RANK_WALKS))
@pytest.mark.parametrize("case", ["full budget", "0 valid", "1 slot",
                                  "1013 slots", "past resident"])
def test_rank_walk_kernel_slot_counts(cohort, cuda_device, kind,
                                      case):  # noqa: F811
    """The rank walks at K6's slot counts: a full budget, no valid slot,
    one slot, a count no multiple of 32, and four passes over every row."""
    corpus, packed = cohort
    tiers, walk, plain = RANK_WALKS[kind]
    d = DeviceIndex.from_packed(packed, cuda_device, tiers=tiers)
    g = torch.Generator(device=d.device).manual_seed(8)
    if case == "full budget":
        rows, valid, _ = resolve.expand_intervals(
            *_short_intervals(d, corpus, 8192, 4, seed=11), 64)
        rows, valid, _, _ = resolve.compact_rows(rows, valid,
                                                 int(0.6 * 8192 * 64))
        assert bool(valid.all())
    else:
        R = {"0 valid": 1000, "1 slot": 1, "1013 slots": 1013,
             "past resident": 4 * d.n}[case]
        rows = torch.randint(0, d.n, (R,), generator=g, device=d.device,
                             dtype=torch.int32)
        valid = torch.rand(R, generator=g, device=d.device) > 0.1
        if case == "0 valid":
            valid[:] = False
        if case == "1 slot":
            valid[:] = True
    got = walk(d, rows, valid)
    want = plain(d, rows, valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "0 valid":
        assert (got[0] == -1).all() and (got[1] == -1).all()


@pytest.mark.cuda
def test_slow_walk_kernel_short_max_steps(cohort, cuda_device):  # noqa: F811
    """A slow walk bounded below the longest read gives -1 past it, as the
    plain form does; its hooks have no kernel and raise."""
    _, packed = cohort
    d = DeviceIndex.from_packed(packed, cuda_device, tiers=set())
    rows = torch.arange(d.n, dtype=torch.int32, device=d.device)
    valid = torch.ones_like(rows, dtype=torch.bool)
    steps = d.max_read_len // 2
    got = resolve.resolve_rows(d, rows, valid, max_steps=steps)
    want = resolve.resolve_rows_plain(d, rows, valid, max_steps=steps)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[0] == -1).any() and int(got[1].max()) == steps - 1
    with pytest.raises(NotImplementedError, match="only in the plain form"):
        resolve.resolve_rows(d, rows, valid,
                             rank_fn=lambda c, i: rank_ops.occ(d, c, i))


def _warps(dev) -> int:
    """The warps of the walks' persistent grid: 8 blocks of 4 warps an SM
    (csrc/resolve.cu's kMinBlocks)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count * 32


def _assert_walk(walk, plain, d, rows, valid, **kw):
    before = RESOLVE_WALK.launches
    got = walk(d, rows, valid, **kw)
    want = plain(d, rows, valid, **kw)
    torch.cuda.synchronize()
    assert RESOLVE_WALK.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(RANK_WALKS))
@pytest.mark.parametrize("step", [-1, 0, 1])
def test_rank_walk_kernel_at_the_crossover(cohort, cuda_device, kind,
                                           step):  # noqa: F811
    """Every warp of the persistent grid holding one walk fewer than the
    one-round limit, the limit, and one more (the marks and slow walks'
    step in one round, then in two)."""
    _, packed = cohort
    tiers, walk, plain = RANK_WALKS[kind]
    d = DeviceIndex.from_packed(packed, cuda_device, tiers=tiers)
    limit = kbuild.LIBRARY.get().rs_walk_one_round_max(-1)
    n = limit + step
    tiles = -(-n // 32)
    per = [n // tiles + (t < n % tiles) for t in range(tiles)]
    R = _warps(d.device) * 32 * tiles
    g = torch.Generator(device=d.device).manual_seed(21)
    rows = torch.randint(0, d.n, (R,), generator=g, device=d.device,
                         dtype=torch.int32)
    tile = torch.arange(R, device=d.device) // (_warps(d.device) * 32)
    lane = torch.arange(R, device=d.device) % 32
    valid = lane < torch.tensor(per, device=d.device)[tile]
    _assert_walk(walk, plain, d, rows, valid)


def _first_row_ends(d, kind):
    """Rows whose walk ends at its first row: → {"marked": rows,
    "$": rows} (no marked rows for the slow walk)."""
    rows = torch.arange(d.n, dtype=torch.int32, device=d.device)
    if kind == "lf":
        marked = d.lf < 0
        dollar = ~marked & ((d.lf & 0x7FFFFFFF) < d.C[1])
    else:
        dollar = rank_ops.read_symbol(d, rows) == 0
        marked = torch.zeros_like(dollar)
        if kind == "marks":
            _, marked = rank_ops.bit_rank_and_test(
                d.mark_rank, rows, log2_block=d.log2_block,
                words_per_block=d.words_per_block)
            dollar = dollar & ~marked
    out = {"$": rows[dollar]}
    if kind != "slow":
        out["marked"] = rows[marked]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(RANK_WALKS))
def test_rank_walk_kernel_first_row_ends(cohort, cuda_device,
                                         kind):  # noqa: F811
    """Every walk ending at its first row: a marked start (offset: its
    pair's) and a $ start (offset 0)."""
    _, packed = cohort
    tiers, walk, plain = RANK_WALKS[kind]
    d = DeviceIndex.from_packed(packed, cuda_device, tiers=tiers)
    for name, rows in _first_row_ends(d, kind).items():
        assert rows.numel() > 0, name
        valid = torch.ones_like(rows, dtype=torch.bool)
        got = _assert_walk(walk, plain, d, rows, valid)
        assert (got[0] >= 0).all(), name
        if name == "$":
            assert (got[1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(RANK_WALKS))
def test_rank_walk_kernel_all_to_max_steps(cohort, cuda_device,
                                           kind):  # noqa: F811
    """Every walk running to its bound: the rows whose walk does not end
    within sample_rate steps once the marks are cleared (the slow walk:
    within 3 steps), walked alone, all -1."""
    _, packed = cohort
    tiers, walk, plain = RANK_WALKS[kind]
    d = DeviceIndex.from_packed(packed, cuda_device, tiers=tiers)
    kw = {"max_steps": 3} if kind == "slow" else {}
    v = _rank_walk_variants(d).get("no marks", d)
    rows = torch.arange(d.n, dtype=torch.int32, device=d.device)
    valid = torch.ones_like(rows, dtype=torch.bool)
    rid, _ = plain(v, rows, valid, **kw)
    rows = rows[rid == -1]
    assert rows.numel() > 0
    got = _assert_walk(walk, plain, v, rows, torch.ones_like(
        rows, dtype=torch.bool), **kw)
    assert (got[0] == -1).all() and (got[1] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(RANK_WALKS))
@pytest.mark.parametrize("case", ["tail only", "past the grid"])
def test_rank_walk_kernel_slot_layouts(cohort, cuda_device, kind,
                                       case):  # noqa: F811
    """Valid slots only at the tail of R (every warp but the last tile's
    finds nothing to walk), and R past the persistent grid's lanes, every
    slot valid (lanes refill, the step in two rounds)."""
    _, packed = cohort
    tiers, walk, plain = RANK_WALKS[kind]
    d = DeviceIndex.from_packed(packed, cuda_device, tiers=tiers)
    lanes = _warps(d.device) * 32
    R = 4 * lanes + 999
    g = torch.Generator(device=d.device).manual_seed(22)
    rows = torch.randint(0, d.n, (R,), generator=g, device=d.device,
                         dtype=torch.int32)
    valid = torch.ones(R, dtype=torch.bool, device=d.device)
    if case == "tail only":
        valid[:-45] = False
    got = _assert_walk(walk, plain, d, rows, valid)
    if case == "tail only":
        assert (got[0][:-45] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tiers", HIST_TIERS[2:])
def test_exact_histogram_kernel_cap_cuts_a_query(cohort, cuda_device,
                                                 tiers):  # noqa: F811
    """K7 through the lf, marks and slow walks at a cap that falls inside
    a query's interval: that query counts only the rows before it."""
    corpus, packed = cohort
    d = DeviceIndex.from_packed(packed, cuda_device, tiers=tiers)
    l, u = _short_intervals(d, corpus, 512, 6, seed=13)
    counts = (u - l).long()
    cum = torch.cumsum(counts, 0)
    # the cap is whole windows of 64: the first multiple of 64 that falls
    # strictly inside an interval
    xs = torch.arange(64, int(cum[-1]), 64, device=d.device)
    q = torch.searchsorted(cum, xs, right=True)
    inside = (cum - counts)[q] < xs
    cap = int(xs[inside][0])
    q = int(q[inside][0])
    got = resolve.exact_sample_histogram(d, l, u, 64, cap)
    want = resolve.exact_sample_histogram_plain(d, l, u, 64, cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[0][q].sum()) == cap - int(cum[q] - counts[q])
    assert 0 < cap - int(cum[q] - counts[q]) < int(counts[q])
    assert not bool(got[1][q]) and int(got[0][q + 1:].sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("tiers", HIST_TIERS)
def test_exact_histogram_kernel_cap_filling(cohort, cuda_device,
                                            tiers):  # noqa: F811
    """K7 through every walk at a batch whose worklist the cap cuts: 8192
    6-mers of about 28 rows each against a cap of 100,352 rows."""
    corpus, packed = cohort
    d = DeviceIndex.from_packed(packed, cuda_device, tiers=tiers)
    l, u = _short_intervals(d, corpus, 8192, 6, seed=12)
    assert int((u - l).long().sum()) > 100_352
    got = resolve.exact_sample_histogram(d, l, u, 2048, 100_000)
    want = resolve.exact_sample_histogram_plain(d, l, u, 2048, 100_000)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[0].sum()) == 100_352 and not bool(got[1].all())


@pytest.mark.cuda
@pytest.mark.parametrize("tiers", HIST_TIERS)
@pytest.mark.parametrize("max_rows", [None, 100, 1 << 20])
def test_exact_histogram_kernel_makes_no_host_sync(cohort, cuda_device, tiers,
                                                   max_rows):  # noqa: F811
    """The sweep reads min(total, cap) on the card: with torch's sync
    debug mode set to raise, no call waits for the card."""
    corpus, packed = cohort
    d = DeviceIndex.from_packed(packed, cuda_device, tiers=tiers)
    l, u = _edge_intervals(*_intervals(d, corpus, 256, seed=5), d.n)
    resolve.exact_sample_histogram(d, l, u, 256, max_rows)  # built, loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = resolve.exact_sample_histogram(d, l, u, 256, max_rows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = resolve.exact_sample_histogram_plain(d, l, u, 256, max_rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("tiers", HIST_TIERS)
@pytest.mark.parametrize("window, max_rows", [(2048, 1 << 20), (64, 100),
                                              (256, None)])
def test_exact_histogram_kernel_matches_plain(cohort, cuda_device, tiers,
                                              window, max_rows):  # noqa: F811
    corpus, packed = cohort
    d = DeviceIndex.from_packed(packed, cuda_device, tiers=tiers)
    l, u = _edge_intervals(*_intervals(d, corpus, 256, seed=3), d.n)
    before = EXACT_HISTOGRAM.launches
    got = resolve.exact_sample_histogram(d, l, u, window, max_rows)
    want = resolve.exact_sample_histogram_plain(d, l, u, window, max_rows)
    torch.cuda.synchronize()
    assert EXACT_HISTOGRAM.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_exact_histogram_kernel_int64_totals(cohort, cuda_device):  # noqa: F811
    _, packed = cohort
    d = DeviceIndex.from_packed(packed, cuda_device)
    l = t32([0, 0, 0], d.device)
    u = t32([1_200_000_000] * 3, d.device)
    got = resolve.exact_sample_histogram(d, l, u, 256, 1024)
    want = resolve.exact_sample_histogram_plain(d, l, u, 256, 1024)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not got[1].any() and int(got[0][0].sum()) == 1024


# the serving plans: dsa, fused, lf, marks, slow on the card's budget
DROPS = [(), ("dsa",), ("dsa", "fused"), ("dsa", "fused", "lf"),
         ("dsa", "fused", "marks", "lf")]


@pytest.mark.cuda
@pytest.mark.parametrize("drop", DROPS)
def test_engine_on_card_matches_cpu(cohort, cuda_device, drop):  # noqa: F811
    """The whole full-answer path on the card (K2, K5 or a walk kernel,
    K7) gives the CPU engine's answers, field by field."""
    corpus, packed = cohort
    cfg = ServeConfig(batch_size=512, max_hits=8, drop_tiers=drop,
                      resolve_budget_frac=0.05)
    card = QueryEngine(packed, cfg, device=cuda_device)
    cpu = QueryEngine(packed, cfg, device="cpu")
    kms = ["".join("ACGT"[c - 1] for c in row) for row in _queries(
        corpus, 200, 31, seed=9)[0]] + ["ACGTAC", "GGATC"]
    for kw in (dict(), dict(include_hits=False), dict(both_strands=True)):
        assert card.query_batch(kms, **kw) == cpu.query_batch(kms, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("drop", DROPS[2:])
def test_engine_on_card_runs_no_plain_walk(cohort, cuda_device, drop,
                                           monkeypatch):  # noqa: F811
    """On the lf, marks and slow plans the card's query_batch runs no
    plain walk and no plain sweep (each made to raise here) and no K1
    rank: the walk kernel and K7 carry every resolve."""
    corpus, packed = cohort
    cfg = ServeConfig(batch_size=512, max_hits=8, drop_tiers=drop,
                      resolve_budget_frac=0.05)
    card = QueryEngine(packed, cfg, device=cuda_device)
    assert resolve.walk_kind(card.index) == {
        2: "lf", 3: "marks", 4: "slow"}[len(drop)]

    def refuse(*args, **kw):
        raise AssertionError("a plain form ran on the card")

    for name in ("resolve_rows_plain", "resolve_rows_fast_plain",
                 "resolve_rows_marked_plain", "resolve_rows_fused_plain",
                 "resolve_rows_dsa_plain", "exact_sample_histogram_plain"):
        monkeypatch.setattr(resolve, name, refuse)
    monkeypatch.setattr(rank_ops, "occ_rows_plain", refuse)
    kms = ["".join("ACGT"[c - 1] for c in row) for row in _queries(
        corpus, 200, 31, seed=9)[0]] + ["ACGTAC", "GGATC"]
    before = RESOLVE_WALK.launches, EXACT_HISTOGRAM.launches, RANK_OCC.launches
    for kw in (dict(), dict(include_hits=False), dict(both_strands=True)):
        card.query_batch(kms, **kw)
    torch.cuda.synchronize()
    assert RESOLVE_WALK.launches > before[0]
    assert EXACT_HISTOGRAM.launches > before[1]
    assert RANK_OCC.launches == before[2]


@pytest.fixture(scope="module")
def cohort_parts(cohort, tmp_path_factory):
    """The cohort corpus in 4 doc shards (``build_cohort``)."""
    corpus, _ = cohort
    out = build_cohort(corpus.reads, corpus.sample_ids, 4,
                       tmp_path_factory.mktemp("cohort") / "pop")
    return corpus, load_cohort(out, mmap=False)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("drop", DROPS)
def test_multi_engine_on_card_matches_cpu(cohort_parts, cuda_device, drop,
                                          monkeypatch):  # noqa: F811
    """``MultiEngine`` over 4 partitions on the card gives the CPU's counts,
    hits and histograms on every plan, one batch at a time and pipelined;
    on the card it runs no plain walk, no plain sweep and no K1 rank: the
    plan's resolve kernel and K7 launch in every partition."""
    corpus, parts = cohort_parts
    cfg = ServeConfig(batch_size=512, max_hits=8, drop_tiers=drop,
                      resolve_budget_frac=0.05)
    cpu = MultiEngine(parts, cfg, device="cpu")
    kms = ["".join("ACGT"[c - 1] for c in row) for row in _queries(
        corpus, 200, 31, seed=9)[0]] + ["ACGTAC", "GGATC"]
    tiers = (dict(), dict(include_hits=False), dict(both_strands=True))
    want = [cpu.query_batch(kms, **kw) for kw in tiers]
    want_counts = cpu.count_batch(kms, both_strands=True)
    want_bulk = cpu.query_batches([kms[:100], kms[100:]])

    def refuse(*args, **kw):
        raise AssertionError("a plain form ran on the card")

    for name in ("resolve_rows_plain", "resolve_rows_fast_plain",
                 "resolve_rows_marked_plain", "resolve_rows_fused_plain",
                 "resolve_rows_dsa_plain", "resolve_dsa_hits_plain",
                 "exact_sample_histogram_plain"):
        monkeypatch.setattr(resolve, name, refuse)
    monkeypatch.setattr(rank_ops, "occ_rows_plain", refuse)
    kernel = {0: RESOLVE_DSA, 1: RESOLVE_FUSED}.get(len(drop), RESOLVE_WALK)
    before = kernel.launches, EXACT_HISTOGRAM.launches, RANK_OCC.launches
    card = MultiEngine(parts, cfg, device=cuda_device)
    # the card's budget binds where the CPU's does not: ("dsa",) walks
    # fused rows there and lf rows here, with the same answers
    assert {resolve.walk_kind(e.index) for e in card.engines} == {
        ("dsa", "fused", "lf", "marks", "slow")[len(drop)]}
    for kw, w in zip(tiers, want):
        assert card.query_batch(kms, **kw) == w
    assert card.count_batch(kms, both_strands=True) == want_counts
    assert card.query_batches([kms[:100], kms[100:]]) == want_bulk
    torch.cuda.synchronize()
    assert kernel.launches >= before[0] + 4
    assert EXACT_HISTOGRAM.launches >= before[1] + 4
    assert RANK_OCC.launches == before[2]


@pytest.mark.cuda
def test_multi_engine_merge_on_card(cohort_parts, cuda_device):  # noqa: F811
    """The merge on the card: per-partition counts of 2^31 - 5 sum past
    2^31 exactly (int64, two int32 lanes), and the refused-query word
    rides last and raises at the copy."""
    _, parts = cohort_parts
    eng = MultiEngine(parts, ServeConfig(batch_size=8, max_hits=4),
                      device=cuda_device)
    W, H, nq, big = 8, 4, 3, 2**31 - 5
    outs = []
    for e in eng.engines:
        o = torch.full((W, 4 + e._ns + 3 * H), -1, dtype=torch.int32,
                       device=cuda_device)
        o[:, :4 + e._ns] = 0
        o[:, 2], o[:, 3] = big, 1
        outs.append(o)
    want = big * len(outs)
    assert eng._merge_count(outs).tolist() == [want] * W
    for with_hits in (True, False):
        bad = eng._new_bad()
        merged = eng._merge_full(outs, nq, with_hits, bad)
        res = eng._assemble_merged(["A"] * nq, nq, with_hits,
                                   (_copy_out(merged[0]), *merged[1:]))
        assert [r.count for r in res] == [want] * nq
        bad += 2
        merged = eng._merge_full(outs, nq, with_hits, bad)
        with pytest.raises(ValueError, match="2 queries hold a code"):
            eng._assemble_merged(["A"] * nq, nq, with_hits,
                                 (_copy_out(merged[0]), *merged[1:]))


# ------------------------------------------- interval sharding (K9-K11)

SHARD_CASES = [("small", 1), ("small", 4), ("small", 8), ("six reads", 8)]


@pytest.fixture(scope="module")
def shard_packs(packed):
    """The small corpus, and 6 of its reads (at S = 8 three shards are
    empty and start at an unaligned n)."""
    corpus, pk = packed
    six = build_index(corpus.reads[:6], sample_ids=corpus.sample_ids[:6])
    return corpus, {"small": pk, "six reads": six}


def _placed(pk, S, device):
    return shard_par.place_sharded(
        shard_par.build_sharded(pk, S),
        shard_par.make_mesh(num_shards=S, device=device))


def _no_dsa(s):
    return dataclasses.replace(s, dsa_chunk=None, dsa_bits=0)


def _slow(s):
    return dataclasses.replace(_no_dsa(s), lf_chunk=None, sample_rate=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case, S", SHARD_CASES)
def test_shard_occ_kernel_matches_plain(shard_packs, cuda_device, case, S):  # noqa: F811
    """K9 on every table at i = 0, 1, n - 1, n, past n, below 0, at every
    shard start and at random positions equals the clamped sum."""
    s = _placed(shard_packs[1][case], S, cuda_device)
    rng = np.random.default_rng(S)
    n = s.n
    i = np.concatenate([[0, 1, n - 1, n, n + 5, -2], s.starts.cpu().numpy(),
                        rng.integers(0, n + 1, size=20000)])
    i = torch.from_numpy(i.astype(np.int64)).to(cuda_device)
    for table, P in (("rank", 5), ("rank2", 16), ("rank3", 64), ("marks", 1)):
        c = torch.from_numpy(rng.integers(0, P, size=i.numel()).astype(
            np.int32)).to(cuda_device)
        before = SHARD_OCC.launches
        got = sops.occ(s, table, c, i)
        assert SHARD_OCC.launches == before + 1
        assert got.dtype == torch.int64
        assert torch.equal(got, sops.occ_plain(s, table, c, i)), table


@pytest.mark.cuda
@pytest.mark.parametrize("case, S", [("small", 1), ("small", 3),
                                     ("small", 4), ("six reads", 8)])
@pytest.mark.parametrize("X", [0, 1, 1023, 1025, 1 << 21])
def test_shard_occ_kernel_edges(shard_packs, cuda_device, case, S, X):  # noqa: F811
    """K9 over 1, 3 (the last shard short), 4 and 8 shards (three empty) on
    every table, with i at every shard edge (start - 1, start, start + 1,
    end - 1, end, end + 1), below 0 and past n, X = 0, 1, X not a multiple
    of a block's 128 ranks, and X past one wave of blocks."""
    s = _placed(shard_packs[1][case], S, cuda_device)
    rng = np.random.default_rng(S + X)
    n = s.n
    st, ln = s.starts.cpu().numpy(), s.lens.cpu().numpy()
    edges = np.concatenate([[0, 1, n - 1, n, n + 5, -2], st - 1, st, st + 1,
                            st + ln - 1, st + ln, st + ln + 1])
    i = rng.integers(0, n + 1, size=X)
    i[: min(X, edges.size)] = edges[: min(X, edges.size)]
    i = torch.from_numpy(i.astype(np.int64)).to(cuda_device)
    for table, P in (("rank", 5), ("rank2", 16), ("rank3", 64), ("marks", 1)):
        c = torch.from_numpy((np.arange(X) % P).astype(np.int32)).to(
            cuda_device)
        before = SHARD_OCC.launches
        got = sops.occ(s, table, c, i)
        assert SHARD_OCC.launches == before + (1 if X else 0)
        assert got.dtype == torch.int64 and got.shape == (X,)
        assert torch.equal(got, sops.occ_plain(s, table, c, i)), table


@pytest.mark.cuda
@pytest.mark.parametrize("case, S", SHARD_CASES)
def test_sharded_lut_kernel_matches_plain(shard_packs, cuda_device, case, S):  # noqa: F811
    """K11 at every level, in one launch a level and in chunks, equals the
    plain build (on the CPU copy of the same index)."""
    pk = shard_packs[1][case]
    s, cpu = _placed(pk, S, cuda_device), _placed(pk, S, "cpu")
    for p, chunk in ((8, 1 << 22), (6, 100), (1, 1)):
        before = SHARDED_LUT_LEVEL.launches
        got = shard_par.build_prefix_lut_sharded(s, None, p, max_chunk=chunk)
        assert SHARDED_LUT_LEVEL.launches - before == sum(
            -(-(4 ** lv) // chunk) for lv in range(1, p))
        want = shard_par.build_prefix_lut_sharded(cpu, None, p)
        assert torch.equal(got.cpu(), want), (p, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("case, S", SHARD_CASES)
def test_sharded_search_kernel_matches_plain(shard_packs, cuda_device, case,
                                             S):  # noqa: F811
    """The sharded search in every mode (1-step over mixed lengths, pairs,
    triples), from C and from the LUT, equals the plain form; refused
    queries are counted without waiting, or raise."""
    corpus, packs = shard_packs
    s = _placed(packs[case], S, cuda_device)
    lut = shard_par.build_prefix_lut_sharded(s, None, 5)
    for kstep, min_len in ((1, 5), (2, None), (3, None)):
        codes, lengths = _queries(corpus, 4096, 31, seed=kstep,
                                  min_len=min_len)
        codes, lengths = t32(codes, cuda_device), t32(lengths, cuda_device)
        for lt in (None, lut):
            before = SHARDED_SEARCH.launches
            got = sops.search(s, codes, lengths, lt, 5, kstep)
            assert SHARDED_SEARCH.launches == before + 1
            want = sops.search_plain(s, codes, lengths, lt, 5 if lt is not None
                                     else 0, kstep)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            assert got[0].dtype == torch.int64
    bad_codes = codes.clone()
    bad_codes[3, 7] = 5
    counter = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    l, u = sops.search(s, bad_codes, lengths, None, 0, 3, bad=counter)
    assert int(counter.item()) == 1 and int(l[3]) == int(u[3]) == 0
    with pytest.raises(ValueError, match="code outside"):
        sops.search(s, bad_codes, lengths, None, 0, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("case, S", SHARD_CASES)
@pytest.mark.parametrize("route", ["dsa", "lf", "slow"])
def test_sharded_resolve_kernel_matches_plain(shard_packs, cuda_device, case,
                                              S, route):  # noqa: F811
    """K10 on each route over a width-1024 batch's hit lanes (H = 64) and
    its exact sweep (window 4096, uncapped and capped) equal the plain
    forms."""
    corpus, packs = shard_packs
    s = {"dsa": lambda x: x, "lf": _no_dsa, "slow": _slow}[route](
        _placed(packs[case], S, cuda_device))
    assert sops.walk_kind(s) == route
    codes, lengths = _queries(corpus, 1024, 12, seed=5, min_len=8)
    l, u = sops.search(s, t32(codes, cuda_device), t32(lengths, cuda_device),
                       None, 0, 1)
    H = 64
    span = torch.arange(H, device=cuda_device)
    rows = (l[:, None] + span).reshape(-1)
    valid = (span[None, :] < (u - l)[:, None]).reshape(-1)
    rows = torch.where(valid, rows, torch.zeros_like(rows))
    before = SHARDED_RESOLVE.launches
    got = sops.resolve(s, rows, valid)
    assert SHARDED_RESOLVE.launches == before + 1
    want = sops.resolve_plain(s, rows, valid)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((got[0] >= 0).sum()) == int(valid.sum()) > 0
    for cap in (None, 5000, 0):
        got = sops.sweep(s, l, u, 4096, cap)
        want = sops.sweep_plain(s, l, u, 4096, cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_sharded_engine_on_card_runs_no_plain_form(shard_packs, cuda_device,
                                                   monkeypatch):  # noqa: F811
    """A 4-shard engine on the card answers as the same engine on the CPU,
    on the dsa, lf and slow routes, with every plain form of
    ops/sharded.py (and K1's rank) made to raise: the search, K10 and, at
    start-up, K11 carry the whole program."""
    corpus, packs = shard_packs
    cfg = ServeConfig(batch_size=512, max_hits=8, num_shards=4,
                      resolve_budget_frac=0.05)
    lut_before = SHARDED_LUT_LEVEL.launches
    card = QueryEngine(packs["small"], cfg,
                       shard_par.make_mesh(num_shards=4, device=cuda_device),
                       device=cuda_device)
    cpu = QueryEngine(packs["small"], cfg,
                      shard_par.make_mesh(num_shards=4, device="cpu"),
                      device="cpu")
    assert SHARDED_LUT_LEVEL.launches > lut_before
    kms = ["".join("ACGT"[c - 1] for c in row) for row in _queries(
        corpus, 200, 31, seed=9)[0]] + ["ACGTAC", "GGATC"]
    want = {}
    for route, fn in (("dsa", None), ("lf", _no_dsa), ("slow", _slow)):
        if fn is not None:
            cpu.sidx = fn(cpu.sidx)
        want[route] = [cpu.query_batch(kms, both_strands=b) for b in (0, 1)]

    def refuse(*args, **kw):
        raise AssertionError("a plain form ran on the card")

    for name in ("occ_plain", "_lookup_plain", "sym_plain", "sample_plain",
                 "walk_plain", "resolve_plain", "sweep_plain",
                 "lut_level_plain", "search_plain"):
        monkeypatch.setattr(sops, name, refuse)
    monkeypatch.setattr(rank_ops, "occ_rows_plain", refuse)
    before = SHARDED_SEARCH.launches, SHARDED_RESOLVE.launches
    for route, fn in (("dsa", None), ("lf", _no_dsa), ("slow", _slow)):
        if fn is not None:
            card.sidx = fn(card.sidx)
        got = [card.query_batch(kms, both_strands=b) for b in (0, 1)]
        assert got == want[route], route
    torch.cuda.synchronize()
    assert SHARDED_SEARCH.launches > before[0]
    assert SHARDED_RESOLVE.launches > before[1]


# ------------------- the redesigned sharded kernels: schedule and edges

SCHEDULE_K = [2, 3, 4, 7, 31, 32]


@pytest.mark.cuda
@pytest.mark.parametrize("K", SCHEDULE_K)
def test_search_kernels_schedule_match_plain(shard_packs, cuda_device, K):  # noqa: F811
    """K2 and the sharded search (search.cuh's body and k-step schedule)
    at K columns, from C and from LUTs of order 1 and min(K - 1, 8),
    through the masked scan, pairs and triples, equal their plain forms;
    the sharded one at S = 1, 3, 8 and 64 shards (empty ones included)."""
    corpus, packs = shard_packs
    orders = sorted({0, 1, min(K - 1, 8)})
    for kstep, min_len in ((1, 1), (2, None), (3, None)):
        codes, lengths = _queries(corpus, 2048, K, seed=K + kstep,
                                  min_len=min_len)
        c, ln = t32(codes, cuda_device), t32(lengths, cuda_device)
        tiers = {"rank2", "rank3"} if kstep == 3 else {"rank2"}
        d = DeviceIndex.from_packed(packs["small"], cuda_device, tiers=tiers)
        for p in orders:
            lut = build_prefix_lut(d, p) if p else None
            keep = lengths >= max(p, 1)
            ck, lk = c[t32(keep, cuda_device).bool()].contiguous(), \
                ln[t32(keep, cuda_device).bool()].contiguous()
            got = search_ops.backward_search_cuda(
                d, ck, None if kstep > 1 else lk, lut, p, kstep > 1)
            if kstep > 1:
                want = search_ops.backward_search_pair_plain(d, ck, lut, p)
            elif p:
                want = search_ops.backward_search_lut_plain(d, lut, p, ck, lk)
            else:
                want = search_ops.backward_search_plain(d, ck, lk)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                ("K2", kstep, p)
        for case, S in (("small", 1), ("small", 3), ("six reads", 8),
                        ("small", 64)):
            s = _placed(packs[case], S, cuda_device)
            for p in orders:
                lut = shard_par.build_prefix_lut_sharded(s, None, p) \
                    if p else None
                keep = t32(lengths >= max(p, 1), cuda_device).bool()
                ck, lk = c[keep].contiguous(), ln[keep].contiguous()
                got = sops.search(s, ck, lk, lut, p, kstep)
                want = sops.search_plain(s, ck, lk, lut, p, kstep)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                    (case, S, kstep, p)


@pytest.mark.cuda
@pytest.mark.parametrize("case, S", SHARD_CASES + [("small", 64)])
@pytest.mark.parametrize("route", ["dsa", "lf", "slow"])
def test_sharded_resolve_kernel_edges_match_plain(shard_packs, cuda_device,
                                                  case, S, route):  # noqa: F811
    """K10 against its plain forms on: rows at every shard's first and
    last position and at 0 and n - 1; warps whose lanes mix 0-step walks
    ($ rows), walks of max_read_len steps (the $ suffixes' rows, which end
    unterminated) and invalid lanes; a batch with every lane invalid; rows
    outside the index on the slow walk; and the exact sweep with a cap
    that cuts a query, at S up to 64."""
    corpus, packs = shard_packs
    s = {"dsa": lambda x: x, "lf": _no_dsa, "slow": _slow}[route](
        _placed(packs[case], S, cuda_device))
    assert sops.walk_kind(s) == route
    n, m = s.n, s.num_reads
    dev = cuda_device
    cpu = s.starts.cpu()
    ln = s.lens.cpu()
    edge = torch.cat([cpu[ln > 0], (cpu + ln - 1)[ln > 0],
                      torch.tensor([0, n - 1])])
    every = torch.arange(n, device=dev)
    dollar_rows = every[sops.sym_plain(s, every) == 0][:64]
    suffix_rows = torch.arange(min(m, 64), device=dev)
    k = min(dollar_rows.numel(), suffix_rows.numel())
    mixed = torch.stack([dollar_rows[:k], suffix_rows[:k],
                         torch.zeros(k, dtype=torch.int64, device=dev)],
                        dim=1).reshape(-1)
    mvalid = torch.tensor([True, True, False], device=dev).repeat(k)
    rows = torch.cat([edge.to(dev), mixed])
    valid = torch.cat([torch.ones(edge.numel(), dtype=torch.bool, device=dev),
                       mvalid])
    before = SHARDED_RESOLVE.launches
    for v in (valid, torch.zeros_like(valid)):
        got = sops.resolve(s, rows, v)
        want = sops.resolve_plain(s, rows, v)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert SHARDED_RESOLVE.launches == before + 2
    if route == "slow":
        out = torch.tensor([-3, n, n + 7], device=dev)
        ov = torch.ones(3, dtype=torch.bool, device=dev)
        got, want = sops.resolve(s, out, ov), sops.resolve_plain(s, out, ov)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    codes, lengths = _queries(corpus, 1024, 12, seed=6, min_len=6)
    l, u = sops.search(s, t32(codes, dev), t32(lengths, dev), None, 0, 1)
    cum = torch.cumsum(u - l, 0).cpu()
    q = int(torch.nonzero((u - l).cpu() >= 2)[0])
    for window, cap in ((1, int(cum[q]) - 1), (64, 100), (4096, None)):
        got = sops.sweep(s, l, u, window, cap)
        want = sops.sweep_plain(s, l, u, window, cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if window == 1:
            assert not bool(got[1][q])  # the cap cut query q


@pytest.mark.cuda
def test_cli_ingest_and_upgrade_served_on_card(tmp_path, cuda_device):  # noqa: F811
    """A FASTA through the CLI's ``build``, its triple tier and dsa
    stripped, then ``upgrade --kstep 3``: a ``QueryEngine`` on the card
    over the upgraded artifact counts as the CPU engine does, with K1's
    level entry building its LUT and K2 searching through the triple
    steps."""
    import json

    from readserver_tpu_torch import alphabet, cli
    from readserver_tpu_torch.corpus import io as cio
    from readserver_tpu_torch.index import artifact
    from readserver_tpu_torch.index.upgrade import plan_upgrade

    corpus = simulate.simulate_config("small")
    cio.write_fasta(tmp_path / "r.fa", ((f"r{i}", alphabet.decode(r))
                                        for i, r in enumerate(corpus.reads)))
    idx = tmp_path / "idx"
    assert cli.main(["build", "--fasta", str(tmp_path / "r.fa"),
                     "--out", str(idx)]) == 0
    for name in ("rank3_blocks", "C3", "dsa", "fused_rows"):
        (idx / f"{name}.npy").unlink()
    manifest = json.loads((idx / artifact.MANIFEST_NAME).read_text())
    manifest["arrays"] = [a for a in manifest["arrays"] if a not in (
        "rank3_blocks", "C3", "dsa", "fused_rows")]
    manifest["dsa_bits"] = 0
    (idx / artifact.MANIFEST_NAME).write_text(json.dumps(manifest))
    assert cli.main(["upgrade", str(idx), "--kstep", "3"]) == 0
    assert plan_upgrade(idx, kstep=3) == []
    packed = artifact.load_artifact(idx, mmap=False)
    assert packed.rank3_blocks is not None and packed.dsa is not None
    kms = ["".join("ACGT"[c - 1] for c in row) for row in _queries(
        corpus, 256, 15, seed=12)[0]]
    cfg = ServeConfig(batch_size=512)
    before = BACKWARD_SEARCH.launches, LUT_LEVEL.launches, RANK_OCC.launches
    card = QueryEngine(packed, cfg, device=cuda_device)
    got = card.count_batch(kms, both_strands=True)
    assert card.index.rank3_rows is not None
    assert BACKWARD_SEARCH.launches > before[0]
    assert LUT_LEVEL.launches > before[1]
    assert RANK_OCC.launches == before[2]
    cpu = QueryEngine(packed, cfg, device="cpu")
    assert got == cpu.count_batch(kms, both_strands=True)
    assert card.query_batch(kms[:64]) == cpu.query_batch(kms[:64])


# ------------------------ one rank's partials (K9's partial, K13, K11's)

# (case, S, runs): S shards in `runs` runs, one a rank
PARTIAL_CASES = [("small", 4, 2), ("small", 4, 4), ("small", 8, 2),
                 ("small", 4, 1), ("six reads", 8, 4)]


def _runs(pk, S, R, device):
    """The R ranks' placed runs of an S-shard index, and the whole index."""
    host = shard_par.build_sharded(pk, S)
    runs = [shard_par.place_sharded(host, shard_par.Mesh(
        shape={"dp": 1, "shard": S}, device=torch.device(device),
        ranks={"dp": 1, "shard": R}, coords={"dp": 0, "shard": r}))
        for r in range(R)]
    return runs, _placed(pk, S, device)


def _keys(s, whole, rng, n_random=4096):
    """Positions at every run's first and last rows, past them, n, past n,
    below 0 and at random."""
    n = whole.n
    ends = (whole.starts + whole.lens).cpu().numpy()
    starts = whole.starts.cpu().numpy()
    edge = np.concatenate([[0, 1, n - 1, n, n + 5, -2], starts, starts + 1,
                           ends - 1, ends])
    return np.concatenate([edge, rng.integers(0, n + 1, size=n_random)])


@pytest.mark.cuda
@pytest.mark.parametrize("case, S, R", PARTIAL_CASES)
def test_partial_kernels_match_plain(shard_packs, cuda_device, case, S, R):  # noqa: F811
    """K9's partial (a rank on every table, a search step of 1, 2 and 3
    columns, lead or not), K13 (every lookup, $ rows and absent keys
    included) and K11's partial on every rank's run equal their plain
    forms bit for bit; summed over the runs, the ranks equal the whole
    index's and the lead's step the plain step."""
    pk = shard_packs[1][case]
    runs, whole = _runs(pk, S, R, cuda_device)
    rng = np.random.default_rng(S * 10 + R)
    i = torch.from_numpy(_keys(runs[0], whole, rng).astype(np.int64)).to(
        cuda_device)
    X = i.numel()
    launches = (SHARD_OCC_PARTIAL.launches, SHARD_LOOKUP_PARTIAL.launches,
                SHARDED_LUT_LEVEL_PARTIAL.launches)
    for table, P in (("rank", 5), ("rank2", 16), ("rank3", 64), ("marks", 1)):
        c = torch.from_numpy(rng.integers(0, P, size=X).astype(np.int32)).to(
            cuda_device)
        total = torch.zeros(X, dtype=torch.int64, device=cuda_device)
        for run in runs:
            got = sops.occ_partial(run, table, c, i)
            assert torch.equal(got, sops.occ_plain(run, table, c, i))
            total += got
        assert torch.equal(total, sops.occ_plain(whole, table, c, i)), table
    # a search step over queries whose intervals are random ranges
    B, K = 1024, 12
    kmers = torch.from_numpy(rng.integers(1, 5, size=(B, K)).astype(
        np.int32)).to(cuda_device)
    lengths = torch.from_numpy(rng.integers(1, K + 1, size=B).astype(
        np.int32)).to(cuda_device)
    a = rng.integers(0, pk.n + 1, size=(2, B))
    lu = torch.from_numpy(np.concatenate([a.min(0), a.max(0)]).astype(
        np.int64)).to(cuda_device)
    for k, col in ((1, 0), (1, K - 2), (2, 3), (3, K - 3)):
        for lens in (None, lengths):
            total = 0
            for r, run in enumerate(runs):
                got = sops.step_partial(run, k, kmers, lens, col, lu, r == 0)
                want = sops.step_partial_plain(run, k, kmers, lens, col, lu,
                                               r == 0)
                assert torch.equal(got, want), (k, col, r)
                total = total + got
            assert torch.equal(total, sops.step_partial_plain(
                whole, k, kmers, lens, col, lu, True)), (k, col)
    # K13: positions (the $ rows among them), $-ranks, read ids, slots
    sym = sops.sym_plain(whole, i.clamp(0, max(pk.n - 1, 0)))
    dollar_rows = torch.nonzero(sym == 0).reshape(-1)
    keys = {
        "sym": i, "dsa": i, "lf": i, "lf_mark": i,
        "dollar": torch.arange(-2, pk.num_reads + 2, device=cuda_device),
        "sample": torch.arange(-3, pk.num_reads + 3, device=cuda_device),
    }
    assert dollar_rows.numel() > 0
    slots = torch.arange(-2, int(whole.slens.sum()) + 2, device=cuda_device)
    for what, x in keys.items():
        x = x.to(torch.int64).contiguous()
        for run in runs:
            got = sops.lookup_partial(run, what, x)
            assert torch.equal(got, sops.lookup_partial_plain(run, what, x)), \
                what
    dr = torch.arange(-2, pk.num_reads + 2, device=cuda_device)
    n_pair = max(dr.numel(), slots.numel())
    dr = torch.cat([dr, dr[:1].expand(n_pair - dr.numel())]).contiguous()
    sl = torch.cat([slots, slots[:1].expand(n_pair - slots.numel())])
    sl = sl.contiguous()
    total = 0
    for run in runs:
        got = sops.lookup_partial(run, "dollar_pair", dr, sl)
        assert torch.equal(got, sops.lookup_partial_plain(
            run, "dollar_pair", dr, sl))
        total = total + got
    assert torch.equal(total, sops.lookup_partial_plain(
        whole, "dollar_pair", dr, sl))
    # K11's partial at every level of a p = 6 build, in one launch and in
    # chunks
    l, u = whole.C[1:5].contiguous(), whole.C[2:6].contiguous()
    for _ in range(5):
        total = 0
        for r, run in enumerate(runs):
            for chunk in (1 << 22, 7):
                got = sops.lut_level_partial(run, l, u, r == 0,
                                             max_chunk=chunk)
                assert torch.equal(got, sops.lut_level_partial_plain(
                    run, l, u, r == 0))
            total = total + got
        nl, nu = sops.lut_level_plain(whole, l, u)
        assert torch.equal(total, torch.cat([nl, nu]))
        l, u = nl, nu
    torch.cuda.synchronize()
    assert SHARD_OCC_PARTIAL.launches > launches[0]
    assert SHARD_LOOKUP_PARTIAL.launches > launches[1]
    assert SHARDED_LUT_LEVEL_PARTIAL.launches > launches[2]


# (case, S, runs): runs of 1, 2 and 4 shards, one a rank
WALK_STEP_CASES = [("small", 4, 4), ("small", 4, 2), ("small", 4, 1),
                   ("six reads", 8, 2)]
WALK_ROUTES = {"lf": _no_dsa, "slow": _slow}


def _walk_lanes(whole, runs, rng, n_random=3000):
    """Rows: random positions, every $ row, each run's first and last rows
    and their neighbours; a quarter of the random ones invalid (row 0)."""
    n = whole.n
    sym = sops.sym_plain(whole, torch.arange(n, device=whole.starts.device))
    edges = []
    for r in runs:
        a, b = int(r.starts[0]), int(r.starts[-1] + r.lens[-1])
        edges += [e for e in (a - 1, a, a + 1, b - 2, b - 1) if 0 <= e < n]
    dev = whole.starts.device
    rows = torch.cat([torch.from_numpy(rng.integers(0, n, size=n_random)).to(
        dev), torch.nonzero(sym == 0).reshape(-1),
        torch.tensor(edges, device=dev, dtype=torch.int64)])
    valid = torch.ones(rows.shape, dtype=torch.bool, device=dev)
    valid[: n_random // 4] = False
    return torch.where(valid, rows, 0).contiguous(), valid


def _walk_lockstep(runs, rows, valid, kernel: bool):
    """A whole cross-rank walk on every run, each step launched (``kernel``)
    or its plain form run on the card, the all-reduces summed here → the
    snapshots of every rank's state after each step, and each ``first`` and
    ``step``'s live report."""
    kind = sops.walk_kind(runs[0])
    sts = [sops.walk_state(run, rows, valid, r == 0)
           for r, run in enumerate(runs)]
    fn = {("lf", True): sops.lf_walk_step, ("slow", True): sops.slow_walk_step,
          ("lf", False): sops.lf_walk_step_plain,
          ("slow", False): sops.slow_walk_step_plain}[kind, kernel]
    fields = ("cur", "done", "count", "step32", "step64", "term64", "term32",
              "read_id", "offset")
    for st in sts:  # what a step has not written yet reads alike
        for f in fields:
            if getattr(st, f) is not None:
                getattr(st, f).fill_(1 if f == "done" else -7)
    snaps, lives = [], []

    def step(mode, *t):
        for run, st in zip(runs, sts):
            fn(run, st, mode, *t)
        if mode in ("first", "step"):
            lives.append([st.live if not kernel else sops.walk_live(run, st)
                          for run, st in zip(runs, sts)])
        snaps.append([[None if getattr(st, f) is None
                       else getattr(st, f).clone() for f in fields]
                      for st in sts])

    def reduce(f):
        total = sum(getattr(st, f) for st in sts).to(getattr(sts[0], f).dtype)
        for st in sts:
            getattr(st, f).copy_(total)

    step("first")
    if kind == "lf":
        n = max(runs[0].sample_rate, 1)
        for i in range(n):
            reduce("step32")
            step("step" if i < n - 1 else "last")
        reduce("term64")
        step("terminal")
        reduce("term32")
    else:
        n = runs[0].max_read_len
        for t in range(n):
            reduce("step32")
            step("rank", t)
            reduce("step64")
            step("step" if t < n - 1 else "last", t)
        reduce("term32")
    step("finish")
    reduce("step32")
    return snaps, lives, sts


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(WALK_ROUTES))
@pytest.mark.parametrize("case, S, R", WALK_STEP_CASES)
def test_walk_step_kernels_match_plain(shard_packs, cuda_device, route, case,
                                       S, R):  # noqa: F811
    """Every step of the LF and slow walks (first step, steps, last step,
    the terminal, the finish) on runs of 4, 2 and 1 shards leaves every
    rank's state and partials equal to the plain forms' run on the card,
    max |err| 0, the live reports too; the walk's answers equal the
    one-device plain walk; each step is one launch."""
    runs, whole = _runs(shard_packs[1][case], S, R, cuda_device)
    runs = [WALK_ROUTES[route](r) for r in runs]
    whole = WALK_ROUTES[route](whole)
    rows, valid = _walk_lanes(whole, runs, np.random.default_rng(S + R))
    kern = WALK_LF_STEP if route == "lf" else WALK_SLOW_STEP
    before = kern.launches
    got, got_live, sts = _walk_lockstep(runs, rows, valid, True)
    torch.cuda.synchronize()
    assert kern.launches - before == len(got) * R
    want, want_live, _ = _walk_lockstep(runs, rows, valid, False)
    assert got_live == want_live
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for r, (gr, wr) in enumerate(zip(g, w)):
            for a, b in zip(gr, wr):
                assert (a is None) == (b is None)
                if a is not None:
                    assert a.dtype == b.dtype and torch.equal(a, b), (i, r)
    rid, off = sops.walk_plain(whole, rows, valid)
    assert torch.equal(sts[0].read_id, rid) and torch.equal(sts[0].offset, off)
    assert torch.equal(sts[0].step32, sops.sample_plain(whole, rid))
    assert int((rid >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case, S, R", PARTIAL_CASES)
def test_partials_32bit_sum_over_runs(shard_packs, cuda_device, case, S, R):  # noqa: F811
    """K13's int32 partials (symbol, $-rank's read id, sample, dsa word, raw
    LF, the (read id, pair) triple), summed in int32 over the runs, equal
    the whole index's lookup; the (LF, mark rank) pair is int64."""
    pk = shard_packs[1][case]
    runs, whole = _runs(pk, S, R, cuda_device)
    rng = np.random.default_rng(S + 3 * R)
    dev = cuda_device
    i = torch.from_numpy(_keys(runs[0], whole, rng).astype(np.int64)).to(dev)
    ids = torch.arange(-2, pk.num_reads + 2, device=dev)
    slots = torch.arange(-2, int(whole.slens.sum()) + 2, device=dev)
    n = max(ids.numel(), slots.numel())
    ids = torch.cat([ids, ids[:1].expand(n - ids.numel())]).contiguous()
    slots = torch.cat([slots, slots[:1].expand(n - slots.numel())])
    slots = slots.contiguous()
    for what, x, y in (("sym", i, None), ("dsa", i, None), ("lf", i, None),
                       ("dollar", ids, None), ("sample", ids, None),
                       ("dollar_pair", ids, slots), ("lf_mark", i, None)):
        parts = [sops.lookup_partial(run, what, x, y) for run in runs]
        want = sops.lookup_partial_plain(whole, what, x, y)
        assert parts[0].dtype == want.dtype == (
            torch.int64 if what == "lf_mark" else torch.int32), what
        assert torch.equal(sum(parts).to(want.dtype), want), what


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(WALK_ROUTES))
@pytest.mark.parametrize("early", [False, True])
def test_walk_one_launch_a_step(shard_packs, cuda_device, route, early,
                                monkeypatch):  # noqa: F811
    """Between two all-reduces of a cross-rank walk (a world of one), the
    launch counters of every kernel grow by exactly one: the walk step's
    (the sample partial rides on the finish)."""
    s = WALK_ROUTES[route](_placed(shard_packs[1]["small"], 4, cuda_device))
    rows, valid = _walk_lanes(s, [s], np.random.default_rng(7))
    counts = []
    monkeypatch.setattr(psh, "all_reduce", lambda t, group: (
        counts.append(sum(k.launches for k in KERNELS.values())), t)[1])
    run = psh._Run(s, shard_par.Mesh(shape={"dp": 1, "shard": 4},
                                     device=cuda_device))
    before = sum(k.launches for k in KERNELS.values())
    kern = WALK_LF_STEP if route == "lf" else WALK_SLOW_STEP
    k0 = kern.launches
    rid, off, smp = psh._resolve_ranks(run, rows, valid, early)
    torch.cuda.synchronize()
    assert list(np.diff([before, *counts])) == [1] * len(counts)
    assert kern.launches - k0 == len(counts)
    want, want_off = sops.walk_plain(s, rows, valid)
    assert torch.equal(rid, want) and torch.equal(off, want_off)


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(WALK_ROUTES))
def test_walks_on_one_index_report_apart(shard_packs, cuda_device, route):  # noqa: F811
    """Two walks on one placed index (a world of one, whose all-reduce
    leaves a partial as it is), their launches interleaved as two threads'
    batches may be: after every step each walk's live report is its own,
    equal to its plain form's on the card, and each walk answers as the
    one-device plain walk."""
    s = WALK_ROUTES[route](_placed(shard_packs[1]["small"], 4, cuda_device))
    lanes = [_walk_lanes(s, [s], np.random.default_rng(seed))
             for seed in (11, 12)]
    if route == "lf":
        fn, plain = sops.lf_walk_step, sops.lf_walk_step_plain
        n = max(s.sample_rate, 1)
        plan = ([("first", ())] + [("step" if i < n - 1 else "last", ())
                                   for i in range(n)]
                + [("terminal", ()), ("finish", ())])
    else:
        fn, plain = sops.slow_walk_step, sops.slow_walk_step_plain
        n = s.max_read_len
        plan = [("first", ())] + [
            m for t in range(n) for m in (("rank", (t,)), (
                "step" if t < n - 1 else "last", (t,)))] + [("finish", ())]
    sts = [sops.walk_state(s, rows, valid, True) for rows, valid in lanes]
    pls = [sops.walk_state(s, rows, valid, True) for rows, valid in lanes]
    assert sts[0].word is not sts[1].word
    for mode, t in plan:
        for st, pl in zip(sts, pls):
            fn(s, st, mode, *t)
            plain(s, pl, mode, *t)
        if mode in ("first", "step"):
            assert [sops.walk_live(s, st) for st in sts] == [
                pl.live for pl in pls], (mode, t)
    for st, (rows, valid) in zip(sts, lanes):
        rid, off = sops.walk_plain(s, rows, valid)
        assert torch.equal(st.read_id, rid) and torch.equal(st.offset, off)


@pytest.mark.cuda
def test_per_step_engine_on_card_runs_no_plain_form(shard_packs, cuda_device,
                                                    monkeypatch):  # noqa: F811
    """A 4-shard engine on the card through the cross-rank program (one
    rank, ``per_step``) answers as the one-device engine on the CPU, on
    the dsa, lf and slow routes and with the exact sweep, with every plain
    form of ops/sharded.py (and K1's rank) made to raise: the partial
    kernels carry the whole program."""
    corpus, packs = shard_packs
    cfg = ServeConfig(batch_size=256, max_hits=8, num_shards=4,
                      resolve_budget_frac=0.05)
    card = QueryEngine(packs["small"], cfg, shard_par.make_mesh(
        num_shards=4, device=cuda_device, per_step=True), device=cuda_device)
    cpu = QueryEngine(packs["small"], cfg,
                      shard_par.make_mesh(num_shards=4, device="cpu"),
                      device="cpu")
    kms = ["".join("ACGT"[c - 1] for c in row) for row in _queries(
        corpus, 100, 31, seed=19)[0]] + ["ACGTAC", "GGATC"]
    want = {}
    for route, fn in (("dsa", None), ("lf", _no_dsa), ("slow", _slow)):
        if fn is not None:
            cpu.sidx = fn(cpu.sidx)
        want[route] = [cpu.query_batch(kms, both_strands=b) for b in (0, 1)]

    def refuse(*args, **kw):
        raise AssertionError("a plain form ran on the card")

    for name in [n for n in vars(sops) if n.endswith("_plain")]:
        monkeypatch.setattr(sops, name, refuse)
    monkeypatch.setattr(rank_ops, "occ_rows_plain", refuse)
    before = (SHARD_OCC_PARTIAL.launches, SHARD_LOOKUP_PARTIAL.launches,
              SHARDED_SEARCH.launches, SHARDED_RESOLVE.launches)
    walks = (WALK_LF_STEP.launches, WALK_SLOW_STEP.launches)
    for route, fn in (("dsa", None), ("lf", _no_dsa), ("slow", _slow)):
        if fn is not None:
            card.sidx = fn(card.sidx)
        got = [card.query_batch(kms, both_strands=b) for b in (0, 1)]
        assert got == want[route], route
    torch.cuda.synchronize()
    assert SHARD_OCC_PARTIAL.launches > before[0]
    assert SHARD_LOOKUP_PARTIAL.launches > before[1]
    assert WALK_LF_STEP.launches > walks[0] and WALK_SLOW_STEP.launches > walks[1]
    assert (SHARDED_SEARCH.launches, SHARDED_RESOLVE.launches) == before[2:]


# ----------------------------- K14 and K15: compaction, capped histogram

# (name, B, H, R_c, most lanes a query asks for, share of empty queries);
# R_c None: exactly the batch's valid lanes
COMPACT_CASES = [
    ("total under budget", 512, 16, 4000, 12, 0.3),
    ("total at budget", 512, 16, None, 20, 0.3),
    ("total over budget", 8192, 64, 314_572, 80, 0.2),
    ("all empty", 256, 16, 100, 0, 1.0),
    ("one query", 1, 64, 40, 200, 0.0),
    ("no compaction", 300, 8, 300 * 8, 30, 0.2),
    ("past every lane", 300, 8, 5000, 30, 0.2),
    ("zero budget", 64, 8, 0, 8, 0.0),
    ("two chunks of queries", 9000, 3, 20_000, 5, 0.3),
    ("slots past 264 blocks", 20_000, 64, 1_100_000, 80, 0.05),
]


def _random_intervals(B, H, most, empty, seed):
    """(l, u) int32 [B]: random starts, u - l up to ``most`` (past H
    too), an ``empty`` share of them empty, a fifth of those (0, 0)."""
    rng = np.random.default_rng(seed)
    l = rng.integers(0, 1 << 20, B).astype(np.int32)
    n = rng.integers(1, most + 1, B) if most else np.zeros(B, np.int64)
    n[rng.random(B) < empty] = 0
    u = (l + n).astype(np.int32)
    z = (n == 0) & (rng.random(B) < 0.2)
    l[z] = u[z] = 0
    return torch.from_numpy(l), torch.from_numpy(u)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("name, B, H, R_c, most, empty", COMPACT_CASES)
def test_row_compaction_kernel_matches_plain(cuda_device, name, B, H, R_c,
                                             most, empty, dtype):  # noqa: F811
    """K14 against ``compact_rows`` over ``expand_intervals`` and the
    scatter back, bit for bit, with int32 rows and int64 ones (past 2^32,
    the interval shards' global rows): the budget's rows and flags, each
    query's lane prefix, and every lane's answer gathered back (random
    walk answers, -1 among them) with ``valid & keep``; then the gather
    with each third column against its plain form and the scatter: the
    walk's sample (0 on dropped lanes) and read_to_sample's of the clipped
    read id (-1 on dropped lanes)."""
    l, u = _random_intervals(B, H, most, empty, seed=B + H)
    if dtype == torch.int64:
        base = torch.where(u > l, 1 << 32, 0)
        l, u = l.long() + base, u.long() + base
    rows, valid, _ = resolve.expand_intervals(l, u, H)
    if R_c is None:
        R_c = int(valid.sum())
    want_rows, want_valid, orig, keep = resolve.compact_rows(rows, valid, R_c)
    before = (ROW_COMPACT.launches, ROW_GATHER.launches)
    dl, du = l.to(cuda_device), u.to(cuda_device)
    got_rows, got_valid, prefix = resolve.compact_lanes(dl, du, H, R_c)
    rng = np.random.default_rng(R_c)
    rid_c = torch.from_numpy(rng.integers(-1, 1 << 16, R_c).astype(np.int32))
    off_c = torch.from_numpy(rng.integers(-1, 100, R_c).astype(np.int32))
    smp_c = torch.from_numpy(rng.integers(0, 128, R_c).astype(np.int32))
    r2s = torch.from_numpy(rng.integers(0, 128, 60_000).astype(np.int32))
    rid, off, kept = resolve.gather_lanes(
        dl, du, H, R_c, prefix, rid_c.to(cuda_device), off_c.to(cuda_device))
    torch.cuda.synchronize()
    assert (ROW_COMPACT.launches, ROW_GATHER.launches) == (before[0] + 1,
                                                           before[1] + 1)
    assert got_rows.dtype == dtype
    assert torch.equal(got_rows.cpu(), want_rows)
    assert torch.equal(got_valid.cpu(), want_valid)
    assert torch.equal(prefix.cpu(), resolve._lane_prefix(l, u, H))
    F = B * H
    full = torch.full((F + 1,), -1, dtype=torch.int32)
    want_rid = full.scatter(0, orig, rid_c)[:F].reshape(B, H)
    want_kept = (valid & keep).reshape(B, H)
    assert torch.equal(rid.cpu(), want_rid)
    assert torch.equal(off.cpu(), full.scatter(0, orig, off_c)[:F].reshape(B, H))
    assert torch.equal(kept.cpu(), want_kept)
    want_smp = torch.zeros(F + 1, dtype=torch.int32).scatter(
        0, orig, smp_c)[:F].reshape(B, H)
    for col, want in (
            (dict(smp_c=smp_c), want_smp),
            (dict(read_to_sample=r2s, num_reads=50_000), torch.where(
                want_kept, r2s[want_rid.clamp(0, 49_999).long()], -1))):
        got = resolve.gather_lanes(
            dl, du, H, R_c, prefix.cpu().to(cuda_device),
            rid_c.to(cuda_device), off_c.to(cuda_device),
            **{k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
               for k, v in col.items()})
        plain = resolve.gather_lanes_plain(l, u, H, R_c, prefix.cpu(), rid_c,
                                           off_c, **col)
        assert len(got) == 4
        for g, w in zip(got, plain):
            assert torch.equal(g.cpu(), w)
        assert torch.equal(got[2].cpu(), want)
    assert ROW_GATHER.launches == before[1] + 3


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["fused", "lf", "slow"])
def test_compact_resolve_intervals_budget_on_card(packed, cuda_device, walk):  # noqa: F811
    """``resolve_intervals`` with a row budget on the card (K14 around
    the walk kernel) equals the CPU's plain compaction and walk."""
    corpus, pk = packed
    drops = {"fused": ("dsa", "lf"), "lf": ("dsa", "fused"),
             "slow": ("dsa", "fused", "lf", "marks")}[walk]
    tiers = {"marks", "fused", "lf", "dsa"} - set(drops)
    card = DeviceIndex.from_packed(pk, cuda_device, tiers=tiers)
    cpu = DeviceIndex.from_packed(pk, "cpu", tiers=tiers)
    assert resolve.walk_kind(card) == walk
    codes, lengths = _queries(corpus, 512, 12, seed=5)
    l, u = backward_search(cpu, t32(codes), t32(lengths))
    for R_c in (100, 2000):
        want = resolve.resolve_intervals(cpu, l, u, 32, row_budget=R_c)
        got = resolve.resolve_intervals(card, l.to(cuda_device),
                                        u.to(cuda_device), 32, row_budget=R_c)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["read ids", "samples"])
@pytest.mark.parametrize("S", [1, 5, 128, 1537, 20_000])
def test_capped_histogram_kernel_matches_plain(cuda_device, S, mode):  # noqa: F811
    """K15 against its plain forms: by read id (``sample_histogram``:
    valid lanes whose walk gave -1 counted under read 0's sample, ids past
    the reads clipped) and by the lanes' own samples (``lane_histogram``,
    the interval programs'); invalid lanes count nothing.  S = 1537 leaves
    room for 7 warps' bins a block, S = 20,000 takes the bins in the
    output."""
    rng = np.random.default_rng(S)
    B, H, nr = 1000, 64, 5000
    rid = rng.integers(-1, nr + 3, (B, H)).astype(np.int32)
    smp = rng.integers(0, S, (B, H)).astype(np.int32)
    valid = rng.random((B, H)) < 0.5
    valid[17] = False  # a query with no lane
    r2s = rng.integers(0, S, nr).astype(np.int32)
    idx = DeviceIndex(
        rank_rows=torch.zeros((1, 4), dtype=torch.int32), sym4=None, C=None,
        dollar_map=None, read_to_sample=torch.from_numpy(r2s),
        read_lengths=None, num_reads=nr, num_samples=S)
    card = dataclasses.replace(
        idx, rank_rows=idx.rank_rows.to(cuda_device),
        read_to_sample=idx.read_to_sample.to(cuda_device))
    tv = torch.from_numpy(valid)
    before = CAPPED_HISTOGRAM.launches
    if mode == "read ids":
        want = resolve.sample_histogram_plain(idx, torch.from_numpy(rid), tv)
        got = resolve.sample_histogram(
            card, torch.from_numpy(rid).to(cuda_device), tv.to(cuda_device))
    else:
        want = resolve.lane_histogram_plain(torch.from_numpy(smp), tv, S)
        got = resolve.lane_histogram(torch.from_numpy(smp).to(cuda_device),
                                     tv.to(cuda_device), S)
    torch.cuda.synchronize()
    assert CAPPED_HISTOGRAM.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert int(want.sum()) == int(valid.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("per_step", [False, True])
def test_compact_and_capped_interval_engine_on_card_runs_no_plain_form(
        shard_packs, cuda_device, monkeypatch, per_step):  # noqa: F811
    """The interval engine (4 shards of the small corpus on one card, and
    in a world of one through the cross-rank program) answers as on the
    CPU with every plain form of ops/ and ``compact_rows`` made to raise,
    on the dsa, lf and slow routes, capped and exact: K14's int64 entry
    with the walk's samples and K15's sample mode carry the compaction
    and the capped histogram."""
    corpus, packs = shard_packs
    kms = ["".join("ACGT"[c - 1] for c in row) for row in _queries(
        corpus, 100, 31, seed=29)[0]] + ["ACGTAC", "GGATC"]
    want, engines = {}, {}
    for exact in (True, False):
        cfg = ServeConfig(batch_size=256, max_hits=8, num_shards=4,
                          resolve_budget_frac=0.05, exact_attribution=exact)
        cpu = QueryEngine(packs["small"], cfg, shard_par.make_mesh(
            num_shards=4, device="cpu"), device="cpu")
        card = QueryEngine(packs["small"], cfg, shard_par.make_mesh(
            num_shards=4, device=cuda_device, per_step=per_step),
            device=cuda_device)
        for route, fn in (("dsa", None), ("lf", _no_dsa), ("slow", _slow)):
            if fn is not None:
                cpu.sidx, card.sidx = fn(cpu.sidx), fn(card.sidx)
            want[route, exact] = [cpu.query_batch(kms, both_strands=b)
                                  for b in (0, 1)]
            engines[route, exact] = (card, card.sidx)

    def refuse(*args, **kw):
        raise AssertionError("a plain form ran on the card")

    for mod in (sops, resolve, search_ops, lut_ops, rank_ops):
        for name in [n for n in vars(mod) if n.endswith("_plain")]:
            monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(resolve, "compact_rows", refuse)
    before = (ROW_COMPACT.launches, ROW_GATHER.launches,
              CAPPED_HISTOGRAM.launches)
    for key, (eng, sidx) in engines.items():
        eng.sidx = sidx
        got = [eng.query_batch(kms, both_strands=b) for b in (0, 1)]
        assert got == want[key], key
    torch.cuda.synchronize()
    assert ROW_COMPACT.launches > before[0]
    assert ROW_GATHER.launches > before[1]
    assert CAPPED_HISTOGRAM.launches > before[2]


@pytest.mark.cuda
def test_compact_and_capped_doc_engine_on_card_runs_no_plain_form(packed, cuda_device,
                                              monkeypatch):  # noqa: F811
    """The doc-sharded engine (4 partitions of the small corpus on the
    card) answers as on the CPU with every plain form of ops/ made to
    raise, on the dsa, fused and lf routes, capped and exact: K14 and K15
    carry the compaction and the capped histogram."""
    from readserver_tpu_torch.bench.multihost_bench import doc_partitions

    corpus, _ = packed
    want, engines = {}, {}
    for route in ("dsa", "fused", "lf"):
        parts = doc_partitions(
            lambda r, ids: build_index(r, sample_ids=ids), corpus.reads, 4,
            route)
        for exact in (True, False):
            cfg = ServeConfig(batch_size=256, max_hits=8,
                              resolve_budget_frac=0.05,
                              exact_attribution=exact)
            cpu = QueryEngine(parts, cfg, shard_par.make_mesh(
                num_shards=4, device="cpu"), device="cpu")
            engines[route, exact] = QueryEngine(
                parts, cfg, shard_par.make_mesh(num_shards=4,
                                                device=cuda_device),
                device=cuda_device)
            kms = ["".join("ACGT"[c - 1] for c in row) for row in _queries(
                corpus, 100, 25, seed=23)[0]] + ["ACGTAC", "GGATC"]
            want[route, exact] = (kms, [cpu.query_batch(kms, both_strands=b)
                                        for b in (0, 1)])

    def refuse(*args, **kw):
        raise AssertionError("a plain form ran on the card")

    for mod in (resolve, search_ops, lut_ops, rank_ops):
        for name in [n for n in vars(mod) if n.endswith("_plain")]:
            monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(resolve, "_WALKS", {
        k: (fn, refuse) for k, (fn, _) in resolve._WALKS.items()})
    before = (ROW_COMPACT.launches, ROW_GATHER.launches,
              CAPPED_HISTOGRAM.launches)
    for key, eng in engines.items():
        kms, w = want[key]
        got = [eng.query_batch(kms, both_strands=b) for b in (0, 1)]
        assert got == w, key
    torch.cuda.synchronize()
    assert ROW_COMPACT.launches > before[0]
    assert ROW_GATHER.launches > before[1]
    assert CAPPED_HISTOGRAM.launches > before[2]


# --------------------------------------- K8 and the cohort merge's pack

# (name, W, NS, H, nq, density, exact): the served shapes (/reads and
# /samples of 4096 queries on both strands: E. coli's one sample, the
# cohort's 128), nq < W, densities past the 16 slots a query in either
# section, and the edges of the one-launch design: exactly R and R + 1
# kept in a section (exact: the section and kept - R), nq = 0, odd NS and
# SH (the kernel's four-load groups), and more tiles than the card holds
# blocks at once (blocks take further tiles)
PACK_CASES = [
    ("E. coli /reads", 8192, 1, 64, 8192, 0.01, None),
    ("cohort /samples", 8192, 128, 0, 8192, 0.005, None),
    ("cohort /reads, nq < W", 8192, 128, 64, 5000, 0.01, None),
    ("hist overflow", 8192, 128, 64, 8192, 0.2, None),
    ("hits overflow", 8192, 1, 64, 6000, 0.4, None),
    ("one query", 1, 3, 8, 1, 0.5, None),
    ("hist kept R", 4096, 33, 8, 4000, 0.0, ("hist", 0)),
    ("hist kept R + 1", 4096, 33, 8, 4000, 0.0, ("hist", 1)),
    ("hits kept R", 4096, 1, 33, 4000, 0.0, ("hits", 0)),
    ("hits kept R + 1", 4096, 1, 33, 4000, 0.0, ("hits", 1)),
    ("nq = 0", 4096, 5, 7, 0, 0.3, None),
    ("odd NS and SH", 4093, 5, 7, 4000, 0.3, None),
    ("more tiles than the card holds", 16384, 2, 256, 16384, 0.05, None),
]


def _pack_inputs(W, NS, H, density, seed, device):
    rng = np.random.default_rng(seed)
    l = rng.integers(0, 1 << 20, W)
    u = l + rng.integers(0, 200, W)
    hist = np.where(rng.random((W, NS)) < density,
                    rng.integers(1, 50, (W, NS)), 0)
    comp = torch.from_numpy(rng.random(W) < 0.9).to(device)
    cols = [t32(l, device), t32(u, device), comp, t32(hist, device)]
    if H:
        rid = np.where(rng.random((W, H)) < density,
                       rng.integers(0, 1 << 24, (W, H)), -1)
        cols += [t32(rid, device), t32(rng.integers(0, 150, (W, H)), device),
                 t32(rng.integers(0, 128, (W, H)), device)]
    else:
        cols += [None, None, None]
    return cols


def _kept_at(shape, nq, k, seed, empty, device):
    """An int32 [W, width] tensor holding ``empty`` but at ``k`` seeded
    cells of the first ``nq`` rows, which hold values 1 to 49."""
    W, width = shape
    rng = np.random.default_rng(seed)
    a = np.full(W * width, empty, np.int64)
    a[rng.choice(nq * width, size=k, replace=False)] = rng.integers(1, 50, k)
    return t32(a.reshape(W, width), device)


@pytest.mark.cuda
@pytest.mark.parametrize("name, W, NS, H, nq, density, exact", PACK_CASES)
def test_sparse_pack_kernel_matches_plain(cuda_device, name, W, NS, H, nq,
                                          density, exact):  # noqa: F811
    """K8 against its plain form, word for word: the segments, both
    sections with -1 past the kept entries, n = -1 and the first R kept on
    an overflow, the refused-query word; the dense fallbacks equal."""
    cols = _pack_inputs(W, NS, H, density, W + NS + H, cuda_device)
    R = 16 * W
    if exact:
        i = 3 if exact[0] == "hist" else 4
        cols[i] = _kept_at(cols[i].shape, nq, R + exact[1], W + exact[1],
                           0 if i == 3 else -1, cuda_device)
    bad = torch.tensor([2], dtype=torch.int32, device=cuda_device)
    before = SPARSE_PACK.launches
    got = pack_ops.pack_answer(*cols, nq, 16, bad, 64)
    torch.cuda.synchronize()
    assert SPARSE_PACK.launches == before + 1
    want = pack_ops.pack_answer_plain(*cols, nq, 16, bad, 64)
    assert torch.equal(got[0], want[0])
    assert torch.equal(pack_ops.dense(got[1]), want[1])
    if H:
        assert torch.equal(pack_ops.dense(got[2]), want[2])
    else:
        assert got[2] is None and want[2] is None
    # n_hist after count, complete, (trunc,) l and u; n_hits R + R later
    p = W * (4 if H else 5)
    n = [int(got[0][p])] + ([int(got[0][p + 1 + 2 * R])] if H else [])
    assert (-1 in n) == ("overflow" in name or "R + 1" in name)
    if name == "hist overflow":
        assert n[0] == -1
    if exact:
        assert n[exact[0] == "hits"] == (R if exact[1] == 0 else -1)
    if nq == 0:
        assert n == [0] * len(n)


def _merge_inputs(W, ns, H, with_hits, density, big, seed, device):
    rng = np.random.default_rng(seed)
    outs = []
    for n in ns:
        o = np.zeros((W, 4 + n + (3 * H if with_hits else 0)), np.int64)
        o[:, 0] = rng.integers(0, 1 << 20, W)
        o[:, 2] = (2**31 - 5 if big else rng.integers(0, 2 * H, W))
        o[:, 1] = o[:, 0] + o[:, 2] % (1 << 20)
        o[:, 3] = rng.random(W) < 0.9
        o[:, 4:4 + n] = np.where(rng.random((W, n)) < density,
                                 rng.integers(1, 20, (W, n)), 0)
        if with_hits:
            o[:, 4 + n:4 + n + H] = np.where(
                rng.random((W, H)) < density,
                rng.integers(0, 1 << 20, (W, H)), -1)
            o[:, 4 + n + H:] = rng.integers(0, 150, (W, 2 * H))
        outs.append(t32(o, device))
    return outs


def _merge_kept_at(outs, ns, H, nq, section, k, seed):
    """Exactly ``k`` kept merged entries of the first ``nq`` queries in
    ``section``: cells of partition 0 alone (every other partition's
    zero), or lanes spread over the partitions (every other lane -1)."""
    W = outs[0].shape[0]
    if section == "hist":
        for p, (o, n) in enumerate(zip(outs, ns)):
            o[:, 4:4 + n] = (_kept_at((W, n), nq, k, seed, 0, o.device)
                             if p == 0 else 0)
        return
    lanes = _kept_at((W, len(ns) * H), nq, k, seed, -1, outs[0].device)
    for p, (o, n) in enumerate(zip(outs, ns)):
        o[:, 4 + n:4 + n + H] = lanes[:, p * H:(p + 1) * H]


# (name, W, partitions' samples, H, nq, density, counts past 2^31, exact):
# the served partitions, an unaligned row stride (one partition: 33 words
# with hits; odd strides: 23-29), 64 partitions, nq = 0, more tiles than
# the card holds blocks at once, and exactly R and R + 1 kept
MERGE_CASES = [
    ("cohort's 4 partitions", 8192, (32, 64, 96, 128), 64, 8192, 0.005,
     False, None),
    ("nq < W, past 2^31", 8192, (32, 64, 96, 128), 64, 3000, 0.005, True,
     None),
    ("overflow", 8192, (128, 128, 128, 128), 64, 8192, 0.1, False, None),
    ("one partition", 300, (5,), 8, 300, 0.3, False, None),
    ("odd strides", 4096, (7, 9, 11, 13), 4, 4000, 0.05, False, None),
    ("64 partitions", 512, (3, 4, 8, 5) * 16, 4, 500, 0.05, False, None),
    ("nq = 0", 4096, (128,) * 4, 64, 0, 0.05, False, None),
    ("more tiles than the card holds", 16384, (128,) * 4, 64, 16384, 0.01,
     False, None),
    ("hist kept R", 4096, (128, 64), 64, 4000, 0.0, False, ("hist", 0)),
    ("hist kept R + 1", 4096, (128, 64), 64, 4000, 0.0, False, ("hist", 1)),
    ("hits kept R", 4096, (16, 16), 64, 4000, 0.0, False, ("hits", 0)),
    ("hits kept R + 1", 4096, (16, 16), 64, 4000, 0.0, False, ("hits", 1)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("with_hits", [True, False])
@pytest.mark.parametrize("name, W, ns, H, nq, density, big, exact",
                         MERGE_CASES)
def test_merge_pack_kernel_matches_plain(cuda_device, name, W, ns, H, nq,
                                         density, big, exact,
                                         with_hits):  # noqa: F811
    """The cohort merge and its pack against ``merge_dense`` and the plain
    pack, word for word, on both tiers: int64 count sums (past 2^31 in
    two lanes), narrower partitions' histograms, read ids shifted by each
    base, the histogram tier's trunc flags, overflow; the dense fallbacks
    the merged tensors."""
    outs = _merge_inputs(W, ns, H, with_hits, density, big, W + len(ns),
                         cuda_device)
    R = 16 * W
    if exact and (exact[0] == "hist" or with_hits):
        _merge_kept_at(outs, ns, H, nq, exact[0], R + exact[1], W)
    bases = ([0, 1_000_000, 3_000_000, 7_000_000] * 16)[:len(ns)]
    bad = torch.tensor([0], dtype=torch.int32, device=cuda_device)
    args = (outs, list(ns), bases, max(ns), H, nq, 16, bad, with_hits)
    before = MERGE_PACK.launches
    got = pack_ops.merge_pack(*args)
    torch.cuda.synchronize()
    assert MERGE_PACK.launches == before + 1
    want = pack_ops.merge_pack_plain(*args)
    assert torch.equal(got[0], want[0])
    assert torch.equal(pack_ops.dense(got[1]), want[1])
    if with_hits:
        assert torch.equal(pack_ops.dense(got[2]), want[2])
    if big:
        assert int(got[0][W]) == len(ns) * (2**31 - 5) >> 31
    if exact and (exact[0] == "hist" or with_hits):
        p = W * (3 if with_hits else 4)
        n = int(got[0][p + (1 + 2 * R if exact[0] == "hits" else 0)])
        assert n == (R if exact[1] == 0 else -1)


@pytest.mark.cuda
def test_pack_kernels_refuse_what_they_do_not_take(cuda_device):  # noqa: F811
    cols = _pack_inputs(64, 2, 8, 0.3, 1, cuda_device)
    bad = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    for i, wrong in ((0, cols[0].long()), (3, cols[3][:, :1]),
                     (4, cols[4].t()), (2, cols[2].int())):
        bent = list(cols)
        bent[i] = wrong
        with pytest.raises(ValueError):
            pack_ops.pack_answer(*bent, 64, 16, bad, 8)
    with pytest.raises(ValueError):
        pack_ops.pack_answer(*cols, 65, 16, bad, 8)
    outs = _merge_inputs(64, (2, 3), 8, False, 0.3, False, 2, cuda_device)
    with pytest.raises(ValueError):  # ns past the cohort's
        pack_ops.merge_pack(outs, [2, 3], [0, 10], 2, 8, 64, 16, bad, False)
    with pytest.raises(ValueError):  # rows without the hit columns
        pack_ops.merge_pack(outs, [2, 3], [0, 10], 3, 8, 64, 16, bad, True)


@pytest.mark.cuda
def test_merge_pack_histogram_tier_on_full_rows(cuda_device):  # noqa: F811
    """The histogram tier over buffers that carry the hit columns too (a
    row stride past 4 + ns), as the plain merge slices them."""
    outs = _merge_inputs(4096, (32, 64, 96, 128), 64, True, 0.01, True, 7,
                         cuda_device)
    bad = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    args = (outs, [32, 64, 96, 128], [0, 10, 20, 30], 128, 64, 3000, 16,
            bad, False)
    got = pack_ops.merge_pack(*args)
    want = pack_ops.merge_pack_plain(*args)
    assert torch.equal(got[0], want[0])
    assert torch.equal(pack_ops.dense(got[1]), want[1])


def _pack_calls(device):
    """(kernel call, plain call) pairs at four shapes, each a closure over
    its seeded inputs: K8 on /reads- and /samples-like answers and on odd
    widths (the four-load groups), and the merge of 4 served partitions;
    their tiles, and so the descriptors a call uses, range from 7 to 188."""
    bad = torch.tensor([1], dtype=torch.int32, device=device)
    calls = []
    for W, NS, H, nq, dens in ((2048, 1, 64, 2048, 0.15),
                               (2048, 128, 0, 2000, 0.02),
                               (999, 5, 7, 990, 0.3)):
        cols = _pack_inputs(W, NS, H, dens, W + NS, device)
        a = (*cols, nq, 16, bad, 64)
        calls.append((lambda a=a: pack_ops.pack_answer(*a)[0],
                      lambda a=a: pack_ops.pack_answer_plain(*a)[0]))
    outs = _merge_inputs(1024, (128,) * 4, 64, True, 0.01, False, 3, device)
    a = (outs, [128] * 4, [0, 10, 20, 30], 128, 64, 1000, 16, bad, True)
    calls.append((lambda a=a: pack_ops.merge_pack(*a)[0],
                  lambda a=a: pack_ops.merge_pack_plain(*a)[0]))
    return calls


@pytest.mark.cuda
def test_pack_kernels_reuse_one_scratch(cuda_device):  # noqa: F811
    """1,000 calls in a row on one stream, K8 and the merge in turn at four
    shapes, with no wait between them: they share one scratch, whose
    descriptors no launch resets (each call's epoch makes the last call's
    stale, and the call's last claim sets the tile counter back to 0), and
    every buffer equals its plain form."""
    calls = _pack_calls(cuda_device)
    wants = [plain() for _, plain in calls]
    torch.cuda.synchronize()
    key = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    diff = torch.zeros((), dtype=torch.int64, device=cuda_device)
    before = SPARSE_PACK.launches + MERGE_PACK.launches
    for i in range(1000):
        kern, _ = calls[i % len(calls)]
        diff += (kern() != wants[i % len(calls)]).sum()
    torch.cuda.synchronize()
    assert int(diff) == 0
    assert SPARSE_PACK.launches + MERGE_PACK.launches == before + 1000
    assert key in pack_ops._SCRATCH
    assert int(pack_ops._SCRATCH[key].buf[0]) == 0  # the tile counter


@pytest.mark.cuda
def test_pack_kernels_on_two_streams(cuda_device):  # noqa: F811
    """Two streams packing at once, K8 on one and the merge on the other,
    100 calls each without a wait: each stream has its own scratch, so
    neither reads the other's flags, and every buffer equals its plain
    form."""
    (k8, k8_plain), *_, (merge, merge_plain) = _pack_calls(cuda_device)
    wants = (k8_plain(), merge_plain())
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    diffs = []
    for s in streams:
        with torch.cuda.stream(s):
            diffs.append(torch.zeros((), dtype=torch.int64,
                                     device=cuda_device))
    for _ in range(100):
        for s, kern, want, d in zip(streams, (k8, merge), wants, diffs):
            with torch.cuda.stream(s):
                d += (kern() != want).sum()
    torch.cuda.synchronize()
    assert [int(d) for d in diffs] == [0, 0]
    index = torch.cuda.current_device()
    assert all((index, s.cuda_stream) in pack_ops._SCRATCH for s in streams)


@pytest.mark.cuda
def test_pack_kernels_on_two_streams_past_the_card(cuda_device):  # noqa: F811
    """K8 at the served /reads shape (W 8192, NS 1, SH 64: 260 tiles on a
    grid of 260 blocks) on two streams at once, 50 calls each without a
    wait: the two grids ask more blocks than the card holds at once, so a
    launch may run with part of its blocks not yet started while the
    other holds the card; no block waits on a tile that no running block
    has claimed, so both finish, and every buffer equals its plain form."""
    bad = torch.tensor([1], dtype=torch.int32, device=cuda_device)
    args = [(*_pack_inputs(8192, 1, 64, 0.15, seed, cuda_device), 8192, 16,
             bad, 64) for seed in (5, 6)]
    wants = [pack_ops.pack_answer_plain(*a)[0] for a in args]
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    diffs = []
    for s in streams:
        with torch.cuda.stream(s):
            diffs.append(torch.zeros((), dtype=torch.int64,
                                     device=cuda_device))
    before = SPARSE_PACK.launches
    for _ in range(50):
        for s, a, want, d in zip(streams, args, wants, diffs):
            with torch.cuda.stream(s):
                d += (pack_ops.pack_answer(*a)[0] != want).sum()
    torch.cuda.synchronize()
    assert [int(d) for d in diffs] == [0, 0]
    assert SPARSE_PACK.launches == before + 100


@pytest.mark.cuda
def test_pack_scratch_epochs_wrap(cuda_device):  # noqa: F811
    """The epochs' wrap, the one point where a descriptor's epoch repeats:
    a scratch two calls short of ``EPOCHS`` is zeroed at its second call,
    whose epoch is 1 again; three calls in a row at 65, 125 and 7 tiles
    each equal their plain form word for word."""
    calls = _pack_calls(cuda_device)[:3]
    wants = [plain() for _, plain in calls]
    calls[0][0]()  # this stream's scratch
    torch.cuda.synchronize()
    key = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    sc = pack_ops._SCRATCH[key]
    sc.epoch = pack_ops.EPOCHS - 2
    epochs = []
    for (kern, _), want in zip(calls, wants):
        assert torch.equal(kern(), want)
        epochs.append(sc.epoch)
    assert epochs == [pack_ops.EPOCHS - 1, 1, 2]


@pytest.mark.cuda
def test_pack_kernels_are_one_launch(cuda_device):  # noqa: F811
    """Each wrapper call is one launch on the card and nothing else: the
    profiler sees one kernel a call (no memset of the flags, no second
    pass)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = _pack_calls(cuda_device)
    for kern, _ in calls:
        kern()
    torch.cuda.synchronize()
    for _ in range(5):  # the profiler now and then records no device event
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                for kern, _ in calls:
                    kern()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 3 * len(calls)
    assert all("pack_kernel" in k for k in kernels), set(kernels)


@pytest.mark.cuda
def test_engines_on_card_pack_through_the_kernels(cohort, cohort_parts,
                                                  cuda_device,
                                                  monkeypatch):  # noqa: F811
    """``QueryEngine`` and ``MultiEngine`` on the card answer as on the CPU
    with the plain packs made to raise: K8 packs every full answer of the
    engine (both tiers, both strands, an overflowing batch of short
    k-mers, whose dense fallbacks the host reads) and the merge kernel
    every cohort batch."""
    corpus, packed = cohort
    _, parts = cohort_parts
    # H = 32: a full width of short k-mers (256, the width it pads to)
    # keeps more than the 16 slots a query in both sections
    cfg = ServeConfig(batch_size=512, max_hits=32, resolve_budget_frac=0.05)
    kms = ["".join("ACGT"[c - 1] for c in row) for row in _queries(
        corpus, 200, 31, seed=9)[0]] + ["ACGTAC", "GGATC"]
    short = ["ACG", "TTA", "GAT", "CCA"] * 64
    calls = (dict(), dict(include_hits=False), dict(both_strands=True))
    engines = {}
    for name, make in (("single", lambda d: QueryEngine(packed, cfg,
                                                        device=d)),
                       ("cohort", lambda d: MultiEngine(parts, cfg,
                                                        device=d))):
        cpu, card = make("cpu"), make(cuda_device)
        want = [cpu.query_batch(q, **kw) for q in (kms, short)
                for kw in calls]
        engines[name] = (card, want)

    def refuse(*args, **kw):
        raise AssertionError("a plain pack ran on the card")

    for fn in ("sparse_pack_plain", "pack_answer_plain", "merge_pack_plain",
               "_compact_cols"):
        monkeypatch.setattr(pack_ops, fn, refuse)
    for name, (card, want) in engines.items():
        kernel = SPARSE_PACK if name == "single" else MERGE_PACK
        before = kernel.launches
        got = [card.query_batch(q, **kw) for q in (kms, short)
               for kw in calls]
        assert got == want, name
        torch.cuda.synchronize()
        assert kernel.launches >= before + 6, name
        stats = card.pack_stats
        assert stats["hits_dense_fallbacks"] > 0, name
        assert stats["hist_dense_fallbacks"] > 0, name
