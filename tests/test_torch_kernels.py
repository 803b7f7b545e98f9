"""The port's CUDA kernels against their plain torch forms, on the card.

This file imports no jax, so it also runs where jax is absent (the card's
machine), without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Every test needs a CUDA card and skips without one; the CPU parity of the
plain forms with the JAX package is in test_torch_{rank,search,lut}.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from readserver_tpu_torch.corpus import simulate
from readserver_tpu_torch.index import build_index
from readserver_tpu_torch.kernels import BACKWARD_SEARCH, RANK_OCC
from readserver_tpu_torch.ops import (
    DeviceIndex,
    backward_search,
    backward_search_lut,
    backward_search_pair,
    build_prefix_lut,
    encode_query_batch,
)
from readserver_tpu_torch.ops import lut as lut_ops
from readserver_tpu_torch.ops import rank as rank_ops
from readserver_tpu_torch.ops import search as search_ops
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
    before = RANK_OCC.launches
    lut = build_prefix_lut(dev, P)
    assert RANK_OCC.launches == before + P - 1
    plain = build_prefix_lut(DeviceIndex.from_packed(packed[1], "cpu"), P)
    assert torch.equal(lut.cpu(), plain)
    before = RANK_OCC.launches
    on_card = lut_ops.build_prefix_lut_plain(dev, P)
    assert RANK_OCC.launches == before
    assert torch.equal(lut, on_card)


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
