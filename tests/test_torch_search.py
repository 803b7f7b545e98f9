"""Port's backward search (ops/search.py) against the JAX package's, bit for
bit: the masked 1-step search on mixed lengths, the LUT start, and the
k-step schedule with and without the LUT, with tiers {rank2, rank3} and
{rank2}, for remainders of 0, 1 and 2 columns — misses as canonical (0, 0)."""

import jax
import numpy as np
import pytest
import torch

from readserver_tpu.corpus.simulate import sample_query_kmers
from readserver_tpu.index import build_index
from readserver_tpu.ops import DeviceIndex as JaxDeviceIndex
from readserver_tpu.ops import backward_search as jax_backward_search
from readserver_tpu.ops import backward_search_lut as jax_backward_search_lut
from readserver_tpu.ops import backward_search_pair as jax_backward_search_pair
from readserver_tpu.ops import build_prefix_lut as jax_build_prefix_lut
from readserver_tpu_torch.kernels import BACKWARD_SEARCH
from readserver_tpu_torch.ops import (
    DeviceIndex,
    backward_search,
    backward_search_lut,
    backward_search_pair,
    encode_query_batch,
    lut_from_numpy,
    prefix_ids,
)
from readserver_tpu_torch.ops import search as search_ops
from readserver_tpu_torch.ops.types import ARRAY_FIELDS, STATIC_FIELDS
from torch_common import np_of, t32

P = 5
TIERS = {"rank2+rank3": {"rank2", "rank3"}, "rank2": {"rank2"}}


@pytest.fixture(scope="module")
def setup(small_corpus):
    packed = build_index(small_corpus.reads, sample_ids=small_corpus.sample_ids)
    jdevs = {k: JaxDeviceIndex.from_packed(packed, tiers=t) for k, t in TIERS.items()}
    tdevs = {k: DeviceIndex.from_packed(packed, "cpu", tiers=t) for k, t in TIERS.items()}
    jlut = jax_build_prefix_lut(jdevs["rank2"], P)
    return small_corpus, packed, jdevs, tdevs, jlut, lut_from_numpy(np.asarray(jlut), "cpu")


def _batch(corpus, n, k, seed, miss_frac=0.3, min_len=None):
    """n queries, right-aligned in k columns; lengths in [min_len, k] when
    ``min_len`` is given, else all k."""
    kms = sample_query_kmers(corpus, n, k, seed=seed, miss_frac=miss_frac)
    if min_len is not None:
        rng = np.random.default_rng(seed + 1)
        lens = rng.integers(min_len, k + 1, size=n)
        kms = [km[k - L :] for km, L in zip(kms, lens)]
    return encode_query_batch(kms, k)


def _check(got, want):
    l1, u1 = (np_of(x) for x in got)
    l2, u2 = (np.asarray(x) for x in want)
    assert l1.dtype == np.int32 and u1.dtype == np.int32
    assert np.array_equal(l1, l2) and np.array_equal(u1, u2)
    empty = u1 <= l1
    assert (l1[empty] == 0).all() and (u1[empty] == 0).all()
    return int(empty.sum())


@pytest.mark.parametrize("miss_frac", [0.3, 1.0])
def test_backward_search_mixed_lengths(setup, miss_frac):
    corpus, _, jdevs, tdevs, _, _ = setup
    codes, lengths = _batch(corpus, 200, 32, seed=1, miss_frac=miss_frac,
                            min_len=1)
    got = backward_search(tdevs["rank2"], t32(codes), t32(lengths))
    want = jax.jit(jax_backward_search)(jdevs["rank2"], codes, lengths)
    assert _check(got, want) > 0  # misses covered


def test_backward_search_lut_p5(setup):
    corpus, _, jdevs, tdevs, jlut, tlut = setup
    codes, lengths = _batch(corpus, 200, 20, seed=2, min_len=P)
    got = backward_search_lut(tdevs["rank2"], tlut, P, t32(codes), t32(lengths))
    want = jax.jit(
        lambda d, t, c, ln: jax_backward_search_lut(d, t, P, c, ln)
    )(jdevs["rank2"], jlut, codes, lengths)
    _check(got, want)


@pytest.mark.parametrize("tiers", sorted(TIERS))
@pytest.mark.parametrize("use_lut", [False, True])
@pytest.mark.parametrize("rem", [0, 1, 2])
def test_backward_search_pair(setup, tiers, use_lut, rem):
    corpus, _, jdevs, tdevs, jlut, tlut = setup
    # columns after the start: K - P with the LUT, K - 1 without; pick K
    # so that they leave ``rem`` columns after the greedy triples
    K = (P if use_lut else 1) + 9 + rem
    codes, _ = _batch(corpus, 160, K, seed=10 + rem)
    got = backward_search_pair(
        tdevs[tiers], t32(codes), tlut if use_lut else None, P if use_lut else 0
    )
    want = jax.jit(
        lambda d, t, c: jax_backward_search_pair(d, c, t, P if use_lut else 0)
    )(jdevs[tiers], jlut if use_lut else None, codes)
    _check(got, want)
    # and the same bits as the port's masked 1-step search
    one = backward_search(tdevs[tiers], t32(codes), t32(np.full(len(codes), K)))
    assert all(torch.equal(a, b) for a, b in zip(got, one))


def test_prefix_ids_match_lut_order(setup):
    corpus, *_ = setup
    codes, _ = _batch(corpus, 50, 12, seed=4)
    ids = np_of(prefix_ids(t32(codes), P))
    tail = codes[:, -P:] - 1
    want = sum(tail[:, t] * 4 ** (P - 1 - t) for t in range(P))
    assert np.array_equal(ids, want)


def test_encode_matches_jax(setup):
    from readserver_tpu.ops import encode_query_batch as jax_encode

    corpus, *_ = setup
    kms = sample_query_kmers(corpus, 40, 15, seed=6)
    strs = ["".join("ACGT"[c - 1] for c in km[: 3 + i % 12]) for i, km in enumerate(kms)]
    for batch in (kms, strs):
        got = encode_query_batch(batch, 32)
        want = jax_encode(batch, 32)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="non-ACGT"):
        encode_query_batch(["ACGN"], 8)


def test_state_from_jax_device_index(setup):
    """A DeviceIndex carried across from the JAX one's leaves answers the
    same as the JAX one."""
    corpus, _, jdevs, _, jlut, _ = setup
    jdev = jdevs["rank2+rank3"]
    arrays = {
        f: None if getattr(jdev, f) is None else np.asarray(getattr(jdev, f))
        for f in ARRAY_FIELDS
    }
    meta = {f: getattr(jdev, f) for f in STATIC_FIELDS}
    tdev = DeviceIndex.from_numpy(arrays, meta, "cpu")
    assert tdev.device_bytes() == jdev.device_bytes()
    tlut = lut_from_numpy(np.asarray(jlut), "cpu")
    K = 15
    codes, lengths = _batch(corpus, 120, K, seed=21)
    got = backward_search_pair(tdev, t32(codes), tlut, P)
    want = jax.jit(lambda d, t, c: jax_backward_search_pair(d, c, t, P))(
        jdev, jlut, codes
    )
    _check(got, want)
    got = backward_search(tdev, t32(codes), t32(lengths))
    _check(got, jax.jit(jax_backward_search)(jdev, codes, lengths))
    with pytest.raises(ValueError, match="unknown"):
        DeviceIndex.from_numpy({"bogus": np.zeros(1)}, meta, "cpu")


def test_cpu_search_launches_no_kernel(setup):
    corpus, _, _, tdevs, _, tlut = setup
    before = BACKWARD_SEARCH.launches
    codes, _ = _batch(corpus, 8, 15, seed=3)
    backward_search_pair(tdevs["rank2"], t32(codes), tlut, P)
    assert BACKWARD_SEARCH.launches == before
    with pytest.raises(ValueError):
        search_ops.backward_search_cuda(tdevs["rank2"], t32(codes), kstep=True)


def _bad_inputs(K=12):
    """(name, kmers, lengths, p): inputs every search path must refuse."""
    ok = np.tile(np.arange(1, K + 1) % 4 + 1, (4, 1)).astype(np.int32)
    zero_col = ok.copy()
    zero_col[2, 0] = 0
    five = ok.copy()
    five[1, K - 3] = 5
    full = np.full(4, K, dtype=np.int32)
    short = full.copy()
    short[3] = 3
    pad = ok.copy()
    pad[3, : K - 3] = 0
    return {
        "k-step, 0 in a column": (zero_col, None, 0),
        "k-step, code 5": (five, None, 0),
        "1-step, code 5 in an active column": (five, full, 0),
        "1-step, length 0": (ok, np.where(np.arange(4) == 0, 0, K), 0),
        "1-step, length > K": (ok, np.where(np.arange(4) == 0, K + 1, K), 0),
        "LUT, length < p reads padding": (pad, short, P),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_search_refuses_bad_codes(setup, case):
    """Codes outside 1..4 in a searched column (or a length outside [1, K])
    raise, on every path; 0 padding outside the searched columns does not."""
    _, _, _, tdevs, _, tlut = setup
    kmers, lengths, p = _bad_inputs()[case]
    d = tdevs["rank2+rank3"]
    with pytest.raises(ValueError, match="outside 1..4"):
        if lengths is None:
            backward_search_pair(d, t32(kmers), tlut if p else None, p)
        elif p:
            backward_search_lut(d, tlut, p, t32(kmers), t32(lengths))
        else:
            backward_search(d, t32(kmers), t32(lengths))


def test_search_accepts_padding_outside_searched_columns(setup):
    _, _, _, tdevs, _, tlut = setup
    kmers, _, _ = _bad_inputs()["LUT, length < p reads padding"]
    lengths = t32(np.array([12, 12, 12, 3]))
    backward_search(tdevs["rank2"], t32(kmers), lengths)
    kmers[3, 12 - P :] = kmers[0, 12 - P :]
    lengths[3] = P
    backward_search_lut(tdevs["rank2"], tlut, P, t32(kmers), lengths)
