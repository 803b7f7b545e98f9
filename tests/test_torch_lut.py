"""Port's prefix LUT (ops/lut.py) against the JAX package's build, entry for
entry, including the chunked level extension with ragged chunks."""

import numpy as np
import pytest

from readserver_tpu.index import build_index
from readserver_tpu.ops import lut as jax_lut
from readserver_tpu.ops import DeviceIndex as JaxDeviceIndex
from readserver_tpu.ops import build_prefix_lut as jax_build_prefix_lut
from readserver_tpu.ops import default_lut_order as jax_default_lut_order
from readserver_tpu_torch.ops import (
    DeviceIndex,
    build_prefix_lut,
    default_lut_order,
)
from readserver_tpu_torch.ops.lut import (
    build_prefix_lut_plain,
    extend_level,
    extend_level_plain,
)
from torch_common import np_of, t32


@pytest.fixture(scope="module")
def setup(small_corpus):
    packed = build_index(small_corpus.reads, sample_ids=small_corpus.sample_ids)
    return JaxDeviceIndex.from_packed(packed), DeviceIndex.from_packed(packed, "cpu")


@pytest.mark.parametrize("p", [1, 4, 6])
def test_lut_matches_jax(setup, p):
    jdev, tdev = setup
    got = np_of(build_prefix_lut(tdev, p))
    want = np.asarray(jax_build_prefix_lut(jdev, p))
    assert got.shape == (4**p, 2) and got.dtype == np.int32
    assert np.array_equal(got, want)
    empty = got[:, 0] >= got[:, 1]
    assert (got[empty] == 0).all()


@pytest.mark.parametrize("max_chunk", [5, 16, 1])
def test_chunked_lut_matches_unchunked_and_jax(setup, max_chunk):
    """max_chunk=5 cuts every level above it into ragged chunks (16 = 5+5+5+1)."""
    jdev, tdev = setup
    p = 4
    got = np_of(build_prefix_lut(tdev, p, max_chunk=max_chunk))
    assert np.array_equal(got, np_of(build_prefix_lut(tdev, p)))
    assert np.array_equal(
        got, np.asarray(jax_build_prefix_lut(jdev, p, max_chunk=max_chunk))
    )


@pytest.mark.parametrize("p", [1, 4, 6])
def test_plain_lut_matches_jax(setup, p):
    """The plain-rank form, the card's reference for K1's LUT."""
    jdev, tdev = setup
    got = np_of(build_prefix_lut_plain(tdev, p, max_chunk=5))
    assert np.array_equal(got, np.asarray(jax_build_prefix_lut(jdev, p)))


@pytest.mark.parametrize("level", [1, 4, 6])
def test_extend_level_matches_jax(setup, level):
    """One level step, plain form and the level entry's CPU path, against
    the JAX package's ``_extend_level`` on the same level-ℓ intervals, with
    frozen empties: every third interval is made empty (l > u) and must
    come through unchanged in each of its four c-blocks."""
    jdev, tdev = setup
    l, u = np.asarray(jdev.C[1:5]), np.asarray(jdev.C[2:6])
    for lvl in range(1, level):
        l, u = (np.asarray(x) for x in
                jax_lut._extend_level(jdev, l, u, 4**lvl))
    l, u = l.copy(), u.copy()
    l[::3], u[::3] = u[::3] + 2, u[::3]
    want = [np.asarray(x) for x in jax_lut._extend_level(jdev, l, u, l.size)]
    got = extend_level_plain(tdev, t32(l), t32(u))
    assert all(np.array_equal(np_of(g), w) for g, w in zip(got, want))
    nl, nu = extend_level(tdev, t32(l), t32(u))
    assert np.array_equal(np_of(nl), want[0])
    assert np.array_equal(np_of(nu), want[1])
    frozen = np.tile(np.arange(l.size) % 3 == 0, 4)
    assert np.array_equal(want[0][frozen], np.tile(l[::3], 4))
    pairs = np_of(extend_level(tdev, t32(l), t32(u), last=True))
    empty = want[0] >= want[1]
    assert np.array_equal(pairs[~empty], np.stack(want, 1)[~empty])
    assert (pairs[empty] == 0).all()


def test_lut_rejects_bad_arguments(setup):
    _, tdev = setup
    with pytest.raises(ValueError, match="order"):
        build_prefix_lut(tdev, 0)
    with pytest.raises(ValueError, match="order"):
        build_prefix_lut(tdev, 16)
    with pytest.raises(ValueError, match="max_chunk"):
        build_prefix_lut(tdev, 3, max_chunk=0)


@pytest.mark.parametrize(
    "n", [0, 1, 1000, 303_750, 6_969_000, 139_380_000, 1_939_000_000]
)
def test_default_lut_order_matches_jax(n):
    assert default_lut_order(n) == jax_default_lut_order(n)
