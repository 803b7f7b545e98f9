"""Port's rank (ops/rank.py) against the JAX package's: the XLA form, the
Pallas kernel in interpret mode, and the scalar NumPy reference, on the
base, pair and triple tables — block edges and i = n included."""

import jax
import numpy as np
import pytest
import torch

from readserver_tpu.index import build_index
from readserver_tpu.index.packing import occ_scalar
from readserver_tpu.kernels.pallas_rank import occ_pallas_rows
from readserver_tpu.ops import DeviceIndex as JaxDeviceIndex
from readserver_tpu.ops import rank as jax_rank
from readserver_tpu_torch.kernels import RANK_OCC
from readserver_tpu_torch.ops import DeviceIndex
from readserver_tpu_torch.ops import rank as rank_ops
from torch_common import np_of, t32

TABLES = {  # name → (DeviceIndex field, PackedIndex field, planes)
    "base": ("rank_rows", "rank_blocks", 5),
    "rank2": ("rank2_rows", "rank2_blocks", 16),
    "rank3": ("rank3_rows", "rank3_blocks", 64),
}


@pytest.fixture(scope="module")
def setup(small_corpus):
    packed = build_index(small_corpus.reads, sample_ids=small_corpus.sample_ids)
    assert packed.rank3_blocks is not None
    return packed, JaxDeviceIndex.from_packed(packed), DeviceIndex.from_packed(
        packed, "cpu"
    )


def _probes(n, S, planes, seed, size=2048, nblocks=64):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, n // S, size=nblocks)
    edges = np.concatenate(
        [[0, 1, S - 1, S, S + 1, n - 1, n], blocks * S, blocks * S + S - 1]
    )
    i = np.concatenate([rng.integers(0, n + 1, size=size), edges])
    c = rng.integers(0, planes, size=len(i))
    return c.astype(np.int32), i.astype(np.int32)


def _layout(dev):
    return dict(
        rows_per_symbol=dev.rows_per_symbol,
        log2_block=dev.log2_block,
        words_per_block=dev.words_per_block,
    )


@pytest.mark.parametrize("table", sorted(TABLES))
def test_occ_rows_matches_jax_and_scalar(setup, table):
    packed, jdev, tdev = setup
    field, packed_field, planes = TABLES[table]
    c, i = _probes(tdev.n, tdev.block_size, planes, seed=planes)
    got = np_of(
        rank_ops.occ_rows(getattr(tdev, field), t32(c), t32(i), **_layout(tdev))
    )
    want = np.asarray(
        jax_rank.occ_rows(getattr(jdev, field), c, i, **_layout(jdev))
    )
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    blocks3 = getattr(packed, packed_field)
    scalar = [
        occ_scalar(blocks3, packed.config, int(cc), int(ii))
        for cc, ii in zip(c[-200:], i[-200:])
    ]
    assert np.array_equal(got[-200:], scalar)


@pytest.mark.parametrize("table", sorted(TABLES))
def test_occ_rows_matches_pallas_interpret(setup, table):
    _, jdev, tdev = setup
    field, _, planes = TABLES[table]
    # one 128-query tile: interpret mode runs each row DMA in Python
    c, i = _probes(tdev.n, tdev.block_size, planes, seed=7, size=64, nblocks=16)
    got = np_of(
        rank_ops.occ_rows(getattr(tdev, field), t32(c), t32(i), **_layout(tdev))
    )
    want = np.asarray(
        occ_pallas_rows(
            getattr(jdev, field), jax.numpy.asarray(c), jax.numpy.asarray(i),
            **_layout(jdev), interpret=True,
        )
    )
    assert np.array_equal(got, want)


def test_occ_matches_jax_occ(setup):
    _, jdev, tdev = setup
    c, i = _probes(tdev.n, tdev.block_size, 5, seed=3)
    got = np_of(rank_ops.occ(tdev, t32(c), t32(i)))
    assert np.array_equal(got, np.asarray(jax_rank.occ(jdev, c, i)))


def test_popcount32_matches_python():
    rng = np.random.default_rng(0)
    words = np.concatenate(
        [[0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0x55555555],
         rng.integers(0, 1 << 32, size=1000, dtype=np.int64)]
    )
    got = rank_ops.popcount32(torch.from_numpy(words)).numpy()
    assert got.tolist() == [bin(int(w)).count("1") for w in words]


def test_cpu_tensors_take_the_plain_form(setup):
    _, _, tdev = setup
    before = RANK_OCC.launches
    c, i = _probes(tdev.n, tdev.block_size, 5, seed=9, size=16)
    got = rank_ops.occ(tdev, t32(c), t32(i))
    plain = rank_ops.occ_rows_plain(
        tdev.rank_rows, t32(c), t32(i), **_layout(tdev)
    )
    assert torch.equal(got, plain)
    assert RANK_OCC.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        rank_ops.occ_rows_cuda(tdev.rank_rows, t32(c), t32(i), **_layout(tdev))
