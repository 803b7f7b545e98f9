"""Port's rank (ops/rank.py) against the JAX package's: the XLA form, the
Pallas kernel in interpret mode, and the scalar NumPy reference, on the
base, pair and triple tables — block edges and i = n included.  K1's
wrapper (its checks, and the scratch its bucketed design takes) runs
against a stand-in library here; the kernel itself is held against the
plain form on the card (tests/test_torch_kernels.py)."""

import ctypes

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
from readserver_tpu_torch.kernels import build as kbuild
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


def _edge_probes(n, planes, B, seed):
    """B ranks over every plane with i = 0 and i = n first."""
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n + 1, size=B)
    i[: min(B, 2)] = [0, n][: min(B, 2)]
    return (np.arange(B) % planes).astype(np.int32), i.astype(np.int32)


@pytest.mark.parametrize("B", [0, 1, 3, 1025])
@pytest.mark.parametrize("table", ["base", "rank2"])
def test_occ_rows_batch_edges_match_jax(setup, table, B):
    """The plain rank at K1's batch edges (B = 0 and 1, B not a multiple
    of the four ranks a thread carries nor of a block's 1,024) with i = 0
    and i = n and every plane equals the JAX XLA rank."""
    _, jdev, tdev = setup
    field, _, planes = TABLES[table]
    c, i = _edge_probes(tdev.n, planes, B, seed=B)
    got = np_of(rank_ops.occ_rows(getattr(tdev, field), t32(c), t32(i),
                                  **_layout(tdev)))
    want = np.asarray(jax_rank.occ_rows(getattr(jdev, field), c, i,
                                        **_layout(jdev)))
    assert got.shape == (B,) and np.array_equal(got, want)


@pytest.mark.parametrize("B", [1, 129])
def test_occ_rows_batch_edges_match_pallas_interpret(setup, B):
    """The same edges against the Pallas kernel in interpret mode: one
    rank, and one past a 128-query tile, on the pair table's planes."""
    _, jdev, tdev = setup
    c, i = _edge_probes(tdev.n, 16, B, seed=B + 1)
    got = np_of(rank_ops.occ_rows(tdev.rank2_rows, t32(c), t32(i),
                                  **_layout(tdev)))
    want = np.asarray(occ_pallas_rows(
        jdev.rank2_rows, jax.numpy.asarray(c), jax.numpy.asarray(i),
        **_layout(jdev), interpret=True))
    assert np.array_equal(got, want)


class _FakeRankLibrary:
    """Stands in for the kernel library: sizes K1's scratch as told, and
    answers rs_rank_occ with the plain form through the pointers it was
    handed, recording each call."""

    def __init__(self, scratch: int):
        self.scratch = scratch
        self.calls = []

    def rs_rank_occ_scratch(self, B, table_rows, log2_block, row_words, out):
        self.calls.append(("scratch", B, table_rows, log2_block, row_words))
        out[0] = self.scratch
        return 0

    def rs_rank_occ(self, table, c, i, out, B, rps, lg, wpb, rw, rows,
                    scratch, nbytes, stream):
        self.calls.append(("launch", B, rps, lg, wpb, rw, rows, scratch,
                           nbytes, stream))

        def view(p, count):
            return torch.from_numpy(np.ctypeslib.as_array(
                (ctypes.c_int32 * count).from_address(p)))

        got = rank_ops.occ_rows_plain(
            view(table, rows * rw).view(rows, rw), view(c, B), view(i, B),
            rows_per_symbol=rps, log2_block=lg, words_per_block=wpb)
        view(out, B)[:] = got
        return 0


@pytest.mark.parametrize("scratch", [0, 1 << 16])
def test_rank_wrapper_through_the_fake_library(setup, monkeypatch, scratch):
    """K1's wrapper asks the library for its scratch (0: the direct design,
    and none is allocated) and hands the kernel the table's rows, the
    scratch and its size; the kernel's answer comes back as the output."""
    _, _, tdev = setup
    lib = _FakeRankLibrary(scratch)
    monkeypatch.setattr(kbuild.LIBRARY, "get", lambda: lib)
    monkeypatch.setattr(RANK_OCC, "_fn", None)  # bound at the first launch
    monkeypatch.setattr(rank_ops, "_check_table", lambda t: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    c, i = _probes(tdev.n, tdev.block_size, 5, seed=2, size=300)
    before = RANK_OCC.launches
    got = rank_ops.occ_rows_cuda(tdev.rank_rows, t32(c), t32(i),
                                 **_layout(tdev))
    assert RANK_OCC.launches == before + 1
    assert torch.equal(got, rank_ops.occ_rows_plain(
        tdev.rank_rows, t32(c), t32(i), **_layout(tdev)))
    rows, rw = tdev.rank_rows.shape
    (_, B, *sized), (_, *launch) = lib.calls
    assert (B, *sized) == (len(c), rows, tdev.log2_block, rw)
    assert launch[:6] == [len(c), tdev.rows_per_symbol, tdev.log2_block,
                          tdev.words_per_block, rw, rows]
    assert (launch[6] is None) == (scratch == 0) and launch[7] == scratch
    assert launch[8] == 1000
    # an empty batch asks nothing and launches nothing
    lib.calls.clear()
    empty = rank_ops.occ_rows_cuda(tdev.rank_rows, t32([]), t32([]),
                                   **_layout(tdev))
    assert empty.shape == (0,) and lib.calls == []


@pytest.mark.parametrize("bad", ["int64 c", "2-D i", "shapes differ"])
def test_rank_wrapper_refuses_what_the_kernel_cannot_read(setup, monkeypatch,
                                                          bad):
    _, _, tdev = setup
    monkeypatch.setattr(rank_ops, "_check_table", lambda t: None)
    c, i = t32([1, 2, 3]), t32([4, 5, 6])
    if bad == "int64 c":
        c = c.long()
    elif bad == "2-D i":
        i = i.view(3, 1)
    else:
        i = i[:2]
    with pytest.raises(ValueError):
        rank_ops.occ_rows_cuda(tdev.rank_rows, c, i, **_layout(tdev))
