"""The port's ingest and index maintenance (corpus/io.py, corpus/bam.py,
index/rle.py, index/upgrade.py and the CLI's host commands) against the
JAX package's: the same input files and arguments go through
``readserver_tpu.cli.main`` and ``readserver_tpu_torch.cli.main`` (each
into its own directory), the artifacts they write are byte-equal (every
``.npy``, every manifest), their messages equal (paths and seconds aside),
and the port's ``query --device cpu`` prints the JAX CLI's JSON lines.
The cases mirror tests/test_cli.py, test_corpus_io.py, test_bam.py,
test_merge_rle.py, test_upgrade.py and the CLI, append and compact tests
of test_cohort_build.py.  Queries on both strands stay at 16 k-mers or
fewer, where the JAX CLI's batch holds them (ROADMAP §3)."""

import dataclasses
import json
import re
import shutil

import numpy as np
import pytest

from readserver_tpu import alphabet as jax_alphabet
from readserver_tpu import cli as jax_cli
from readserver_tpu.config import ServeConfig as JaxServeConfig
from readserver_tpu.corpus import bam as jax_bam
from readserver_tpu.corpus import io as jax_io
from readserver_tpu.corpus.simulate import sample_query_kmers
from readserver_tpu.index import build_index as jax_build_index
from readserver_tpu.index import cohort as jax_cohort
from readserver_tpu.index import merge as jax_merge
from readserver_tpu.index import rle as jax_rle
from readserver_tpu.index import upgrade as jax_upgrade
from readserver_tpu.serve import QueryEngine as JaxQueryEngine
from readserver_tpu_torch import alphabet, cli
from readserver_tpu_torch.config import IndexConfig, ServeConfig
from readserver_tpu_torch.corpus import bam, io as cio
from readserver_tpu_torch.index import artifact, build_index, cohort, merge
from readserver_tpu_torch.index import rle, upgrade
from readserver_tpu_torch.index.packing import unpack_sym4
from readserver_tpu_torch.oracle import naive_count
from readserver_tpu_torch.serve import MultiEngine, QueryEngine

SIDES = {"jax": jax_cli.main, "port": cli.main}
OPTIONAL = [
    "lf", "mark_rank", "sample_pairs", "dsa", "fused_rows",
    "rank2_blocks", "C2", "rank3_blocks", "C3",
]


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def assert_same_tree(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for rel in fa:
        assert fa[rel] == fb[rel], f"{rel} differs"


def assert_restored(built, upgraded):
    """An upgraded tree against the tree as built: every file byte-equal
    but the manifests, which equal it up to the order of their array
    lists (the upgrade appends what it adds)."""
    fa, fb = _files(built), _files(upgraded)
    assert sorted(fa) == sorted(fb)
    for rel in fa:
        if rel.endswith(artifact.MANIFEST_NAME):
            a, b = json.loads(fa[rel]), json.loads(fb[rel])
            a["arrays"], b["arrays"] = sorted(a["arrays"]), sorted(b["arrays"])
            assert a == b, f"{rel} differs"
        else:
            assert fa[rel] == fb[rel], f"{rel} differs"


def _norm(err: str, root) -> str:
    """A CLI's stderr with its side's directory and its seconds masked."""
    return re.sub(r"\d+\.\d+s", "Xs", err.replace(str(root), "<root>"))


def run_both(capsys, tmp_path, argv, rc=0):
    """``argv(root)`` through both CLIs, each with its own root under
    ``tmp_path``; the exit codes, stdout and masked stderr equal →
    (root of the JAX side, root of the port's side, stdout)."""
    outs = {}
    for side, main in SIDES.items():
        root = tmp_path / side
        root.mkdir(exist_ok=True)
        capsys.readouterr()
        args = argv(root)
        if side == "port" and args[0] == "query":
            args = [*args, "--device", "cpu"]
        assert main(args) == rc, side
        out, err = capsys.readouterr()
        outs[side] = (out, _norm(err, root))
    assert outs["jax"] == outs["port"]
    return tmp_path / "jax", tmp_path / "port", outs["port"][0]


def run_both_trees(capsys, tmp_path, argv, name):
    """``run_both``, then the directory ``name`` equal byte for byte."""
    j, p, out = run_both(capsys, tmp_path, argv)
    assert_same_tree(j / name, p / name)
    return j, p, out


def _query_lines(out):
    return [json.loads(x) for x in out.splitlines()]


def _mk_reads(rng, n):
    return [alphabet.decode(rng.integers(1, 5, size=40).astype(np.uint8))
            for _ in range(n)]


def _fasta(path, reads, prefix="r"):
    cio.write_fasta(path, ((f"{prefix}{i}", s) for i, s in enumerate(reads)))
    return path


def _tiny_fasta(path, reads):
    return _fasta(path, [alphabet.decode(r) for r in reads], "read_")


# ---------------------------------------------------------- tests/test_cli.py


def test_cli_round_trip_matches_jax(tmp_path, capsys):
    """build --fasta x2 → merge --interleave → query → RLE export →
    import-bwt → query: every artifact byte-equal to the JAX CLI's, every
    count equal to the oracle's (``test_cli_round_trip``)."""
    rng = np.random.default_rng(42)
    reads1, reads2 = _mk_reads(rng, 30), _mk_reads(rng, 20)
    f1 = _fasta(tmp_path / "s1.fa", reads1)
    f2 = _fasta(tmp_path / "s2.fa", reads2)
    for f, name in ((f1, "idx1"), (f2, "idx2")):
        run_both_trees(capsys, tmp_path, lambda r, f=f, name=name: [
            "build", "--fasta", str(f), "--out", str(r / name)], name)
    run_both_trees(capsys, tmp_path, lambda r: [
        "merge", str(r / "idx1"), str(r / "idx2"), "--interleave",
        "--out", str(r / "pop")], "pop")
    all_reads = [alphabet.encode(s) for s in reads1 + reads2]
    km = reads1[0][5:25]
    *_, out = run_both(capsys, tmp_path, lambda r: [
        "query", "--index", str(r / "pop"), "--kmer", km])
    assert _query_lines(out)[0]["count"] == naive_count(all_reads, km)

    packed = artifact.load_artifact(tmp_path / "port" / "pop", mmap=False)
    rle_path = tmp_path / "pop.rlebwt"
    rle.write_rle_bwt(rle_path, unpack_sym4(packed.sym4, packed.n),
                      packed.num_reads)
    run_both_trees(capsys, tmp_path, lambda r: [
        "import-bwt", "--bwt", str(rle_path), "--out", str(r / "imp")], "imp")
    *_, out = run_both(capsys, tmp_path, lambda r: [
        "query", "--index", str(r / "imp"), "--kmer", km])
    assert _query_lines(out)[0]["count"] == naive_count(all_reads, km)


@pytest.mark.parametrize("flags", [["--both-strands"],
                                   ["--both-strands", "--hits", "--samples"]])
def test_cli_query_both_strands_matches_jax(tmp_path, capsys, flags):
    """``test_cli_query_both_strands``: the same JSON lines from both
    CLIs, the count the oracle's on both strands."""
    rng = np.random.default_rng(43)
    reads = _mk_reads(rng, 15)
    f1 = _fasta(tmp_path / "s.fa", reads)
    run_both_trees(capsys, tmp_path, lambda r: [
        "build", "--fasta", str(f1), "--out", str(r / "idx")], "idx")
    km = reads[3][10:30]
    rc = alphabet.decode(alphabet.revcomp(alphabet.encode(km)))
    codes = [alphabet.encode(s) for s in reads]
    want = naive_count(codes, km) + (naive_count(codes, rc) if rc != km else 0)
    *_, out = run_both(capsys, tmp_path, lambda r: [
        "query", "--index", str(r / "idx"), "--kmer", km, *flags])
    assert _query_lines(out)[0]["count"] == want


# --------------------------------------------------- tests/test_corpus_io.py


def test_fasta_roundtrip_matches_jax(tmp_path):
    recs = [("r1", "ACGT"), ("r2", "GGGGTTTT"), ("r3", "A" * 70)]
    cio.write_fasta(tmp_path / "p.fasta", recs)
    jax_io.write_fasta(tmp_path / "j.fasta", recs)
    assert (tmp_path / "p.fasta").read_bytes() == (
        tmp_path / "j.fasta").read_bytes()
    assert list(cio.read_fasta(tmp_path / "j.fasta")) == recs


@pytest.mark.parametrize("gz", [False, True])
def test_fastq_parse_matches_jax(tmp_path, gz):
    import gzip

    text = "@a desc\nACGT\n+\nIIII\n@b\nTTGG\n+\n!!!!\n"
    p = tmp_path / ("x.fastq.gz" if gz else "x.fastq")
    if gz:
        with gzip.open(p, "wt") as fh:
            fh.write(text)
    else:
        p.write_text(text)
    assert list(cio.read_fastq(p)) == [("a", "ACGT"), ("b", "TTGG")]
    assert list(cio.read_fastq(p)) == list(jax_io.read_fastq(p))
    assert list(cio.read_fastq_quals(p)) == list(jax_io.read_fastq_quals(p))


@pytest.mark.parametrize("seq,min_len", [
    ("ACGT" * 10 + "N" + "TTTT" * 10, 20),
    ("ACGTN" * 5, 4),
    ("NNNNNN", 20),
    ("", 20),
    ("acgtRYacgtacgtacgtacgtacgtacgt", 5),
])
def test_normalizer_matches_jax(seq, min_len):
    got = cio.normalize_read(seq, min_len=min_len)
    want = jax_io.normalize_read(seq, min_len=min_len)
    assert len(got) == len(want)
    assert all(g.dtype == w.dtype and np.array_equal(g, w)
               for g, w in zip(got, want))


def test_rlo_sort_matches_jax(tiny_corpus):
    reads = tiny_corpus.reads[:100]
    sids = np.arange(100, dtype=np.int32)
    out, perm = cio.rlo_sort(reads, sids)
    want, want_perm = jax_io.rlo_sort(reads, sids)
    assert np.array_equal(perm, want_perm)
    assert all(np.array_equal(a, b) for a, b in zip(out, want))
    assert np.array_equal(cio.rlo_order(reads), jax_io.rlo_order(reads))
    revs = [tuple(r[::-1]) for r in out]
    assert revs == sorted(revs)


@pytest.mark.parametrize("quals", [
    np.full(50, 35),
    np.concatenate([np.full(40, 35), np.full(10, 5)]),
    np.where(np.arange(50) == 45, 2, 35),
    np.full(30, 2),
    "I" * 30 + "#" * 8,
    "",
])
def test_mott_trim_matches_jax(quals):
    got = cio.mott_trim_len(quals, threshold=20)
    assert got == jax_io.mott_trim_len(quals, threshold=20)


@pytest.mark.parametrize("extra", [[], ["--rlo"], ["--min-len", "24"]])
def test_cli_fastq_qual_trim_matches_jax(tmp_path, capsys, extra):
    """``test_cli_fastq_qual_trim``, with an N-split read, the RLO sort and
    a min-len cut."""
    fq = tmp_path / "r.fq"
    good, bad = "ACGTACGTACGTACGTACGTACGT", "GGGGGGGG"
    fq.write_text(
        f"@r1\n{good}{bad}\n+\n{'I'*len(good)}{'#'*len(bad)}\n"
        f"@r2\n{good}\n+\n{'I'*len(good)}\n"
        f"@r3\nTTTTACGANNACGTACGTACGTACGTACGTAAC\n+\n{'I'*33}\n"
        f"@r4\n{good}N{good}\n+\n{'I'*49}\n"
    )
    j, p, _ = run_both_trees(capsys, tmp_path, lambda r: [
        "build", "--fastq", str(fq), "--out", str(r / "idx"),
        "--qual-trim", "20", *extra], "idx")
    packed = artifact.load_artifact(p / "idx", mmap=False)
    if not extra:
        # r4 splits at its N into two reads, named r4.0 and r4.1
        assert packed.num_reads == 5
        assert sorted(np.asarray(packed.read_lengths).tolist()) == [
            23, 24, 24, 24, 24]


# ---------------------------------------------------------- tests/test_bam.py

BAM_CASES = {
    "basic": ([("r0", "ACGTACGTAC", "IIIIIIIIII"),
               ("r1", "GGGGCCCCTT", None),
               ("read_with_long_name_2", "A" * 75, "J" * 75)], None),
    "reverse": ([("fwd", "AACCGGTTAG", "ABCDEFGHIJ"),
                 ("rev", "AACCGGTTAG", "ABCDEFGHIJ", bam.FLAG_REVERSE, 0, 5)],
                [("chr1", 1000)]),
    "flags": ([("p", "ACGT", None, bam.FLAG_UNMAPPED),
               ("s", "ACGT", None, bam.FLAG_SECONDARY),
               ("x", "ACGT", None, bam.FLAG_SUPPLEMENTARY),
               ("d", "ACGT", None, bam.FLAG_DUP)], None),
    "many_blocks": ([(f"q{i}", "".join("ACGTN"[c] for c in row), None)
                     for i, row in enumerate(np.random.default_rng(5)
                                             .integers(0, 5, (1500, 120)))],
                    None),
}


@pytest.mark.parametrize("case", list(BAM_CASES))
def test_bam_matches_jax(tmp_path, case):
    """``write_bam`` writes the JAX writer's bytes (BGZF blocks and EOF
    marker included); ``read_bam`` reads back what the JAX reader does,
    with and without duplicates (the round-trip, reverse-strand, flag and
    multi-block tests of test_bam.py)."""
    recs, refs = BAM_CASES[case]
    bam.write_bam(tmp_path / "p.bam", recs, refs=refs)
    jax_bam.write_bam(tmp_path / "j.bam", recs, refs=refs)
    data = (tmp_path / "p.bam").read_bytes()
    assert data == (tmp_path / "j.bam").read_bytes()
    assert data.endswith(bam._BGZF_EOF)
    for dup in (True, False):
        got = list(bam.read_bam(tmp_path / "j.bam", keep_duplicates=dup))
        assert got == list(jax_bam.read_bam(tmp_path / "p.bam",
                                            keep_duplicates=dup))
    if case in ("basic", "reverse"):
        assert got == [r[:3] for r in recs]


def test_bam_magic_check_matches_jax(tmp_path):
    import gzip

    p = tmp_path / "notbam.bam"
    with gzip.open(p, "wb") as fh:
        fh.write(b"nope")
    for reader in (bam.read_bam, jax_bam.read_bam):
        with pytest.raises(ValueError, match="not a BAM"):
            next(reader(p))


@pytest.mark.parametrize("qual_trim", ["0", "20"])
def test_cli_build_from_bam_matches_jax_and_fasta(tmp_path, capsys,
                                                  tiny_corpus, qual_trim):
    """``build --bam`` (half the records reverse-strand) writes the JAX
    CLI's artifact, and the same bytes as ``build --fasta`` of the reads
    (``test_cli_build_from_bam_matches_fasta``)."""
    seqs = [alphabet.decode(r) for r in tiny_corpus.reads[:60]]
    bam_path = tmp_path / "in.bam"
    bam.write_bam(bam_path, [
        (f"r{i}", s, "I" * len(s),
         bam.FLAG_REVERSE if i % 2 else bam.FLAG_UNMAPPED, -1, -1)
        for i, s in enumerate(seqs)])
    fa = _fasta(tmp_path / "in.fa", seqs)
    j, p, _ = run_both_trees(capsys, tmp_path, lambda r: [
        "build", "--bam", str(bam_path), "--qual-trim", qual_trim,
        "--out", str(r / "idx_bam")], "idx_bam")
    run_both_trees(capsys, tmp_path, lambda r: [
        "build", "--fasta", str(fa), "--out", str(r / "idx_fa")], "idx_fa")
    assert_same_tree(p / "idx_bam", p / "idx_fa")


# ---------------------------------------------------- tests/test_merge_rle.py


def _split(reads, parts):
    per = len(reads) // parts
    return [reads[s * per: (s + 1) * per if s < parts - 1 else len(reads)]
            for s in range(parts)]


def test_merge_matches_jax(tiny_corpus):
    """``merge_indexes`` of per-sample indexes equals the JAX merge field
    by field, and a direct build of the concatenated cohort's BWT
    (``test_merge_equals_direct_build``, ``test_merged_queries_match_oracle``)."""
    chunks = _split(tiny_corpus.reads, 3)
    port = merge.merge_indexes([
        build_index(c, sample_ids=np.zeros(len(c), np.int32)) for c in chunks])
    want = jax_merge.merge_indexes([
        jax_build_index(c, sample_ids=np.zeros(len(c), np.int32))
        for c in chunks])
    for f in dataclasses.fields(port):
        x, y = getattr(port, f.name), getattr(want, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        elif f.name != "config":
            assert x == y, f.name
    direct = build_index([r for c in chunks for r in c])
    assert np.array_equal(unpack_sym4(port.sym4, port.n),
                          unpack_sym4(direct.sym4, direct.n))
    assert port.num_samples == 3


@pytest.mark.parametrize("how", [[], ["--interleave"], ["--rebuild"]])
def test_cli_merge_matches_jax(tmp_path, capsys, tiny_corpus, how):
    """``merge`` (interleave by default, ``--rebuild`` the read-level
    merge) of two FASTA builds: the JAX CLI's bytes, counts summed."""
    chunks = _split(tiny_corpus.reads[:200], 2)
    for i, c in enumerate(chunks):
        fa = _tiny_fasta(tmp_path / f"s{i}.fa", c)
        run_both(capsys, tmp_path, lambda r, fa=fa, i=i: [
            "build", "--fasta", str(fa), "--out", str(r / f"s{i}")])
    run_both_trees(capsys, tmp_path, lambda r: [
        "merge", str(r / "s0"), str(r / "s1"), *how,
        "--out", str(r / "pop")], "pop")
    km = alphabet.decode(tiny_corpus.reads[150][3:14])
    *_, out = run_both(capsys, tmp_path, lambda r: [
        "query", "--index", str(r / "pop"), "--kmer", km, "--hits"])
    assert _query_lines(out)[0]["count"] == naive_count(
        tiny_corpus.reads[:200], km)


def test_rle_matches_jax(tiny_corpus, tmp_path):
    """``encode_rle``/``decode_rle``, the RLE file's bytes and its read
    back (``test_rle_roundtrip``, ``test_rle_long_runs``)."""
    packed = build_index(tiny_corpus.reads[:300])
    bwt = unpack_sym4(packed.sym4, packed.n)
    long_runs = np.concatenate([np.full(100, 3, np.uint8),
                                np.full(7, 0, np.uint8),
                                np.full(35, 1, np.uint8)])
    for b in (bwt, long_runs):
        runs = rle.encode_rle(b)
        assert np.array_equal(runs, jax_rle.encode_rle(b))
        assert np.array_equal(rle.decode_rle(runs), b)
        assert np.array_equal(jax_rle.decode_rle(runs), b)
        assert (runs >> 3).max() <= rle.MAX_RUN == jax_rle.MAX_RUN
    rle.write_rle_bwt(tmp_path / "p.rlebwt", bwt, packed.num_reads)
    jax_rle.write_rle_bwt(tmp_path / "j.rlebwt", bwt, packed.num_reads)
    assert (tmp_path / "p.rlebwt").read_bytes() == (
        tmp_path / "j.rlebwt").read_bytes()
    back, m = rle.read_rle_bwt(tmp_path / "j.rlebwt")
    assert m == packed.num_reads and np.array_equal(back, bwt)


def test_rle_rejects_garbage_as_jax(tmp_path):
    p = tmp_path / "bad"
    p.write_bytes(b'{"magic": "nope"}\n\x00\x01')
    for read in (rle.read_rle_bwt, jax_rle.read_rle_bwt):
        with pytest.raises(ValueError):
            read(p)


# ------------------------------------------------------ tests/test_upgrade.py


def _strip(path, names):
    """Emulate an artifact from before ``names`` existed
    (tests/test_upgrade.py's ``_strip``)."""
    manifest = json.loads((path / artifact.MANIFEST_NAME).read_text())
    for name in names:
        (path / f"{name}.npy").unlink()
    manifest["arrays"] = [a for a in manifest["arrays"] if a not in names]
    if "dsa" in names:
        manifest["dsa_bits"] = 0
    if "mark_rank" in names:
        manifest["sample_rate"] = 0
    (path / artifact.MANIFEST_NAME).write_text(json.dumps(manifest))


@pytest.fixture(scope="module")
def full_artifact(tiny_corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("upg") / "full"
    packed = build_index(tiny_corpus.reads, sample_ids=tiny_corpus.sample_ids,
                         sample_rate=16, kstep=3)
    artifact.save_artifact(packed, out)
    return tiny_corpus, out, packed


def _stripped_pair(src, tmp_path, names):
    """One stripped copy of ``src`` for each side → {side: path}."""
    paths = {}
    for side in SIDES:
        (tmp_path / side).mkdir(exist_ok=True)
        paths[side] = tmp_path / side / "old"
        shutil.copytree(src, paths[side])
        _strip(paths[side], names)
    return paths


@pytest.mark.parametrize("names,args,rate", [
    (OPTIONAL, ["--kstep", "3", "--sample-rate", "16"], 16),
    (["dsa", "fused_rows", "rank3_blocks", "C3"], ["--kstep", "3"], 16),
    (["dsa", "fused_rows"], ["--kstep", "3", "--sample-rate", "8"], 8),
    (["rank3_blocks", "C3"], [], 16),
    ([], ["--kstep", "3"], 16),
    (OPTIONAL, ["--kstep", "3"], 32),
])
def test_cli_upgrade_matches_jax(full_artifact, tmp_path, capsys, names, args,
                                 rate):
    """``upgrade`` of a stripped artifact: the plan and the upgraded
    artifact's bytes equal the JAX CLI's, and its arrays those of a
    from-scratch build at the rate it lands on (all tiers; a partial set,
    which leaves the present arrays unwritten; a rate change, which
    rewrites every resolve tier to rate-versioned files; the auto k-step;
    nothing to add; and the reference's fallback: with ``mark_rank``
    stripped the recorded rate reads 0, so an upgrade without
    ``--sample-rate`` writes rate-32 tiers, ROADMAP §3)."""
    corpus, src, packed = full_artifact
    paths = _stripped_pair(src, tmp_path, names)
    assert set(upgrade.plan_upgrade(paths["port"], kstep=3)) == set(names)
    assert upgrade.plan_upgrade(paths["port"]) == jax_upgrade.plan_upgrade(
        paths["jax"])
    kept = {f: (paths["port"] / f).stat().st_mtime_ns
            for f in ("rank_blocks.npy", "sym4.npy")}
    j, p, _ = run_both(capsys, tmp_path, lambda r: [
        "upgrade", str(r / "old"), *args])
    assert_same_tree(j / "old", p / "old")
    for f, mt in kept.items():
        assert (p / "old" / f).stat().st_mtime_ns == mt
    assert upgrade.plan_upgrade(p / "old", kstep=3) == []
    up = artifact.load_artifact(p / "old")
    ref = packed if rate == 16 else build_index(
        corpus.reads, sample_ids=corpus.sample_ids, sample_rate=rate, kstep=3)
    for name in OPTIONAL:
        assert np.array_equal(np.asarray(getattr(up, name)),
                              np.asarray(getattr(ref, name))), name
    assert (up.sample_rate, up.dsa_bits) == (ref.sample_rate, ref.dsa_bits)
    manifest = json.loads((p / "old" / artifact.MANIFEST_NAME).read_text())
    assert len(manifest["arrays"]) == len(set(manifest["arrays"]))
    rewritten = set(upgrade.RESOLVE_TIERS) - set(names) if (
        rate != 16 and "mark_rank" not in names) else set()
    assert set(manifest.get("files", {})) == rewritten


def test_upgraded_artifact_serves_as_jax(full_artifact, tmp_path):
    """``test_upgraded_artifact_serves_identically``: the port's engine on
    the CPU over the artifact the port upgraded answers as the JAX engine
    over the artifact as built."""
    corpus, src, packed = full_artifact
    old = tmp_path / "served"
    shutil.copytree(src, old)
    _strip(old, OPTIONAL)
    assert sorted(upgrade.upgrade_artifact(old, kstep=3, sample_rate=16)) == (
        sorted(OPTIONAL))
    a = JaxQueryEngine(packed, JaxServeConfig(batch_size=16, max_hits=64))
    b = QueryEngine(artifact.load_artifact(old),
                    ServeConfig(batch_size=16, max_hits=64), device="cpu")
    kmers = [jax_alphabet.decode(km) for km in sample_query_kmers(
        corpus, 10, corpus.spec.kmer_len, seed=41, miss_frac=0.25)]
    for ra, rb in zip(a.query_batch(kmers), b.query_batch(kmers)):
        assert (ra.count, ra.hits, ra.sample_hist) == (
            rb.count, rb.hits, rb.sample_hist)


def test_cli_upgrade_cohort_matches_jax(tiny_corpus, tmp_path, capsys):
    """``test_cli_upgrade_cohort``: every shard upgraded, as the JAX CLI
    upgrades them."""
    ref = cohort.build_cohort(tiny_corpus.reads[:120],
                              np.asarray(tiny_corpus.sample_ids[:120]), 2,
                              tmp_path / "ref")
    parts, manifest = cohort.load_cohort(ref)
    for side in SIDES:
        shutil.copytree(ref, tmp_path / side / "pop")
        for s in manifest["shards"]:
            _strip(tmp_path / side / "pop" / s, ["dsa", "fused_rows"])
    j, p, _ = run_both(capsys, tmp_path, lambda r: [
        "upgrade", str(r / "pop")])
    assert_same_tree(j / "pop", p / "pop")
    assert_restored(ref, p / "pop")


def test_rate_change_crash_leaves_artifact_valid(full_artifact, tmp_path,
                                                 monkeypatch):
    """``test_rate_change_crash_leaves_artifact_valid``: the port's upgrade
    killed after two written arrays leaves the old-rate artifact whole;
    run again, it writes the JAX upgrade's bytes."""
    corpus, src, packed = full_artifact
    paths = _stripped_pair(src, tmp_path, [])
    before = _files(paths["port"])
    calls = {"n": 0}
    real_save = np.save

    def bomb(f, arr, *a, **kw):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise RuntimeError("simulated crash")
        return real_save(f, arr, *a, **kw)

    monkeypatch.setattr(np, "save", bomb)
    with pytest.raises(RuntimeError, match="simulated crash"):
        upgrade.upgrade_artifact(paths["port"], kstep=3, sample_rate=8)
    monkeypatch.setattr(np, "save", real_save)
    live = _files(paths["port"])
    manifest = json.loads(before[artifact.MANIFEST_NAME])
    for name in manifest["arrays"]:
        assert live[f"{name}.npy"] == before[f"{name}.npy"], name
    assert live[artifact.MANIFEST_NAME] == before[artifact.MANIFEST_NAME]
    assert artifact.load_artifact(paths["port"]).sample_rate == 16

    upgrade.upgrade_artifact(paths["port"], kstep=3, sample_rate=8)
    jax_upgrade.upgrade_artifact(paths["jax"], kstep=3, sample_rate=8)
    assert_same_tree(paths["jax"], paths["port"])


# ------------------------------------------------ tests/test_cohort_build.py


@pytest.mark.parametrize("flags", [[], ["--hits", "--samples"]])
def test_cli_doc_shards_build_and_query_matches_jax(tiny_corpus, tmp_path,
                                                    capsys, flags):
    """``build --fasta --doc-shards 3`` then ``query``
    (``test_cli_doc_shards_build_and_query``, line 168)."""
    fa = _tiny_fasta(tmp_path / "r.fa", tiny_corpus.reads[:200])
    run_both_trees(capsys, tmp_path, lambda r: [
        "build", "--fasta", str(fa), "--out", str(r / "pop"),
        "--doc-shards", "3"], "pop")
    assert cohort.is_cohort(tmp_path / "port" / "pop")
    km = alphabet.decode(tiny_corpus.reads[0][:20])
    *_, out = run_both(capsys, tmp_path, lambda r: [
        "query", "--index", str(r / "pop"), "--kmer", km, *flags])
    assert _query_lines(out)[0]["count"] == naive_count(
        tiny_corpus.reads[:200], km)


def test_append_to_cohort_matches_jax_and_rebuild(tiny_corpus, tmp_path):
    """``test_append_to_cohort_matches_rebuild`` (line 193): the port's
    ``append_to_cohort`` writes the JAX one's bytes, and its
    ``MultiEngine`` answers as a monolithic build of all the reads,
    the new sample's column included."""
    base_sids = np.asarray(tiny_corpus.sample_ids[:300])
    extra = tiny_corpus.reads[300:400]
    dirs = {}
    for side, mod in (("jax", jax_cohort), ("port", cohort)):
        dirs[side] = mod.build_cohort(tiny_corpus.reads[:300], base_sids, 2,
                                      tmp_path / side)
        mod.append_to_cohort(dirs[side], extra, sample_names=["donor_x"])
    assert_same_tree(dirs["jax"], dirs["port"])
    parts, manifest = cohort.load_cohort(dirs["port"])
    assert (manifest["num_shards"], manifest["num_reads"]) == (3, 400)
    assert manifest["sample_names"][-1] == "donor_x"
    cfg = ServeConfig(batch_size=16, max_hits=64)
    multi = MultiEngine(parts, cfg, device="cpu")
    old_ns = int(base_sids.max()) + 1
    mono = QueryEngine(build_index(
        tiny_corpus.reads[:400],
        sample_ids=np.concatenate([base_sids, np.full(100, old_ns, np.int32)]),
        sample_names=manifest["sample_names"]), cfg, device="cpu")
    k = tiny_corpus.spec.kmer_len
    kmers = [jax_alphabet.decode(km) for km in sample_query_kmers(
        tiny_corpus, 8, k, seed=17, miss_frac=0.25)]
    kmers += [alphabet.decode(extra[i][:k]) for i in (0, 50, 99)]
    key = lambda h: (h["read_id"], h["offset"], h["sample_id"])  # noqa: E731
    for rm, rx in zip(mono.query_batch(kmers), multi.query_batch(kmers)):
        assert rm.count == rx.count
        if not (rm.hits_truncated or rx.hits_truncated):
            assert sorted(map(key, rm.hits)) == sorted(map(key, rx.hits))
            assert (rm.sample_hist or {}) == (rx.sample_hist or {})
    assert multi.read_sequence(399) == alphabet.decode(tiny_corpus.reads[399])
    assert multi.query_batch([kmers[-1]])[0].sample_hist.get("donor_x", 0) >= 1


@pytest.mark.parametrize("source", ["--fasta", "--fastq", "--bam", "config"])
def test_cli_append_matches_jax(tiny_corpus, tmp_path, capsys, source):
    """``test_cli_append`` (line 251), the appended batch from each
    source: the cohort's bytes and the query answers equal the JAX CLI's,
    the count the oracle's."""
    fa = _tiny_fasta(tmp_path / "base.fa", tiny_corpus.reads[:150])
    run_both(capsys, tmp_path, lambda r: [
        "build", "--fasta", str(fa), "--out", str(r / "pop"),
        "--doc-shards", "2"])
    extra = [alphabet.decode(r) for r in tiny_corpus.reads[150:200]]
    recs = [(f"x_{i}", s) for i, s in enumerate(extra)]
    if source == "--fasta":
        src = [source, str(_fasta(tmp_path / "extra.fa", extra, "x_"))]
    elif source == "--fastq":
        fq = tmp_path / "extra.fq"
        fq.write_text("".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n"
                              for n, s in recs))
        src = [source, str(fq), "--qual-trim", "20"]
    elif source == "--bam":
        bam.write_bam(tmp_path / "extra.bam", [(n, s, None) for n, s in recs])
        src = [source, str(tmp_path / "extra.bam")]
    else:
        src = ["--config", "tiny", "--scale", "0.5"]
    run_both_trees(capsys, tmp_path, lambda r: [
        "append", str(r / "pop"), *src, "--sample", "late_donor"], "pop")
    km = alphabet.decode(tiny_corpus.reads[180][:20])
    *_, out = run_both(capsys, tmp_path, lambda r: [
        "query", "--index", str(r / "pop"), "--kmer", km, "--samples"])
    if source != "config":
        assert _query_lines(out)[0]["count"] == naive_count(
            tiny_corpus.reads[:200], km)


@pytest.mark.parametrize("target", ["1", "2"])
def test_cli_compact_matches_jax(tiny_corpus, tmp_path, capsys, target):
    """``test_compact_cohort_preserves_answers`` (line 286) through the
    CLIs: append then compact write the JAX CLI's bytes, and the port's
    answers before and after compaction are equal."""
    fa = _tiny_fasta(tmp_path / "base.fa", tiny_corpus.reads[:200])
    fa2 = _tiny_fasta(tmp_path / "extra.fa", tiny_corpus.reads[200:260])
    run_both(capsys, tmp_path, lambda r: [
        "build", "--fasta", str(fa), "--out", str(r / "pop"),
        "--doc-shards", "2"])
    run_both(capsys, tmp_path, lambda r: [
        "append", str(r / "pop"), "--fasta", str(fa2), "--sample", "donor_y"])
    kmers = [jax_alphabet.decode(km) for km in sample_query_kmers(
        tiny_corpus, 7, tiny_corpus.spec.kmer_len, seed=23, miss_frac=0.25)]
    kmers.append(alphabet.decode(
        tiny_corpus.reads[230][: tiny_corpus.spec.kmer_len]))
    query = lambda r: ["query", "--index", str(r / "pop"),  # noqa: E731
                       "--hits", "--samples", "--kmer", *kmers]
    *_, before = run_both(capsys, tmp_path, query)
    run_both_trees(capsys, tmp_path, lambda r: [
        "compact", str(r / "pop"), "--target-shards", target], "pop")
    _, manifest = cohort.load_cohort(tmp_path / "port" / "pop")
    assert manifest["num_shards"] == int(target)
    assert manifest["sample_names"][-1] == "donor_y"
    *_, after = run_both(capsys, tmp_path, query)
    key = lambda h: (h["read_id"], h["offset"], h["sample_id"])  # noqa: E731
    for b, a in zip(_query_lines(before), _query_lines(after)):
        assert b["count"] == a["count"]
        if not (b["hits_truncated"] or a["hits_truncated"]):
            assert sorted(map(key, b["hits"])) == sorted(map(key, a["hits"]))
            assert b["samples"] == a["samples"]


@pytest.mark.parametrize("explicit", [False, True])
def test_append_inherits_build_config_as_jax(tiny_corpus, tmp_path, explicit):
    """``test_append_inherits_build_config`` (line 329) and
    ``test_append_explicit_config_inherits_tier_kwargs`` (line 548): an
    append with no config, or the same one passed explicitly, takes
    shard 0's layout and tier kwargs, as the JAX append does; a
    mismatched config is refused by both."""
    cfg = IndexConfig(block_size=32, row_words=4, max_query_len=24)
    dirs = {}
    for side, mod in (("jax", jax_cohort), ("port", cohort)):
        dirs[side] = mod.build_cohort(
            tiny_corpus.reads[:100], np.asarray(tiny_corpus.sample_ids[:100]),
            2, tmp_path / side, config=cfg, sample_rate=8, kstep=2)
        same = None
        if explicit:
            from readserver_tpu.config import IndexConfig as JaxIndexConfig

            same = (JaxIndexConfig if side == "jax" else IndexConfig)(
                block_size=32, row_words=4, max_query_len=24)
        mod.append_to_cohort(dirs[side], tiny_corpus.reads[100:140],
                             config=same)
    assert_same_tree(dirs["jax"], dirs["port"])
    _, manifest = cohort.load_cohort(dirs["port"])
    new = json.loads((dirs["port"] / manifest["shards"][-1]
                      / "manifest.json").read_text())
    assert new["config"]["block_size"] == 32 and new["sample_rate"] == 8
    assert "rank2_blocks" in new["arrays"]
    assert "rank3_blocks" not in new["arrays"]
    with pytest.raises(ValueError, match="config mismatch"):
        cohort.append_to_cohort(dirs["port"], tiny_corpus.reads[140:150],
                                config=IndexConfig())


def test_cli_append_rejects_plain_artifact_as_jax(tiny_corpus, tmp_path,
                                                  capsys):
    """``test_cli_append_rejects_plain_artifact`` (line 371): exit code 2
    and the JAX CLI's message."""
    fa = _tiny_fasta(tmp_path / "r.fa", tiny_corpus.reads[:40])
    run_both(capsys, tmp_path, lambda r: [
        "build", "--fasta", str(fa), "--out", str(r / "plain")])
    capsys.readouterr()
    assert cli.main(["append", str(tmp_path / "port" / "plain"),
                     "--config", "tiny"]) == 2
    err = capsys.readouterr().err
    assert jax_cli.main(["append", str(tmp_path / "port" / "plain"),
                         "--config", "tiny"]) == 2
    assert capsys.readouterr().err == err and "cohort" in err


def test_compact_keeps_singletons_and_rewrites_progress_as_jax(tiny_corpus,
                                                                tmp_path):
    """``test_compact_keeps_singletons_and_rewrites_progress`` (line
    381): a streamed cohort compacted to 2 shards keeps its singleton
    shard in place and rewrites ``progress.jsonl``, with the JAX
    compaction's bytes."""
    reads = tiny_corpus.reads[:120]
    dirs = {}
    for side, mod in (("jax", jax_cohort), ("port", cohort)):
        dirs[side] = mod.build_cohort_stream(
            ((r, 0) for r in reads), tmp_path / side,
            max_bases_per_shard=sum(len(r) for r in reads[:40]),
            num_samples=1)
    _, manifest = cohort.load_cohort(dirs["port"])
    old_dirs = list(manifest["shards"])
    mtimes = {d: (dirs["port"] / d / "manifest.json").stat().st_mtime_ns
              for d in old_dirs}
    assert len(old_dirs) >= 3
    jax_cohort.compact_cohort(dirs["jax"], target_shards=2)
    cohort.compact_cohort(dirs["port"], target_shards=2)
    assert_same_tree(dirs["jax"], dirs["port"])
    _, manifest2 = cohort.load_cohort(dirs["port"])
    kept = [d for d in manifest2["shards"] if d in old_dirs]
    assert kept and all(
        (dirs["port"] / d / "manifest.json").stat().st_mtime_ns == mtimes[d]
        for d in kept)
    entries = [json.loads(x) for x in
               (dirs["port"] / cohort.PROGRESS_LOG).read_text().splitlines()]
    assert [e["shard"] for e in entries] == list(manifest2["shards"])
    assert entries[-1]["reads_consumed"] == 120


def test_append_after_compaction_no_name_collision_as_jax(tiny_corpus,
                                                          tmp_path):
    """``test_append_after_compaction_no_name_collision`` (line 520):
    appends after a compaction that kept a shard dir never reuse its
    name, in the JAX package's bytes; the port's front counts as the
    oracle."""
    reads = tiny_corpus.reads
    dirs = {}
    for side, mod in (("jax", jax_cohort), ("port", cohort)):
        dirs[side] = mod.build_cohort(reads[:120], None, 4, tmp_path / side)
        mod.compact_cohort(dirs[side], target_shards=2)
        mod.append_to_cohort(dirs[side], reads[120:140])
        mod.append_to_cohort(dirs[side], reads[140:160])
    assert_same_tree(dirs["jax"], dirs["port"])
    parts, m2 = cohort.load_cohort(dirs["port"])
    assert len(set(m2["shards"])) == len(m2["shards"])
    assert m2["num_reads"] == sum(p.num_reads for p in parts) == 160
    eng = MultiEngine(parts, ServeConfig(batch_size=16, max_hits=64),
                      device="cpu")
    km = alphabet.decode(reads[150][:15])
    assert eng.query_batch([km])[0].count == naive_count(reads[:160], km)


# ------------------------------------------------- refusals and simulate


@pytest.mark.parametrize("argv", [
    ["query", "--hits", "--samples", "--both-strands"],
    ["serve"],
    ["serve", "--coordinator"],
])
def test_cli_refuses_unported_decompositions(argv, tmp_path, capsys,
                                             tiny_corpus):
    """Document sharding across devices (``--index a,b``), which the CLI
    refused until ROADMAP P9 was ported, serves: ``query`` prints the JAX
    CLI's lines; ``serve`` (one process, or two ranks of a gloo group
    behind ``--coordinator``, a doc shard each) answers ``/info``,
    ``/count``, ``/reads`` and ``/samples`` as the JAX doc engine's REST
    front does, and SIGINT on rank 0 stops it with exit 0."""
    import signal
    import sys
    import time
    import urllib.request

    import jax

    from readserver_tpu.parallel import make_mesh as jax_make_mesh
    from readserver_tpu.serve import Dispatcher as JaxDispatcher
    from readserver_tpu.serve.http import RestServer as JaxRestServer
    from test_torch_multihost import _answers, _free_port, _launch, _wait

    reads = tiny_corpus.reads
    half = len(reads) // 2
    parts = [jax_build_index(reads[:half],
                             sample_ids=np.zeros(half, dtype=np.int32)),
             jax_build_index(reads[half:],
                             sample_ids=np.ones(len(reads) - half,
                                                dtype=np.int32))]
    paths = []
    for i, p in enumerate(parts):
        artifact.save_artifact(p, tmp_path / f"part{i}")
        paths.append(str(tmp_path / f"part{i}"))
    index = ",".join(paths)
    kms = [jax_alphabet.decode(km) for km in sample_query_kmers(
        tiny_corpus, 6, tiny_corpus.spec.kmer_len, seed=57, miss_frac=0.3)]
    if argv[0] == "query":
        _, _, out = run_both(capsys, tmp_path, lambda r: [
            "query", "--index", index, "--kmer", *kms, *argv[1:]])
        lines = _query_lines(out)
        assert [x["kmer"] for x in lines] == kms
        assert sum(x["count"] for x in lines) > 0
        return
    rest = _free_port()
    group = len(argv) > 1

    def cmd(i, port):
        flags = (["--coordinator", f"127.0.0.1:{port}", "--num-processes",
                  "2", "--process-id", str(i), "--backend", "gloo"]
                 if group else [])
        return [sys.executable, "-m", "readserver_tpu_torch.cli", "serve",
                "--index", index, "--port", str(rest), "--batch", "16",
                "--device", "cpu", *flags]

    procs = _launch(cmd, 2 if group else 1)
    try:
        deadline = time.time() + 120
        up = False
        while time.time() < deadline and not up:
            assert all(p.poll() is None for p in procs), _wait(procs, 5)
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{rest}/health", timeout=2) as r:
                    up = r.status == 200
            except OSError:
                time.sleep(0.3)
        assert up, "the REST front never came up"
        served = {m: _answers(rest, kms, m)
                  for m in ("count", "reads", "samples")}
        with urllib.request.urlopen(f"http://127.0.0.1:{rest}/info",
                                    timeout=10) as r:
            info = json.loads(r.read())
        procs[0].send_signal(signal.SIGINT)
        outs = _wait(procs, timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * len(procs), outs
    jeng = JaxQueryEngine(
        parts, JaxServeConfig(batch_size=16),
        mesh=jax_make_mesh(data_parallel=1, num_shards=2,
                           devices=jax.devices()[:2]))
    assert info["sharding"] == "document"
    assert info["num_reads"] == len(reads)
    pay = JaxRestServer(JaxDispatcher(jeng), "127.0.0.1", 0)._result_payload
    for mode, got in served.items():
        for k, body in zip(kms, got):
            r = (jeng.count_batch([k], both_strands=True)[0]
                 if mode == "count"
                 else jeng.query_batch([k], both_strands=True)[0])
            assert body == json.loads(json.dumps(pay(r, mode, False))), (
                mode, k)
    assert sum(r["count"] for r in served["count"]) > 0


@pytest.mark.parametrize("config,scale", [("tiny", "1.0"), ("cohort", "0.001")])
def test_cli_simulate_matches_jax(tmp_path, capsys, config, scale):
    """``simulate`` writes the JAX CLI's FASTA, byte for byte."""
    j, p, _ = run_both(capsys, tmp_path, lambda r: [
        "simulate", "--config", config, "--scale", scale,
        "--out", str(r / "reads.fa")])
    assert (j / "reads.fa").read_bytes() == (p / "reads.fa").read_bytes()


def test_host_commands_import_no_torch(tmp_path, tiny_corpus):
    """The host commands run with torch blocked: they never reach a
    device, so they create no CUDA context on the card's host."""
    import subprocess
    import sys
    from pathlib import Path

    fa = _tiny_fasta(tmp_path / "r.fa", tiny_corpus.reads[:120])
    code = f"""
import sys
sys.modules["torch"] = None  # any import of torch now raises ImportError
from readserver_tpu_torch import cli
out = {str(tmp_path)!r}
for argv in (["build", "--fasta", {str(fa)!r}, "--doc-shards", "2",
              "--out", out + "/pop"],
             ["append", out + "/pop", "--fasta", {str(fa)!r}],
             ["compact", out + "/pop"],
             ["upgrade", out + "/pop", "--kstep", "3"],
             ["simulate", "--config", "tiny", "--out", out + "/s.fa"]):
    assert cli.main(argv) == 0, argv
print("ok")
"""
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr[-3000:]
