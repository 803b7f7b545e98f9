"""CPU tests of the benchmark's harness, reference and byte rules."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT), str(BENCH / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench_tiny import tiny_cell  # noqa: E402
from harness import load, rooflines, simulate, trace  # noqa: E402
from harness.cell import find_cell, load_manifest, metric_reader  # noqa: E402
from reference import expected_answers, kmer_keys, revcomp  # noqa: E402

MANIFEST = load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "readserver_tpu"}
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]


# ---------------------------------------------------------------- manifest


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_keys_names_and_units():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["paths"]) <= 16 and len(m["command"]) <= 32
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
               and not p.startswith("/") for p in m["paths"])
    assert all(_line(w) for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert "setup_s" in {e["name"] for e in m["end_to_end"]}
    e2e = {e["name"] for e in m["end_to_end"]}
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert NAME.match(p["name"]) and UNIT.match(p["unit"])
        assert p["moves"] in e2e and _line(p["layer"])
        assert set(p.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    names = ([c["name"] for c in m["configs"]] + WORKLOADS
             + [e["name"] for e in m["end_to_end"] + m["per_layer"]])
    assert len(names) == len(set(names))
    assert len(json.dumps(m)) < 64 * 1024


def test_configurations_and_pairs():
    configs = {c["name"] for c in MANIFEST["configs"]}
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    cell = find_cell(workload)
    assert cell.config["name"] == workload.split(".")[0]
    assert cell.traffic["route"] in load.MODES
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "kmers_per_s"}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(metric_reader(m["name"]))


def test_every_bench_file_name_is_allowed():
    for f in BENCH.rglob("*"):
        if "cache" in f.parts or "__pycache__" in f.parts:
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


# ----------------------------------------------------------------- imports


def _imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


def test_no_module_of_the_benchmark_names_jax_or_the_jax_package():
    for f in BENCH.rglob("*.py"):
        assert not _imported_tops(f) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").rglob("*.py"):
        assert not {t for t in _imported_tops(f)
                    if t.startswith("readserver_tpu")}, f


def test_what_a_run_loads_holds_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness.runner, harness.deploy, reference\n"
        "from harness.cell import find_cell, metric_reader\n"
        "from readserver_tpu_torch.serve.dispatcher import Dispatcher\n"
        "from readserver_tpu_torch.cli import _load_engine\n"
        "import readserver_tpu_torch.kernels\n"
        "c = find_cell('ecoli30x.count')\n"
        "[metric_reader(m['name']) for m in c.per_layer]\n"
        "metric_reader('resolve_roofline')\n"
        "import run\n"
        "print(run.forbidden_modules())\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'readserver_tpu_torch'"
        " and m.startswith('readserver_tpu_torch.')) != [])\n"
    ) % (str(BENCH), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout.split("\n")
    assert out[0] == "[]" and out[1] == "True"


def test_the_forbidden_check_compares_whole_top_level_names():
    import run

    sys.modules["readserver_tpu_torch_lookalike_probe"] = object()
    try:
        assert "readserver_tpu_torch_lookalike_probe" not in run.forbidden_modules()
        sys.modules["readserver_tpu.probe"] = object()
        assert "readserver_tpu.probe" in run.forbidden_modules()
    finally:
        sys.modules.pop("readserver_tpu_torch_lookalike_probe", None)
        sys.modules.pop("readserver_tpu.probe", None)


# --------------------------------------------------------------- reference


def _naive(reads, sids, names, queries, max_hits, partitions):
    """The windows' arithmetic by string search: every offset of every
    read, both strands; the cap's hits by sorting the suffix strings."""
    from reference.answers import partition_of

    text = ["".join("$ACGT"[c] for c in r) for r in reads]
    bounds = partition_of(len(reads), reads.shape[1], partitions)
    out = []
    for q in queries:
        count, hits, trunc, htrunc, hist = 0, [], False, False, {}
        for sign, s in (("+", q), ("-", revcomp(q[None])[0])):
            pat = "".join("$ACGT"[c] for c in s)
            occ = [(r, o) for r, t in enumerate(text)
                   for o in range(len(t) - len(pat) + 1)
                   if t.startswith(pat, o)]
            count += len(occ)
            for r, _ in occ:
                hist[names[sids[r]]] = hist.get(names[sids[r]], 0) + 1
            for p in range(partitions):
                mine = [(r, o) for r, o in occ if bounds[p] <= r < bounds[p + 1]]
                if len(mine) > max_hits:
                    trunc = htrunc = True
                    mine.sort(key=lambda ro: (text[ro[0]][ro[1]:] + "\0", ro[0]))
                    mine = [(r, o) for r, o in mine[:max_hits]]
                hits += [(r, int(sids[r]), o, sign) for r, o in mine]
        out.append((count, sorted(hits), trunc, htrunc, hist))
    return out


@pytest.mark.parametrize("coverage,partitions,max_hits",
                         [(10.0, 1, 64), (60.0, 1, 4), (60.0, 3, 4)])
def test_reference_against_the_windows_arithmetic(coverage, partitions,
                                                  max_hits):
    reads, sids = simulate.simulate_corpus(
        {"genome_len": 1500, "coverage": coverage, "read_len": 40,
         "num_samples": 3, "seed": 9})
    names = ["s0", "s1", "s2"]
    q = simulate.sample_query_kmers(reads, 40, 11, 3, 0.2)
    exp = expected_answers(reads, sids, names, q, max_hits, partitions)
    want = _naive(reads, sids, names, q, max_hits, partitions)
    for i, (count, hits, trunc, htrunc, hist) in enumerate(want):
        assert exp.count[i] == count
        assert exp.hits[i] == hits
        assert exp.hits_truncated[i] == trunc and exp.hist_truncated[i] == htrunc
        assert exp.hist[i] == hist
    assert exp.hits_truncated.any() == (max_hits == 4)


def test_keys_and_reverse_complements():
    q = np.array([[1, 2, 3, 4], [4, 4, 1, 2]], dtype=np.uint8)
    assert revcomp(q).tolist() == [[1, 2, 3, 4], [3, 4, 1, 1]]
    assert kmer_keys(q).tolist() == [0b00011011, 0b11110001]


def test_control_with_lossy_keys_fails_the_comparison():
    """The control: the reference with k-mers matched by a hash of fewer
    bits than their code (a lossy key) gives other answers."""
    from harness.judge import Digest, compare

    reads, sids = simulate.simulate_corpus(
        {"genome_len": 20_000, "coverage": 10.0, "read_len": 100, "seed": 3})
    q = simulate.sample_query_kmers(reads, 4000, 31, 4, 0.15)
    exact = expected_answers(reads, sids, ["s"], q, 64, detail=False)
    lossy = expected_answers(reads, sids, ["s"], q, 64, key_bits=16,
                             detail=False)

    class R:
        def __init__(self, c):
            self.count = c

    got = [Digest("count", [R(int(c)) for c in lossy.count], {})]
    assert compare("count", got, exact, ["s"])["count_wrong"] > 0
    got = [Digest("count", [R(int(c)) for c in exact.count], {})]
    assert compare("count", got, exact, ["s"])["count_wrong"] == 0


# ------------------------------------------------------------- byte rules


def test_kstep_schedule_by_hand():
    assert rooflines.kstep_schedule(19, 3) == [
        (16, 3), (13, 3), (10, 3), (7, 3), (4, 3), (1, 3), (0, 1)]
    assert rooflines.kstep_schedule(19, 2) == [
        (17, 2), (15, 2), (13, 2), (11, 2), (9, 2), (7, 2), (5, 2), (3, 2),
        (1, 2), (0, 1)]
    assert rooflines.kstep_schedule(6, 3) == [(3, 3), (0, 3)]


def test_occ_by_hand():
    # one plane, blocks of 64: checkpoints 0, 5; bits 0, 3, 40 set in block 0
    table = np.zeros((1, 2, 4), dtype=np.uint32)
    table[0, 0, 1] = (1 << 0) | (1 << 3)
    table[0, 0, 2] = 1 << 8
    table[0, 1, 0] = 5
    c = np.zeros(6, dtype=np.int64)
    i = np.array([0, 1, 4, 40, 41, 64])
    assert rooflines.occ(table, c, i, 6).tolist() == [0, 1, 2, 2, 3, 5]


@pytest.fixture(scope="module")
def tiny_index(tmp_path_factory):
    from harness import deploy

    cell = tiny_cell("ecoli30x.count")
    reads, sids = deploy.reads_of(cell.config)
    path = tmp_path_factory.mktemp("idx") / "ecoli"
    deploy.ensure_artifact(cell.config, reads, sids, path)
    engine = deploy.make_engine(cell.config, path, "cpu")
    return engine, reads


def test_k2_rule_follows_the_search(tiny_index):
    """The rule's intervals are the program's for every open interval, and
    its bytes count each distinct row once: a repeated query adds its
    codes and its output, nothing else."""
    from harness.record import batch_codes

    engine, reads = tiny_index
    kmers = simulate.decode_rows(simulate.sample_query_kmers(reads, 200, 31,
                                                             5, 0.15))
    got = engine.count_batch(kmers)
    codes = batch_codes(kmers, 256)
    s = rooflines.Search(engine.packed, codes, engine.lut_p, 3)
    count = np.array([r.count for r in got])
    assert np.array_equal(s.u[:200] - s.l[:200], count)
    open_ = count > 0
    assert np.array_equal(s.l[:200][open_],
                          np.array([r.interval[0] for r in got])[open_])
    one = rooflines.Search(engine.packed, codes[:1], engine.lut_p, 3).bytes
    two = rooflines.Search(engine.packed, codes[[0, 0]], engine.lut_p, 3).bytes
    assert two - one == 31 * 4 + 8
    # by hand: one query is 31 codes, one LUT entry, its (l, u), and two
    # rows (l's and u's) a step where the interval is open
    assert (one - 31 * 4 - 8 - 8) % 16 == 0 and one - 31 * 4 - 16 <= 7 * 2 * 16
    # the chain: the code tile, the LUT entry, then a step while any
    # interval is open; a k-mer present in the reads stays open to the end
    steps = len(rooflines.kstep_schedule(31 - engine.lut_p, 3))
    present = int(np.flatnonzero(count > 0)[0])
    s1 = rooflines.Search(engine.packed, codes[[present]], engine.lut_p, 3)
    assert s1.chain == 2 + steps and s.chain == 2 + steps
    assert s1.least_seconds() == max(s1.bytes / rooflines.HBM_BYTES_PER_S,
                                     s1.chain * rooflines.T_ROW_S)


def test_resolve_rule_counts_lanes_once(tiny_index):
    from harness.record import batch_codes

    engine, reads = tiny_index
    kmers = simulate.decode_rows(simulate.sample_query_kmers(reads, 50, 31,
                                                             6, 0.0))
    codes = batch_codes(kmers, 256)
    s = rooflines.Search(engine.packed, codes, engine.lut_p, 3)
    b = rooflines.resolve_bytes(engine.packed, s, 50, 64, 16, 1)
    hits = int(np.minimum(s.u - s.l, 64).sum())
    assert b > 3 * 256 * 64 * 4 and b < 3 * 256 * 64 * 4 + 256 * 200 + hits * 16 + 4 * 256 * 16 * 6 + 4 * 256 * 80


# ----------------------------------------------------------------- traces


def test_busy_time_is_the_union_of_intervals():
    ev = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 25, 26)]
    merged = trace.busy_intervals(ev, 0, 40)
    assert merged == [[0, 15], [20, 30]]
    assert trace.busy_seconds(merged) == 25e-9
    gaps = trace.idle_gaps(merged, 0, 40, [("call", 14, 22)])
    assert gaps == [["host between engine calls", 10e-9], ["call", 5e-9]]
    assert trace.top_ops(ev)[0] == ["a", 10e-9]


# ----------------------------------------------------------- whole runs


def _run(workload, fault=None, **kw):
    from harness.runner import run_cell

    cell = tiny_cell(workload, **kw)
    return run_cell(cell, 2**31 + 77, 1.0, True, "cpu", time.perf_counter(),
                    cache_dir=ROOT / "benchmark" / "cache", fault=fault,
                    log=lambda m: None)


@pytest.mark.parametrize("workload,kw", [
    ("ecoli30x.count", {}), ("ecoli30x.reads", {}),
    ("cohort128.samples", dict(samples=8, coverage=20.0)),
    ("cohort128.count", dict(samples=8, coverage=20.0))])
def test_a_run_on_the_cpu_is_correct(workload, kw):
    r = _run(workload, **kw)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["compared"]["kmers_checked"]["value"] > 0
    assert {"batch_fill", "engine_call_ms", "request_p95_ms.host",
            "gc_full_s"} <= set(r["metrics"])


def _altered(mode, kmers, out):
    out[len(out) // 2].count += 1
    return out


def _half_left_out(mode, kmers, out):
    from readserver_tpu_torch.serve.engine import QueryResult

    half = len(out) // 2
    return out[:half] + [QueryResult(kmer=k, count=0, sample_hist={})
                         for k in kmers[half:]]


@pytest.mark.parametrize("fault", [_altered, _half_left_out],
                         ids=["answer_altered", "half_the_batch_left_out"])
@pytest.mark.parametrize("workload", ["ecoli30x.count", "ecoli30x.reads"])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    r = _run(workload, fault=fault)
    assert r["correct"] is False


def _flag_flipped(mode, kmers, out):
    out[0].hits_truncated = not out[0].hits_truncated
    return out


def test_a_flipped_truncation_flag_is_not_correct():
    r = _run("ecoli30x.reads", fault=_flag_flipped)
    assert r["correct"] is False and r["compared"]["flags_wrong"]["value"] > 0
