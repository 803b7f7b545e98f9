#!/usr/bin/env python3
"""The control of a cell's comparison: the reference put in the program's
place with a lossy key, which must come out as not correct.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13 [--requests 60]

The configurations state exact answers.  The control breaks that
guarantee the way a smaller index would be tempted to: it matches k-mers
by a 32-bit hash (one word in place of two) instead of by their whole
code, and answers from the matches.  For each seed it
draws the requests a run of the cell keeps for judging (``--requests``
per client, each client's share by the mix's ``check_every``), works out
the exact answers and the control's, and prints the comparison's numbers
for the control as the run would judge them.  It runs no program and
needs no card: NumPy on the host, at the cell's own corpus and sizes.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(1, str(BENCH.parent))
KEY_BITS = 32


class _Answer:
    """The control's answer to one query, shaped as the program's."""

    def __init__(self, exp, i):
        self.count = int(exp.count[i])
        self.sample_hist = exp.hist[i]
        self.hits_truncated = bool(exp.hits_truncated[i])
        self.sample_hist_complete = True
        self.hits = [dict(read_id=r, sample_id=s, offset=o, strand=st)
                     for r, s, o, st in exp.hits[i]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=60,
                    help="requests each client completes in a run")
    args = ap.parse_args(argv)

    import numpy as np

    from harness import deploy, load
    from harness.cell import find_cell
    from harness.judge import Digest, compare
    from reference import expected_answers

    cell = find_cell(args.workload)
    config, traffic = cell.config, cell.traffic
    mode = load.MODES[traffic["route"]]
    reads, sids = deploy.reads_of(config)
    names = deploy.sample_names(config)
    name_ids = {n: i for i, n in enumerate(names)}
    H = int(config["serve"]["max_hits"])
    parts = int(config["deployment"].get("doc_shards", 1))
    every, size = int(traffic["check_every"]), int(traffic["kmers_per_request"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        codes, _ = load.make_pool(reads, traffic, seed)
        idx = []
        for c in range(int(traffic["clients"])):
            rng = load.request_rng(seed, c)
            phase = load.check_phase(seed, c, every)
            for j in range(args.requests):
                draw = rng.integers(0, len(codes), size)
                if j % every == phase:
                    idx.append(draw)
        q = codes[np.concatenate(idx)]
        detail = mode != "count"
        exact = expected_answers(reads, sids, names, q, H, parts,
                                 detail=detail)
        lossy = expected_answers(reads, sids, names, q, H, parts,
                                 key_bits=KEY_BITS, detail=detail)
        answers = [_Answer(lossy, i) for i in range(len(q))]
        wrong = compare(mode, [Digest(mode, answers, name_ids)], exact, names)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "key_bits": KEY_BITS, "kmers_checked": len(q),
                          **wrong, "correct": not any(wrong.values()),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
