"""search_roofline: K2's share of its roofline (ops/search.py →
csrc/search.cu), in %: the least time of the sampled batches' searches by
the frozen rule of harness/rooflines.py (for each launch the larger of its
bytes over the HBM rate and its longest chain of dependent reads times
the yardstick's time per read), divided by the device time of the search
kernels those batches launched, one a partition.  Moves kmers_per_s by at
most the search's share of the window."""

from harness import record, rooflines

KERNELS = ("backward_search_kernel",)
COUNTER = "backward_search"
SAMPLE = 12


def read(run):
    parts = run.partitions()
    calls = [c for c in run.traced_calls
             if c.launches and c.launches.get(COUNTER) == len(parts)]
    sample = record.evenly(calls, SAMPLE)
    if not sample:
        return None
    least = 0.0
    for c in sample:
        codes = record.batch_codes(c.kmers, run.width(c.nq))
        if codes is None:
            return None
        for packed, e in parts:
            kstep = rooflines.kstep_of(e.tier_plan.keep)
            if kstep < 2 or not e.lut_p:
                return None
            least += rooflines.Search(packed, codes, e.lut_p,
                                      kstep).least_seconds()
    secs = run.kernel_time(KERNELS, COUNTER, sample)
    if not secs:
        return None
    return 100.0 * least / secs
