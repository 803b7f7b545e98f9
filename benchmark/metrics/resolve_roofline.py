"""resolve_roofline: the full route's resolve and pack on one device, K5
(csrc/resolve.cu, the dsa decode) and K8 (csrc/pack.cu, the sparse pack),
as a share of their roofline in %: the bytes the sampled batches need, by
the frozen rules of harness/rooflines.py, over the HBM rate, divided by
the device time of those kernels in the same batches.  Moves kmers_per_s
by at most their share of the window."""

from harness import record, rooflines

KERNELS = ("resolve_dsa_kernel", "pack_kernel")
COUNTERS = ("resolve_dsa", "sparse_pack")
SAMPLE = 12


def read(run):
    if len(run.partitions()) != 1:
        return None
    packed, e = run.partitions()[0]
    if packed.dsa is None or "dsa" not in e.tier_plan.keep:
        return None
    calls = [c for c in run.traced_calls
             if c.mode == "full" and c.launches
             and all(c.launches.get(k) for k in COUNTERS)]
    sample = record.evenly(calls, SAMPLE)
    if not sample:
        return None
    kstep = rooflines.kstep_of(e.tier_plan.keep)
    if kstep < 2 or not e.lut_p:
        return None
    nbytes = 0
    for c in sample:
        codes = record.batch_codes(c.kmers, run.width(c.nq))
        if codes is None:
            return None
        s = rooflines.Search(packed, codes, e.lut_p, kstep)
        nbytes += rooflines.resolve_bytes(packed, s, c.nq, e.H,
                                          e.COMPACT_PER_QUERY, e._ns)
    secs = 0.0
    for names, counter in zip(([KERNELS[0]], [KERNELS[1]]), COUNTERS):
        t = run.kernel_time(names, counter, sample)
        if not t:
            return None
        secs += t
    return 100.0 * nbytes / rooflines.HBM_BYTES_PER_S / secs
