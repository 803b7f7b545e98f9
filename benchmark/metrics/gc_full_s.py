"""gc_full_s: seconds of the measured window that Python's collector spent
in full collections, on the host clock (a ``gc.callbacks`` hook,
``harness/host.py``).  A full collection walks every tracked object of the
process and holds the interpreter lock while it does, so neither the
dispatcher's loop nor the engine call's host work runs.  Moves
kmers_per_s."""


def read(run):
    return run.gc_full_s
