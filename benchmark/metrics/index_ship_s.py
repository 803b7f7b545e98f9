"""index_ship_s: seconds to ship the index to the card and build its
prefix LUT (``startup_seconds["ship"]`` and ``["lut"]`` of each engine,
each ended by a device sync; ``DeviceIndex.from_packed``,
``build_prefix_lut``), summed over the partitions.  Moves setup_s."""


def read(run):
    total = 0.0
    for _, e in run.partitions():
        s = e.startup_seconds
        if "ship" not in s or "lut" not in s:
            return None
        total += s["ship"] + s["lut"]
    return total
