"""The share of the engine's slots that decoded a request, counted at
each of the counted ticks and averaged, in %."""


def read(out):
    occ = out.counters["occupancy"]
    return 100.0 * sum(occ) / len(occ) if occ else None
