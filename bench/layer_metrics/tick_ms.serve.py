"""The engine's tick: the host clock the benchmark takes around each
``ServingEngine.step`` of the counted ticks, their total over their
number, in ms."""


def read(out):
    ticks = out.counters["tick_s"]
    return 1e3 * sum(ticks) / len(ticks) if ticks else None
