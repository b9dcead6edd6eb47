"""The card's idle share of the traced window: 1 - (the union of its
device activity intervals) / the window, in %."""
from bench import trace


def read(out):
    if out.trace is None or not out.trace["device"]:
        return None
    return 100.0 * (1.0 - trace.busy_s(out.trace) / out.trace["window_s"])
