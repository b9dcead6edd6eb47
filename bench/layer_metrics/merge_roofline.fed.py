"""The merge kernels' share of their roofline over the traced window:
the sum of each launch's bound (`roofline.bound` at the round's P, N and
live rows; the DP kernel too where the cell runs DP) over the sum of
their device times, in %.  Nothing is read unless the trace holds one
launch of each merge kernel a traced round."""
from bench import roofline, trace


def read(out):
    c = out.counters
    if out.trace is None or not c["traced_alive"]:
        return None
    rounds = c["traced_alive"]
    merge = trace.kernel_launches(out.trace, c["merge_kernels"])
    dp = trace.kernel_launches(out.trace, c["dp_kernels"]) if c["dp"] else []
    if len(merge) != len(rounds) or (c["dp"] and len(dp) != len(rounds)):
        return None
    P, N = c["P"], c["N"]
    need = sum(roofline.bound_ms(roofline.bound(
        "masked_rolling_update", P, N, a)) for a in rounds)
    if c["dp"]:
        need += sum(roofline.bound_ms(roofline.bound("clip_noise", P, N, a))
                    for a in rounds)
    took = sum(us for _, us in merge + dp) * 1e-3
    return 100.0 * need / took
