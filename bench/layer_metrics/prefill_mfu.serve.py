"""Prefill's share of the card's bf16 peak: FLOPs of the counted ticks'
prefill tokens alone, counted as for mfu.serve, over 989 TFLOP/s x the
counted span, in %."""
from bench import roofline


def read(out):
    c = out.counters
    if not c.get("span_s") or not c["prefill_flops"]:
        return None
    return 100.0 * c["prefill_flops"] / (roofline.BF16_TC_FLOPS * c["span_s"])
