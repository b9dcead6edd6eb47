"""The model step's share of the card's bf16 peak: FLOPs of every
prefill and decode token of the counted ticks (2 x every parameter but
the embedding table, plus 4 x H x hd^2 a layer for the WKV state), over
989 TFLOP/s x the counted span, in %."""
from bench import roofline


def read(out):
    c = out.counters
    if not c.get("span_s"):
        return None
    return 100.0 * (c["prefill_flops"] + c["decode_flops"]) / (
        roofline.BF16_TC_FLOPS * c["span_s"])
