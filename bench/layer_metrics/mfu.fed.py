"""Local training's share of the card's float32 peak: forward plus
backward FLOPs of every local SGD step the counted rounds ran (3 x the
forward of the conv and dense shapes, every hospital), over 67 TFLOP/s
x the counted span, in %."""
from bench import roofline


def read(out):
    c = out.counters
    if not c.get("span_s"):
        return None
    return 100.0 * c["train_flops"] / (roofline.FP32_OPS_PER_S * c["span_s"])
