"""The frozen bound formulas against the bounds PERF.md's kernel table
states, and the models' FLOP counts against their shapes."""
import json
from pathlib import Path

import pytest

from bench import roofline
from bench.reference import rwkv6

BENCH = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("bound, want_us", [
    (lambda: roofline.bound("masked_rolling_update", 10, 109_634, 10), 2.62),
    (lambda: roofline.flash_bound(1, 1024, 16, 8, 128), 4.35),
    (lambda: roofline.wkv6_bound(1, 1024, 40, 64), 12.52),
    (lambda: roofline.bound("clip_noise", 10, 109_634, 10), 2.62),
    (lambda: roofline.bound("masked_field_wsum", 10, 109_634, 10), 1.44),
    (lambda: roofline.bound("masked_rolling_update", 32, 109_634, 30), 17.12),
    (lambda: roofline.ssm_bound(1, 1152, 3200, 16), 13.37),
], ids=["row1", "flash", "wkv6", "row3", "row2", "row1b", "row8"])
def test_bounds_match_the_kernel_table(bound, want_us):
    assert round(roofline.bound_ms(bound()) * 1e3, 2) == want_us


def test_cnn_flops():
    model = json.loads((BENCH / "configs" / "stigma-cnn.json")
                       .read_text())["model"]
    fwd = roofline.cnn_forward_flops(**{k: model[k] for k in (
        "image_size", "in_channels", "channels", "n_classes")})
    want = (2 * 64 * 64 * 9 * 3 * 32 + 2 * 32 * 32 * 9 * 32 * 64
            + 2 * 16 * 16 * 9 * 64 * 128 + 2 * 8 * 8 * 128 * 2)
    assert fwd == want
    assert roofline.cnn_train_flops(model, 8) == 3 * 8 * want


def test_rwkv6_token_flops():
    conf = json.loads((BENCH / "configs" / "rwkv6-3b.json").read_text())
    m = conf["model"]
    count = rwkv6.param_count(m)
    assert count == conf["parameters"]
    f = roofline.rwkv6_token_flops(m, count)
    assert f == 2 * (count - 65536 * 2560) + 4 * 40 * 64 * 64 * 32
