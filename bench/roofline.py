"""The yardstick's arithmetic: the H100's published peaks, the operations
and bytes a kernel needs from its shapes, and the FLOPs of one CNN image
and one RWKV-6 token.

The kernel bounds are frozen copies of ``chip_smoke.py``'s `op_counts`,
`bound`, `flash_bound`, `wkv6_bound` and `ssm_bound` (returning
milliseconds, as there), so that a later change of the program's own
smoke script cannot move the benchmark's rooflines.  Nothing here
imports the program.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
FP32_OPS_PER_S = 67e12
# CUDA C++ Programming Guide, compute capability 9.0: results per clock
# per SM, x 132 SMs x the 1,980 MHz boost clock.
PER_CLOCK = 132 * 1.98e9
ALU_OPS_PER_S = IMAD_OPS_PER_S = 64 * PER_CLOCK
CVT_OPS_PER_S = SFU_OPS_PER_S = 16 * PER_CLOCK


def op_counts(kind, P, N, alive_rows):
    """The fewest operations per class that the secure-aggregation or DP
    kernel needs for these inputs (only surviving pairs exchange pads)."""
    K = alive_rows * (alive_rows - 1) // 2
    A = alive_rows
    if kind == "masked_rolling_update":
        return dict(alu=N * (6 * K + 2), imad=N * (2 * K + 1), iadd=N * K,
                    fp=N * (6 * A + 1), cvt=N * A, sfu=0)
    if kind == "masked_field_wsum":
        return dict(alu=N * 2 * A, imad=0, iadd=N * A, fp=N * A, cvt=N * A,
                    sfu=0)
    return dict(alu=N * (A * 12 + 2), imad=N * (4 * A + 1), iadd=N * A,
                fp=N * A * 11, cvt=N * A * 2, sfu=N * A * 3)


def bound(kind, P, N, alive_rows):
    """(bytes_ms, ops_ms): bytes over the HBM rate (each input read once,
    each output written once), and the slowest class of operations over
    its pipe's rate; int32 adds may fill either integer pipe."""
    nbytes = {"masked_rolling_update": 2 * P * N * 4,
              "masked_field_wsum": P * N * 4 + N * 4,
              "clip_noise": 2 * P * N * 4 + P * 4}[kind]
    c = op_counts(kind, P, N, alive_rows)
    t_ops = max(c["alu"] / ALU_OPS_PER_S, c["imad"] / IMAD_OPS_PER_S,
                (c["alu"] + c["imad"] + c["iadd"])
                / (ALU_OPS_PER_S + IMAD_OPS_PER_S),
                c["fp"] / FP32_OPS_PER_S, c["cvt"] / CVT_OPS_PER_S,
                c["sfu"] / SFU_OPS_PER_S)
    return nbytes / HBM_BYTES_PER_S * 1e3, t_ops * 1e3


def flash_bound(B, S, Hq, Hkv, hd, itemsize=2, window=0,
                rate=BF16_TC_FLOPS, causal=True):
    """(bytes_ms, ops_ms) of attention: q, k, v and o moved once; 4 * hd
    flops per unmasked (q, k) pair and head."""
    nbytes = B * S * hd * (2 * Hq + 2 * Hkv) * itemsize
    W = min(window, S) if window > 0 else S
    if causal:
        pairs = W * (W + 1) / 2 + (S - W) * W
    else:
        assert window == 0, "no path runs a non-causal window"
        pairs = S * S
    flops = 4 * hd * B * Hq * pairs
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3


def wkv6_bound(B, T, H, hd, itemsize=2, w_itemsize=4):
    """(bytes_ms, ops_ms) of WKV6: r, k, v, w read and y written once, u
    and the two states moved once; 5 fp32 operations per state element
    and token."""
    n = B * T * H * hd
    nbytes = (n * (4 * itemsize + w_itemsize) + H * hd * 4
              + 2 * B * H * hd * hd * 4)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            5 * n * hd / FP32_OPS_PER_S * 1e3)


def ssm_bound(Bz, T, di, N, itemsize=4):
    """(bytes_ms, ops_ms) of the selective scan: a, bx, B, C read and y
    written once, h0 and h_last moved once; 5 operations per (t, c, n)."""
    nbytes = Bz * T * (3 * di + 2 * N) * itemsize + 2 * Bz * di * N * 4
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            5 * Bz * T * di * N / FP32_OPS_PER_S * 1e3)


def bound_ms(pair) -> float:
    """The least time of a (bytes_ms, ops_ms) pair: the larger of the two."""
    return max(pair)


# ----------------------------------------------------------------------
# FLOPs of the models, from their shapes

def cnn_forward_flops(image_size, in_channels, channels, n_classes):
    """Forward FLOPs of one image through the 3x3 SAME conv stack (2 x
    multiply-adds), each conv followed by a 2x2 pool, then the dense
    head.  Bias adds, ReLUs and pools are not counted."""
    hw, cin, total = image_size, in_channels, 0.0
    for cout in channels:
        total += 2.0 * hw * hw * 9 * cin * cout
        cin, hw = cout, hw // 2
    return total + 2.0 * hw * hw * cin * n_classes


def cnn_train_flops(model, images):
    """Forward plus backward FLOPs of `images` images: 3 x forward (the
    backward takes the gradients of inputs and weights), no
    recomputation."""
    return 3.0 * images * cnn_forward_flops(
        model["image_size"], model["in_channels"], model["channels"],
        model["n_classes"])


def rwkv6_token_flops(model, param_count):
    """FLOPs of one RWKV-6 token: 2 x every parameter but the embedding
    table, plus the WKV state update and read-out, 4 x H x hd^2 a
    layer."""
    d, V = model["d_model"], model["vocab_size"]
    H, hd = d // model["wkv_head_dim"], model["wkv_head_dim"]
    return (2.0 * (param_count - V * d)
            + 4.0 * H * hd * hd * model["n_layers"])
