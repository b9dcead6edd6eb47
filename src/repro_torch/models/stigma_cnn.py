"""The paper's evaluation workload: a 3-layer CNN for laparoscopic frame
classification (GLENDA-like), channels {32, 64, 128} (paper §5.2).

Params keep the JAX package's tree and layout, ``{'conv': [{'w', 'b'} x 3],
'head': {'w', 'b'}}`` with HWIO conv weights, and images stay NHWC: the
ravel order and the ledger fingerprints depend on that layout.  `forward`
permutes to OIHW / NCHW only internally.  ``width_scale`` < 1 shrinks every
conv (the paper's accuracy-for-time knob).  Training runs under
`full_fp32`, so the card computes in IEEE float32 like the reference.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.stigma_cnn import CNNConfig

Params = Dict[str, Any]


def scaled_channels(cfg: CNNConfig, width_scale: float = 1.0):
    return tuple(max(int(round(c * width_scale)), 4) for c in cfg.channels)


def init_params(cfg: CNNConfig, generator: torch.Generator,
                width_scale: float = 1.0,
                device: Optional[torch.device] = None) -> Params:
    """Random params drawn from `generator` (on the CPU, then moved, so a
    seed gives the same weights on every device)."""
    chans = scaled_channels(cfg, width_scale)

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    params: Params = {"conv": []}
    cin = cfg.in_channels
    for cout in chans:
        params["conv"].append({"w": normal(3, 3, cin, cout) / math.sqrt(9 * cin),
                               "b": torch.zeros(cout)})
        cin = cout
    feat = cfg.image_size // (2 ** len(chans))
    d = feat * feat * chans[-1]
    params["head"] = {"w": normal(d, cfg.n_classes) / math.sqrt(d),
                      "b": torch.zeros(cfg.n_classes)}
    if device is not None:
        params = {"conv": [{k: v.to(device) for k, v in layer.items()}
                           for layer in params["conv"]],
                  "head": {k: v.to(device) for k, v in params["head"].items()}}
    return params


@contextlib.contextmanager
def full_fp32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the block
    (forward and backward alike), and cuDNN held to its deterministic
    algorithms, the caller's settings restored after.  Without the last,
    cuDNN may pick convolution backward algorithms that sum with atomics:
    two same-seed federations on an H100 then end rounds apart in most of
    their parameters, and a run resumed from a snapshot is no replay of
    the run that took it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = saved


def forward(cfg: CNNConfig, params: Params, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, C) float32 -> logits (B, n_classes)."""
    x = images.permute(0, 3, 1, 2)
    for layer in params["conv"]:
        # 3x3, stride 1, SAME padding; HWIO -> OIHW
        x = F.conv2d(x, layer["w"].permute(3, 2, 0, 1), padding=1)
        x = F.relu(x + layer["b"].reshape(1, -1, 1, 1))
        x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten order
    return x @ params["head"]["w"] + params["head"]["b"]


def loss_fn(cfg: CNNConfig, params: Params, images, labels):
    """(mean cross-entropy, accuracy) of one batch."""
    logits = forward(cfg, params, images)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, -1, labels.long()[:, None]).mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return loss, acc


def flops_per_image(cfg: CNNConfig, width_scale: float = 1.0) -> float:
    """Analytic forward FLOPs of one image."""
    chans = scaled_channels(cfg, width_scale)
    hw = cfg.image_size
    cin = cfg.in_channels
    total = 0.0
    for cout in chans:
        total += 2.0 * hw * hw * 9 * cin * cout       # conv
        cin, hw = cout, hw // 2
    total += 2.0 * hw * hw * cin * cfg.n_classes      # head
    return total
