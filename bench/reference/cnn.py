"""The paper's CNN federation, followed round by round in plain PyTorch.

A hospital's row is the tree ``{'conv': [{'w', 'b'} x 3], 'head': {'w',
'b'}}`` with HWIO conv weights and NHWC images.  Each round: every
hospital runs `local_steps` plain SGD steps on its own batches (one
autograd pass a hospital and step, no vmap); with DP each surviving
hospital's round update is clipped to the clip norm over its whole row
and noised (`prg.dp_normals`); the survivors' rows become their mean;
the others keep their trained rows; a round that did not commit leaves
every hospital on its trained row.  Who survived and whether the round
committed are the program's outputs that the reference reads; every
number is its own.

Float32 throughout, TF32 off unless `tf32` asks for it (the control).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bench import roofline
from bench.reference import prg

# leaf order of a row's ravel (dict keys sorted, list order)
LEAVES = [("conv", 0, "b"), ("conv", 0, "w"), ("conv", 1, "b"),
          ("conv", 1, "w"), ("conv", 2, "b"), ("conv", 2, "w"),
          ("head", None, "b"), ("head", None, "w")]


# the program's tree structure, as its fingerprints spell it
TREEDEF = ("PyTreeDef({'conv': [{'b': *, 'w': *}, {'b': *, 'w': *}, "
           "{'b': *, 'w': *}], 'head': {'b': *, 'w': *}})")


def leaf_shapes(model) -> List[tuple]:
    """The shapes of one hospital's leaves, in `LEAVES` order."""
    out, cin, hw = [], model["in_channels"], model["image_size"]
    for cout in model["channels"]:
        out += [(cout,), (3, 3, cin, cout)]
        cin, hw = cout, hw // 2
    return out + [(model["n_classes"],),
                  (hw * hw * cin, model["n_classes"])]


def make_params(model, P, g, dev, jitter=0.01) -> List[torch.Tensor]:
    """(P, ...) leaves: one common draw (weights N(0, 1/fan_in), biases
    0) plus per-hospital jitter, each in one call on the card."""
    shapes = leaf_shapes(model)
    sizes = [math.prod(s) for s in shapes]
    base = torch.randn(sum(sizes), generator=g, device=dev)
    jit = torch.randn((P, sum(sizes)), generator=g, device=dev)
    out, off = [], 0
    for shape, n in zip(shapes, sizes):
        scale = 0.0 if len(shape) == 1 else 1.0 / math.sqrt(
            math.prod(shape[:-1]))
        row = base[off:off + n] * scale
        out.append((row[None] + jitter * jit[:, off:off + n])
                   .reshape((P,) + shape).contiguous())
        off += n
    return out


def train_flops(model, images) -> float:
    """Forward plus backward FLOPs of `images` training images."""
    return roofline.cnn_train_flops(model, images)


def get(tree, path):
    top, i, k = path
    return tree[top][i][k] if i is not None else tree[top][k]


def leaves(tree) -> List[torch.Tensor]:
    return [get(tree, p) for p in LEAVES]


def from_leaves(ls) -> Dict:
    conv = [{"b": ls[2 * i], "w": ls[2 * i + 1]} for i in range(3)]
    return {"conv": conv, "head": {"b": ls[6], "w": ls[7]}}


@contextlib.contextmanager
def precision(tf32: bool):
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def forward(params, images):
    """images (B, H, W, C) -> logits (B, classes): 3x3 SAME conv, ReLU,
    2x2 max pool, three times; flatten in NHWC order; dense head."""
    x = images.permute(0, 3, 1, 2)
    for layer in params["conv"]:
        x = F.conv2d(x, layer["w"].permute(3, 2, 0, 1), padding=1)
        x = F.max_pool2d(F.relu(x + layer["b"].reshape(1, -1, 1, 1)), 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return x @ params["head"]["w"] + params["head"]["b"]


def loss_fn(params, images, labels):
    logp = torch.log_softmax(forward(params, images), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def local_train(row: List[torch.Tensor], images, labels, lr):
    """`row` leaves after len(images) SGD steps; images (steps, B, ...).
    Returns (leaves, the last step's loss)."""
    w = [t.detach().clone() for t in row]
    loss = None
    for s in range(images.shape[0]):
        w = [t.requires_grad_(True) for t in w]
        loss = loss_fn(from_leaves(w), images[s], labels[s])
        grads = torch.autograd.grad(loss, w)
        w = [(t - lr * g).detach() for t, g in zip(w, grads)]
    return w, float(loss.detach())


def _ravel(rows: List[torch.Tensor]) -> torch.Tensor:
    P = rows[0].shape[0]
    return torch.cat([r.reshape(P, -1) for r in rows], dim=1)


def _unravel(mat: torch.Tensor, like: List[torch.Tensor]):
    out, off = [], 0
    for leaf in like:
        n = leaf[0].numel()
        out.append(mat[:, off:off + n].reshape(leaf.shape))
        off += n
    return out


def dp_publish(start, trained, survivors, seed, clip, sigma):
    """Surviving rows: start + min(1, C/||d||) d + sigma C z, with d the
    round update over the whole row; other rows: their trained values."""
    s, t = _ravel(start), _ravel(trained)
    d = t - s
    norm = torch.sqrt(torch.square(d).sum(dim=1, keepdim=True))
    factor = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    z = torch.from_numpy(prg.dp_normals(seed, d.shape[0], d.shape[1])
                         ).to(d.device)
    pub = s + (factor * d + (sigma * clip) * z)
    alive = torch.zeros(d.shape[0], dtype=torch.bool, device=d.device)
    alive[list(survivors)] = True
    return _unravel(torch.where(alive[:, None], pub, t), start)


def follow(stacked: Sequence[torch.Tensor], images, labels, keys,
           survivors, committed, lr, dp: Optional[Dict] = None,
           tf32: bool = False):
    """Follow len(survivors) rounds from the stacked leaves (P, ...).
    images (R, steps, P, B, H, W, C), labels (R, steps, P, B), keys (R, 2)
    uint32.  Returns (the stacked leaves after each round, (R, P) last-step
    losses)."""
    P = stacked[0].shape[0]
    state = [t.detach().clone() for t in stacked]
    after, losses = [], np.zeros((len(survivors), P))
    with precision(tf32):
        for r in range(len(survivors)):
            rows = []
            for p in range(P):
                w, losses[r, p] = local_train(
                    [t[p] for t in state], images[r, :, p], labels[r, :, p],
                    lr)
                rows.append(w)
            trained = [torch.stack([w[i] for w in rows])
                       for i in range(len(LEAVES))]
            pub = trained
            surv = list(survivors[r])
            if dp is not None and surv:
                seed = prg.merge_seed(keys[r]) ^ int(dp["seed"])
                pub = dp_publish(state, trained, surv, seed,
                                 dp["clip_norm"], dp["noise_multiplier"])
            if committed[r] and surv:
                merged = []
                for pl, tl in zip(pub, trained):
                    mean = pl[surv].mean(dim=0)
                    out = tl.clone()
                    out[surv] = mean
                    merged.append(out)
                state = merged
            else:
                state = trained
            after.append([t.clone() for t in state])
    return after, losses
