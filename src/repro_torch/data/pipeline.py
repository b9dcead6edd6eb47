"""Synthetic GLENDA-like frames for the paper's CNN, split across hospitals,
the language models' synthetic token corpus, and the device tier's
per-device shards.

Numpy copies of the JAX package's ``DirichletPartitioner`` and
``SyntheticGlendaDataset``: both are pure functions of their numpy seeds,
so the port's batches are byte-identical to the JAX package's.  Data is
partitioned per institution and never mixes (paper Gap 1); each
institution's frames carry a camera bias (non-IID).

The token corpus (`SyntheticTokenDataset`, `institution_batches`) is the
JAX package's numpy generator verbatim, so its tokens are bit-equal to
the reference's; `make_batch_specs` gives a batch's shapes and torch
dtypes with the logical axes as plain tuples.

The device tier's shards (`DeviceShardSpec`, `make_device_data_fn`) are
counter-PRG functions of (seed, sweep, institution, device) drawn on the
device, bit-equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.chaos.rng import hash_u32_traced, uniform_traced
from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 256
    global_batch: int = 8
    seed: int = 0
    order: int = 3          # markov order of the synthetic structure


class SyntheticTokenDataset:
    """Deterministic pseudo-corpus for the language models: zipf-ish
    marginals plus a learnable cycle on every other token, so the LM loss
    falls.  Modality-aware: audio batches carry frame embeddings and
    per-frame labels, VLM batches patch embeddings before the text."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        rng = np.random.default_rng(data.seed)
        self.perm = rng.permutation(cfg.vocab_size)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """The batch of `step`, a pure function of (seed, step)."""
        d = self.data
        rng = np.random.default_rng((self.data.seed, step))
        V = self.cfg.vocab_size
        base = rng.zipf(1.3, size=(d.global_batch, d.seq_len)).astype(np.int64)
        tokens = (base % (V - 2)) + 1
        # every other token continues a cycle: predictable, learnable
        cyc = np.cumsum(tokens, axis=1) % (V - 2) + 1
        mask = (np.arange(d.seq_len) % 2).astype(bool)
        tokens[:, mask] = cyc[:, mask]
        tokens = self.perm[tokens]
        batch = {"tokens": tokens.astype(np.int32)}
        if self.cfg.modality == "audio":
            emb = rng.standard_normal(
                (d.global_batch, d.seq_len, self.cfg.d_model)).astype(np.float32)
            batch = {"frame_embeddings": emb,
                     "labels": (tokens % self.cfg.vocab_size).astype(np.int32)}
        elif self.cfg.modality == "vlm":
            P = min(self.cfg.n_image_patches, d.seq_len // 2)
            emb = rng.standard_normal(
                (d.global_batch, P, self.cfg.d_model)).astype(np.float32)
            batch = {"tokens": tokens[:, :d.seq_len - P].astype(np.int32),
                     "patch_embeddings": emb}
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_batch_specs(cfg: ModelConfig, seq_len: int, global_batch: int,
                     kind: str):
    """({key: (shape, torch dtype)}, {key: logical axes}) of one input
    batch of `kind` ("train", "prefill" or "decode")."""
    if kind == "decode":
        specs = {"tokens": ((global_batch,), torch.int32),
                 "pos": ((global_batch,), torch.int32)}
        axes = {"tokens": ("batch",), "pos": ("batch",)}
        return specs, axes
    specs, axes = {}, {}
    if cfg.modality == "audio":
        specs["frame_embeddings"] = ((global_batch, seq_len, cfg.d_model),
                                     torch.bfloat16)
        axes["frame_embeddings"] = ("batch", "seq", "embed")
        specs["labels"] = ((global_batch, seq_len), torch.int32)
        axes["labels"] = ("batch", "seq")
    elif cfg.modality == "vlm":
        P = cfg.n_image_patches
        specs["tokens"] = ((global_batch, seq_len - P), torch.int32)
        axes["tokens"] = ("batch", "seq")
        specs["patch_embeddings"] = ((global_batch, P, cfg.d_model),
                                     torch.bfloat16)
        axes["patch_embeddings"] = ("batch", "seq", "embed")
    else:
        specs["tokens"] = ((global_batch, seq_len), torch.int32)
        axes["tokens"] = ("batch", "seq")
    return specs, axes


def institution_batches(dataset: SyntheticTokenDataset, n_institutions: int,
                        local_steps: int, round_index: int) -> np.ndarray:
    """(local_steps, P, B_local, S) int32 token stacks of one round:
    institution i's rows of each step's global batch, so institutions'
    data stays disjoint."""
    d = dataset.data
    assert d.global_batch % n_institutions == 0
    bl = d.global_batch // n_institutions
    out = []
    for s in range(local_steps):
        step_id = round_index * local_steps + s
        full = dataset.batch(step_id)["tokens"]
        out.append(full.reshape(n_institutions, bl, d.seq_len))
    return np.stack(out)


@dataclasses.dataclass(frozen=True)
class DirichletPartitioner:
    """Label-skewed non-IID hospital splits: for every class c, institution
    proportions p_c ~ Dirichlet(alpha * 1_P) deal that class's samples out.
    Small `alpha` concentrates each class in a few hospitals.  The index
    sets are disjoint, cover the dataset, give every institution at least
    `min_per_institution` samples, and depend only on (seed, alpha,
    n_institutions, labels)."""
    n_institutions: int
    alpha: float = 0.5
    seed: int = 0
    min_per_institution: int = 1

    def _rng(self) -> np.random.Generator:
        # alpha folded in at fixed precision so partitions with different
        # concentration draw decorrelated proportion streams
        return np.random.default_rng(
            [self.seed, self.n_institutions,
             int(min(self.alpha, 1e12) * 1e6)])

    def _proportions(self, rng: np.random.Generator,
                     n_classes: int) -> np.ndarray:
        a = min(self.alpha, 1e9)        # dirichlet rejects inf; 1e9 ~ uniform
        return rng.dirichlet(
            np.full(self.n_institutions, a, np.float64), size=n_classes)

    def proportions(self, n_classes: int) -> np.ndarray:
        """(n_classes, P): row c is class c's institution split, the exact
        proportions `assign` deals by (both draw first from the stream)."""
        return self._proportions(self._rng(), n_classes)

    def assign(self, labels: np.ndarray) -> np.ndarray:
        """(n_samples,) institution id per sample."""
        labels = np.asarray(labels)
        P = self.n_institutions
        if len(labels) < P * self.min_per_institution:
            raise ValueError(
                f"{len(labels)} samples cannot give {P} institutions "
                f">= {self.min_per_institution} each")
        rng = self._rng()
        props = self._proportions(rng, int(labels.max(initial=0)) + 1)
        out = np.zeros(len(labels), np.int64)
        for c in np.unique(labels):
            idx = np.flatnonzero(labels == c)
            idx = rng.permutation(idx)
            # largest-remainder allocation: counts sum exactly to len(idx)
            quota = props[c] * len(idx)
            counts = np.floor(quota).astype(np.int64)
            rem = len(idx) - counts.sum()
            order = np.argsort(-(quota - counts), kind="stable")
            counts[order[:rem]] += 1
            out[idx] = np.repeat(np.arange(P), counts)
        # top up starved institutions from the largest ones (deterministic)
        sizes = np.bincount(out, minlength=P)
        for i in np.flatnonzero(sizes < self.min_per_institution):
            while sizes[i] < self.min_per_institution:
                donor = int(sizes.argmax())
                moved = np.flatnonzero(out == donor)[0]
                out[moved] = i
                sizes[donor] -= 1
                sizes[i] += 1
        return out


@dataclasses.dataclass(frozen=True)
class DeviceShardSpec:
    """Per-DEVICE synthetic shards under one institution (the device tier).

    A device's shard is a pure function of ``(seed, sweep, institution,
    device)`` through the counter RNG, generated on the device one chunk
    at a time, so no (D, ...) dataset is ever materialized:

      * ``label``: the device's dominant pathology class, drawn from its
        institution's Dirichlet class mix (`institution_class_mixes`), the
        label skew of `DirichletPartitioner` one tier down;
      * ``pull``: uniform [0, 1) local step-size jitter;
      * ``weight``: integer sample count in [min_samples, max_samples],
        the device's FedAvg aggregation weight.

    `make_centroid_pull_update` gives each class a fixed unit centroid and
    lets a device's update pull the model toward its class centroid, one
    SGD step on 1/2 ||w - c_label||^2 scaled by ``pull``.  The update is
    elementwise in the params, so the sweep has no float reduction whose
    order a chunk size could change.
    """
    n_classes: int = 4
    n_features: int = 16
    min_samples: int = 1
    max_samples: int = 64
    pull_lr: float = 0.05
    seed: int = 0

    def __post_init__(self):
        if self.n_classes < 1 or self.n_features < 1:
            raise ValueError("n_classes and n_features must be >= 1")
        if not 1 <= self.min_samples <= self.max_samples:
            raise ValueError(
                f"need 1 <= min_samples <= max_samples; got "
                f"[{self.min_samples}, {self.max_samples}]")


# device-tier data streams, decorrelated from each other and from the
# chaos fault streams under a shared seed
_DEV_STREAM_LABEL = 0x1ABE1
_DEV_STREAM_PULL = 0x9311
_DEV_STREAM_WEIGHT = 0x5A3F


def institution_class_mixes(partitioner: "DirichletPartitioner",
                            n_classes: int) -> np.ndarray:
    """(P, n_classes) row-stochastic class mix per institution, from the
    same Dirichlet proportions `assign` deals by: normalizing the
    (n_classes, P) draw's columns turns "institution p's share of class
    c" into "class c's share of institution p's devices"."""
    props = partitioner.proportions(n_classes).T    # (P, n_classes)
    props = props + 1e-12                           # no all-zero rows
    return (props / props.sum(axis=1, keepdims=True)).astype(np.float32)


def class_centroids(spec: DeviceShardSpec) -> np.ndarray:
    """(n_classes, n_features) fixed unit-norm class centroids, each
    class's local optimum in the centroid-pull device model."""
    rng = np.random.default_rng((spec.seed, 0xC3))
    c = rng.standard_normal((spec.n_classes, spec.n_features))
    c = c / np.linalg.norm(c, axis=1, keepdims=True)
    return c.astype(np.float32)


def _per_device(host: np.ndarray):
    """A lookup of `host` as a tensor on a given device, copied there once
    (the first call on that device), never inside a chunk loop after."""
    cache = {}

    def on(device: torch.device) -> torch.Tensor:
        key = str(device)
        if key not in cache:
            cache[key] = torch.from_numpy(host).to(device)
        return cache[key]
    return on


def make_device_data_fn(spec: DeviceShardSpec, class_mixes: np.ndarray):
    """Per-device shard generator for `core.device_tier`:

        data_fn(sweep, inst, device_ids) -> ({"label", "pull"}, weights)

    ``label`` int32, ``pull`` float32 and ``weights`` the uint32 sample
    counts held in int64, each a pure counter-RNG function of its
    arguments on `device_ids`' device: device d's shard does not depend on
    which chunk evaluates it.  No host sync, so it runs under
    `torch.func.vmap` over institutions."""
    mixes = np.asarray(class_mixes, np.float32)
    if mixes.ndim != 2 or mixes.shape[1] != spec.n_classes:
        raise ValueError(f"class_mixes must be (P, {spec.n_classes}); got "
                         f"{mixes.shape}")
    cum = _per_device(np.cumsum(mixes, axis=1))     # (P, n_classes)
    span = spec.max_samples - spec.min_samples + 1

    def data_fn(sweep, inst, device_ids):
        u_lab = uniform_traced(spec.seed, _DEV_STREAM_LABEL, sweep, inst,
                               device_ids)
        row = cum(u_lab.device)[inst]               # (n_classes,)
        label = (u_lab[:, None] >= row[None, :-1]).sum(dim=1).to(
            torch.int32)
        pull = uniform_traced(spec.seed, _DEV_STREAM_PULL, sweep, inst,
                              device_ids)
        w = spec.min_samples + (
            hash_u32_traced(spec.seed, _DEV_STREAM_WEIGHT, sweep, inst,
                            device_ids) % span)
        return {"label": label, "pull": pull}, w
    return data_fn


def make_centroid_pull_update(spec: DeviceShardSpec):
    """Device-local update for the centroid-pull model: one SGD step on
    1/2 ||w - c_label||^2 scaled by the device's pull jitter,

        u = -pull_lr * (0.5 + pull) * (w - centroids[label])

    for params ``{"w": (n_features,)}``, in the JAX package's float32
    operation order.  Elementwise in w, so the update's bits do not depend
    on the chunk layout."""
    cent = _per_device(class_centroids(spec))
    lr = float(np.float32(spec.pull_lr))

    def update_fn(params, batch):
        w = params["w"]
        target = cent(w.device)[batch["label"]]
        scale = lr * (0.5 + batch["pull"])
        return {"w": -scale * (w - target)}
    return update_fn


class SyntheticGlendaDataset:
    """Paper §5.2: 'medical multimodal data from laparoscopic procedures
    limited to 500 samples', synthesized: pathology = bright blob texture.

    `partitioner` replaces the round-robin institution assignment with a
    label-skewed split; the per-hospital camera bias follows the
    assignment.

    `label_flip_institutions`: the listed institutions' training labels
    are flipped after the images are rendered (the frames still show the
    true pathology; the labels lie), the data-poisoning attack of
    `chaos.attacks` ``label_flip``.  Flipping follows every RNG draw, so
    the empty default is the unpoisoned dataset."""

    def __init__(self, image_size: int = 64, n_samples: int = 500,
                 n_institutions: int = 1, seed: int = 0,
                 partitioner: Optional[DirichletPartitioner] = None,
                 label_flip_institutions: Sequence[int] = ()):
        rng = np.random.default_rng(seed)
        self.n_institutions = n_institutions
        self.images = np.zeros((n_samples, image_size, image_size, 3),
                               np.float32)
        self.labels = rng.integers(0, 2, n_samples).astype(np.int32)
        xx, yy = np.meshgrid(np.arange(image_size), np.arange(image_size))
        if partitioner is not None:
            if partitioner.n_institutions != n_institutions:
                raise ValueError(
                    f"partitioner splits {partitioner.n_institutions} "
                    f"ways but the dataset federates {n_institutions}")
            self.institution = partitioner.assign(self.labels)
        else:
            self.institution = np.arange(n_samples) % n_institutions
        for i in range(n_samples):
            base = rng.standard_normal((image_size, image_size, 3)) * 0.3
            base += 0.1 * self.institution[i]          # per-hospital camera bias
            if self.labels[i]:
                lo = min(image_size // 4, image_size - 2)
                cx, cy = rng.integers(lo, max(image_size - lo, lo + 1), 2)
                r = rng.integers(max(image_size // 16, 2),
                                 max(image_size // 6, 3))
                blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)
                                / (2.0 * r * r)))
                base[..., 0] += 2.0 * blob             # reddish lesion
            self.images[i] = base
        if len(label_flip_institutions):
            bad = [i for i in label_flip_institutions
                   if not 0 <= i < n_institutions]
            if bad:
                raise ValueError(f"label_flip institutions {bad} out of "
                                 f"range for {n_institutions}")
            poisoned = np.isin(self.institution,
                               np.asarray(label_flip_institutions))
            self.labels = np.where(poisoned, 1 - self.labels,
                                   self.labels).astype(np.int32)

    def institution_split(self, i: int):
        m = self.institution == i
        return self.images[m], self.labels[m]

    def batch(self, step: int, batch_size: int, institution: int = 0,
              seed: int = 0):
        imgs, labels = self.institution_split(institution)
        rng = np.random.default_rng((seed, step, institution))
        idx = rng.integers(0, len(imgs), batch_size)
        return imgs[idx], labels[idx]

    # the per-institution evaluation stream's tag: each hospital is scored
    # on its own population, not on a pooled test set
    _EVAL_STREAM = 0xE7A1

    def eval_batch(self, batch_size: int, institution: int = 0,
                   seed: int = 0):
        """A held-aside batch from `institution`'s own data, from an RNG
        stream apart from the training stream (`batch` keys on (seed,
        step, institution), this on the eval tag), so evaluation never
        replays a training draw."""
        imgs, labels = self.institution_split(institution)
        rng = np.random.default_rng((self._EVAL_STREAM, seed, institution))
        idx = rng.integers(0, len(imgs), batch_size)
        return imgs[idx], labels[idx]

    def eval_batches(self, batch_size: int, seed: int = 0):
        """(P, B, ...) images and (P, B) labels: row i is institution i's
        own held-aside batch."""
        per = [self.eval_batch(batch_size, i, seed)
               for i in range(self.n_institutions)]
        return (np.stack([b[0] for b in per]),
                np.stack([b[1] for b in per]))
