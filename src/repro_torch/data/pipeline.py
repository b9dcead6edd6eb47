"""Synthetic GLENDA-like frames for the paper's CNN, split across hospitals.

Numpy copies of the JAX package's ``DirichletPartitioner`` and
``SyntheticGlendaDataset``: both are pure functions of their numpy seeds,
so the port's batches are byte-identical to the JAX package's.  Data is
partitioned per institution and never mixes (paper Gap 1); each
institution's frames carry a camera bias (non-IID).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


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
