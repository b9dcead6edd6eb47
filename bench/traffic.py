"""The general traffic generator: requests from a cell's traffic
parameters and the seed.

Serving traffic is a closed loop: `sessions` clients, each sending its
next request as soon as its last is answered.  Requests are drawn in
order from a pool of `pool` requests (cycled if a run exhausts it).
Prompt and answer lengths are uniform over their ranges, stratified:
the pool holds the same set of lengths under every seed, at the
quantiles (i + 1/2) / pool, and the seed only orders them (prompts and
answers independently) and draws the prompt tokens.  So two seeds offer
the same work in another order.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def stratified(lo: int, hi: int, n: int, rng) -> np.ndarray:
    """n lengths uniform over [lo, hi] at the quantiles (i + 1/2) / n, in
    an order drawn from `rng`."""
    q = (np.arange(n) + 0.5) / n
    lengths = lo + np.floor(q * (hi - lo + 1)).astype(np.int64)
    return rng.permutation(np.minimum(lengths, hi))


def request_pool(tp: Dict, seed: int, vocab: int
                 ) -> List[Tuple[np.ndarray, int]]:
    """[(prompt tokens (int32), answer tokens)] of the cell's pool."""
    rng = np.random.default_rng(seed)
    n = int(tp["pool"])
    prompts = stratified(tp["prompt_min"], tp["prompt_max"], n, rng)
    answers = stratified(tp["answer_min"], tp["answer_max"], n, rng)
    tokens = rng.integers(0, vocab, size=int(prompts.sum()), dtype=np.int32)
    cuts = np.concatenate([[0], np.cumsum(prompts)])
    return [(tokens[cuts[i]:cuts[i + 1]], int(answers[i]))
            for i in range(n)]
