"""Batched serving engine: prefill + decode with rolling KV caches.

`make_serve_step` is the single-token step: one new token per sequence
against a cache of `max_seq_len` context (rolling-window-bounded where the
arch uses a sliding window).

`ServingEngine` is the host-side loop: continuous batching over a
request queue, greedy or temperature sampling (numpy RNG, as the
reference), prefill admission on the batched `models.prefill` path (the
flash kernel on the card), token-wise admission as the A/B alternative,
and mid-traffic hot-swap (`swap_params`): a newly committed federated
model is staged, in-flight requests drain on the params they were
admitted under, and the swap applies at a tick boundary with zero
dropped requests.

Unlike the reference's pure functions, `_insert_slot_state` and
`_reset_slot` write the slot's row of the batched decode state in place,
which saves a copy of the whole cache per admission.  The engine runs on
``device`` (default ``cuda``, raising without one); params given on the
host are copied there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import models, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.pytree import tree_map

Pytree = Any


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq_len: int = 2048
    batch_size: int = 8
    temperature: float = 0.0      # 0 = greedy
    eos_token: int = 2


def make_serve_step(cfg: ModelConfig):
    """(params, state, tokens (B,), pos (B,)) -> (logits (B,V), state)."""
    def serve_step(params, state, tokens, pos):
        return models.decode_step(cfg, params, state, tokens, pos)
    return serve_step


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    params_version: int = -1      # engine params version at admission
    admitted_tick: int = -1


class ServingEngine:
    """Continuous batching: slots hold active requests.

    Prompt ingestion uses the batched `models.prefill` path (one forward
    pass filling the KV cache, then written into the slot's row of the
    batched decode state).  `use_prefill=False` ingests token by token
    through the decode step (kept for A/B tests).

    Hot-swap: `swap_params(new_params)` stages the next model version.
    Admission pauses, in-flight requests complete on the params they
    started under, and once every slot drains the staged params apply at
    the top of a tick; admission resumes the same tick, the queue is never
    dropped, and requests admitted after the swap are token-identical to a
    fresh engine started on the new params (greedy decode rows are
    slot-independent for dense archs)."""

    def __init__(self, cfg: ModelConfig, params: Pytree, scfg: ServeConfig,
                 seed: int = 0, use_prefill: bool = True, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = self._on_device(params)
        self.scfg = scfg
        self.use_prefill = use_prefill
        self.state = models.init_decode_state(cfg, scfg.batch_size,
                                              scfg.max_seq_len, self.device)
        # B=1 template of a fresh slot row: token-path admission writes it
        # over the slot so a reused slot can't see the previous request's
        # KV cache (decode_attention only masks never-written rows)
        self._fresh_row = models.init_decode_state(cfg, 1, scfg.max_seq_len,
                                                   self.device)
        self.step_fn = make_serve_step(cfg)
        self.slots: List[Optional[Request]] = [None] * scfg.batch_size
        self.slot_pos = np.zeros(scfg.batch_size, np.int32)
        self.slot_pending: List[List[int]] = [[] for _ in
                                              range(scfg.batch_size)]
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.rng = np.random.default_rng(seed)
        self.tick = 0
        self.submitted = 0
        self.params_version = 0
        self._staged: Optional[Tuple[Pytree, int]] = None
        self.swap_log: List[Dict[str, int]] = []

    def _on_device(self, params: Pytree) -> Pytree:
        return tree_map(lambda x: torch.as_tensor(x).to(self.device), params)

    def submit(self, req: Request) -> None:
        self.queue.append(req)
        self.submitted += 1

    def swap_params(self, params: Pytree,
                    version: Optional[int] = None) -> int:
        """Stage a new model.  The swap applies at the first tick boundary
        where every slot has drained; until then admission is paused and
        in-flight requests keep decoding on the old params.  Returns the
        version the staged params will serve as."""
        if version is None:
            version = self.params_version + 1
        self._staged = (self._on_device(params), version)
        self.swap_log.append({"version": version, "staged_tick": self.tick,
                              "applied_tick": -1, "pause_ticks": -1})
        return version

    @property
    def swap_pending(self) -> bool:
        return self._staged is not None

    def _apply_staged(self) -> None:
        if self._staged is None or any(s is not None for s in self.slots):
            return
        self.params, self.params_version = self._staged
        self._staged = None
        entry = self.swap_log[-1]
        entry["applied_tick"] = self.tick
        entry["pause_ticks"] = self.tick - entry["staged_tick"]

    def _insert_slot_state(self, i: int, one_state: Pytree) -> None:
        """Write a B=1 state into batch row i, in place (the batch dim is
        axis 1: (L, B, ...))."""
        for key, full in self.state.items():
            full[:, i] = one_state[key][:, 0]

    def _reset_slot(self, i: int) -> None:
        """Restore batch row i to a fresh init row (empty cache) before
        token-by-token ingestion reuses the slot."""
        self._insert_slot_state(i, self._fresh_row)

    def _finish(self, i: int, req: Request) -> None:
        req.done = True
        self.finished.append(req)
        self.slots[i] = None

    def _admit(self) -> None:
        if self._staged is not None:          # draining toward a hot-swap
            return
        for i, slot in enumerate(self.slots):
            if slot is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                req.params_version = self.params_version
                req.admitted_tick = self.tick
                if self.use_prefill:
                    toks = torch.tensor([req.prompt], dtype=torch.int32,
                                        device=self.device)
                    logits, one_state, _ = models.prefill(
                        self.cfg, self.params, {"tokens": toks},
                        self.scfg.max_seq_len)
                    self._insert_slot_state(i, one_state)
                    self.slot_pos[i] = len(req.prompt)
                    self.slot_pending[i] = []
                    first = self._sample(logits[0, -1].float().cpu().numpy())
                    req.generated.append(first)
                    if (len(req.generated) >= req.max_new_tokens
                            or first == self.scfg.eos_token):
                        self._finish(i, req)
                else:
                    self._reset_slot(i)
                    self.slot_pos[i] = 0
                    self.slot_pending[i] = list(req.prompt)

    def step(self) -> None:
        """One engine tick: feed each active slot its next token.  A staged
        hot-swap applies here, at the tick boundary before admission, once
        every in-flight request has drained."""
        self._apply_staged()
        self._admit()
        tokens = np.zeros(self.scfg.batch_size, np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if self.slot_pending[i]:
                tokens[i] = self.slot_pending[i][0]
            elif req.generated:
                tokens[i] = req.generated[-1]
            else:
                tokens[i] = req.prompt[-1]
        logits, self.state = self.step_fn(
            self.params, self.state,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(self.slot_pos.copy()).to(self.device))
        logits = logits.float().cpu().numpy()

        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.slot_pos[i] += 1
            if self.slot_pending[i]:
                self.slot_pending[i].pop(0)
                if self.slot_pending[i]:
                    continue                       # still ingesting
            nxt = self._sample(logits[i])
            req.generated.append(int(nxt))
            if (len(req.generated) >= req.max_new_tokens
                    or nxt == self.scfg.eos_token
                    or self.slot_pos[i] >= self.scfg.max_seq_len - 1):
                self._finish(i, req)
        self.tick += 1

    def _sample(self, logits: np.ndarray) -> int:
        if self.scfg.temperature <= 0:
            return int(logits.argmax())
        p = logits / self.scfg.temperature
        p = np.exp(p - p.max())
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        ticks = 0
        while (self.queue or self._staged is not None
               or any(s is not None for s in self.slots)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished
