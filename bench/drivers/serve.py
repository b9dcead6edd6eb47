"""Driver of the serving cells: one replica of a language model behind
the federation's ledger, serving a closed loop of clinician sessions.

The configuration's file names the model: `model` (its sizes) and
`program` (the rest of the program's ``ModelConfig``: its family and
what the family leaves at 0) build the replica, and `reference` names
the plain reference (`bench/reference/<reference>.py`) that makes the
weights from the seed (`make_params`), counts a token's FLOPs
(`token_flops`) and judges the served tokens (`served_gaps`).  So
another configuration is served by a file of sizes and a reference of
its own, with no change here.

Set-up makes the weights on the card from the seed and publishes them:
it registers them on a ``ModelRegistry`` as a committed
``rolling_update`` through its public ``register`` (the publisher's
SHA-256 pass) and keeps them in a plain dict keyed by that fingerprint,
the hospital-side weight store that the pull treats as untrusted.  It
then builds a ``FederatedServer``: its verified pull (ledger audit,
inclusion proof, the fingerprint re-derived from the bytes) hands them
to a ``ServingEngine`` of `slots` slots, greedy, with no end-of-text
token.  `setup_s` is the time from the process's start to the window
less the publisher's pass: what a booting replica pays is the weights,
the verified pull and the warm-up.  Every session then sends a request,
and the loop runs until `warm_seconds` have passed and every session
has been answered once.  The window runs engine ticks
(``ServingEngine.step``, which ends by copying the logits to the host)
until `--seconds` have passed; a session whose request finishes sends
its next at once.

After the window the program is freed, the weights are made again from
the seed, and the plain reference (float32) runs over a sample of the
requests finished in the window, drawn from the seed with the longest
among them: over each prompt and its served tokens, at each served
position it reads how far the served token's logit lies below the
reference's best.

  logit_gap      the widest such gap over the sample
  short_answers  sampled requests served fewer tokens than they asked
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from bench import traffic
from bench.common import (Outcome, checks_from, p90, peak_bytes,
                          reference, spread)
from bench.trace import Window


def stamp(what, ctx):
    """A set-up milestone on standard error: seconds since the process
    started."""
    print(f"setup {what}: {time.time() - ctx.t_start:.1f} s",
          file=sys.stderr, flush=True)


def model_config(config: Dict):
    """The program's ``ModelConfig`` of a configuration's file."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name=config["name"], **config["model"],
                       **config["program"])


def serve_config(tp):
    """`slots` slots, greedy, no end-of-text token."""
    from repro_torch.serving.engine import ServeConfig
    return ServeConfig(max_seq_len=tp["max_seq_len"],
                       batch_size=tp["slots"], temperature=0.0,
                       eos_token=-1)


def publish(params, family):
    """The publisher's side: the weights registered on a ledger as a
    committed round, and a weight store that holds them under their
    fingerprint.  Returns (registry, store, seconds the registration
    took)."""
    from repro_torch.core.registry import ModelRegistry
    registry = ModelRegistry(logical_clock=True)
    t0 = time.perf_counter()
    tx = registry.register(kind="rolling_update", institution="overlay",
                           params=params, arch_family=family,
                           metadata={"round": 0, "committed": True})
    return registry, {tx.model_fingerprint: params}, \
        time.perf_counter() - t0


def serve(ctx, registry, store):
    """The replica: verified pull, engine."""
    from repro_torch.serving.federated import FederatedServer
    family = ctx.config["program"]["family"]
    return FederatedServer(model_config(ctx.config), registry, store,
                           serve_config(ctx.cell["traffic_params"]),
                           arch_family=family, device=ctx.device)


class Loop:
    """The closed loop around an engine, and its bookkeeping a tick."""

    def __init__(self, engine, pool, sessions):
        from repro_torch.serving.engine import Request
        self.Request = Request
        self.engine, self.pool = engine, pool
        self.next = 0
        self.live: Dict[int, Dict] = {}
        self.done: List[Dict] = []
        self.ticks: List[Dict] = []
        now = time.perf_counter()
        for _ in range(sessions):
            self.submit(now)

    def submit(self, now):
        prompt, answer = self.pool[self.next % len(self.pool)]
        uid = self.next
        self.next += 1
        req = self.Request(uid=uid, prompt=prompt.tolist(),
                           max_new_tokens=answer)
        self.live[uid] = {"req": req, "submit": now, "first": None,
                          "end": None, "prompt_len": len(prompt),
                          "answer": answer}
        self.engine.submit(req)

    def tick(self):
        before = {u: len(r["req"].generated) for u, r in self.live.items()}
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.engine_step"):
            self.engine.step()
        t1 = time.perf_counter()
        prefill, tokens, decoding, finished = [], 0, 0, []
        for uid, rec in self.live.items():
            got = len(rec["req"].generated) - before[uid]
            tokens += got
            admitted = before[uid] == 0 and got > 0
            if admitted:
                rec["first"] = t1
                prefill.append(rec["prompt_len"])
            if got - admitted > 0:
                decoding += 1
            if rec["req"].done:
                rec["end"] = t1
                finished.append(uid)
        for uid in finished:
            self.done.append(self.live.pop(uid))
            self.submit(t1)
        self.ticks.append({"t0": t0, "t1": t1, "prefill": prefill,
                           "tokens": tokens, "decoding": decoding})


def window_metrics(loop, t_open, t_close):
    ticks = [t for t in loop.ticks if t_open < t["t1"] <= t_close]
    recs = loop.done + list(loop.live.values())
    ttft = [r["first"] - r["submit"] for r in recs
            if r["first"] is not None and t_open < r["first"] <= t_close]
    lat = [r["end"] - r["submit"] for r in loop.done
           if t_open < r["end"] <= t_close]
    span = t_close - t_open
    return ({"out_tok_per_s": sum(t["tokens"] for t in ticks) / span,
             "ttft_p90_ms": None if p90(ttft) is None else p90(ttft) * 1e3,
             "request_p90_ms": None if p90(lat) is None else p90(lat) * 1e3},
            len(lat))


def tick_counters(ticks, ref, m, slots):
    flops = ref.token_flops(m)
    pre = sum(sum(t["prefill"]) for t in ticks)
    dec = sum(t["decoding"] for t in ticks)
    span = (ticks[-1]["t1"] - ticks[0]["t0"]) if ticks else 0.0
    return {"span_s": span, "prefill_flops": pre * flops,
            "decode_flops": dec * flops,
            "tick_s": [t["t1"] - t["t0"] for t in ticks],
            "occupancy": [t["decoding"] / slots for t in ticks]}


def sample(loop, t_open, t_close, n, seed):
    """`n` requests finished in the window, drawn from the seed, and the
    longest of them."""
    fin = [r for r in loop.done if t_open < r["end"] <= t_close]
    if not fin:
        return []
    longest = max(range(len(fin)),
                  key=lambda i: fin[i]["prompt_len"] + fin[i]["answer"])
    rng = np.random.default_rng(seed)
    pick = set(rng.choice(len(fin), size=min(n, len(fin)),
                          replace=False).tolist()) | {longest}
    return [{"prompt": list(fin[i]["req"].prompt),
             "served": list(fin[i]["req"].generated),
             "answer": fin[i]["answer"]} for i in sorted(pick)]


def judge(ref, m, params, picked, lower=False):
    """The numbers of a sample: the widest logit gap over its served
    tokens, and how many requests were served short."""
    gaps, short = [], 0
    for r in picked:
        if len(r["served"]) != r["answer"]:
            short += 1
        if r["served"]:
            gaps += ref.served_gaps(m, params, r["prompt"], r["served"],
                                    lower=lower)
    return {"logit_gap": max(gaps) if gaps else float("inf"),
            "short_answers": float(short)}


def run(ctx, control: bool = False, verified_pull: bool = True) -> Outcome:
    """One run of the cell.  `control` also reads the control's numbers on
    the same sample, into counters['control']; `verified_pull=False`
    hands the weights to the engine without the ledger (the same bytes,
    the same served tokens: `bench/readings.py` reads many seeds so)."""
    from repro_torch.serving.engine import ServingEngine
    tp, m = ctx.cell["traffic_params"], ctx.config["model"]
    ref = reference(ctx.config)
    pool = traffic.request_pool(tp, ctx.seed, m["vocab_size"])
    params = ref.make_params(m, ctx.seed, ctx.device)
    stamp("weights", ctx)
    publish_s = 0.0
    if verified_pull:
        registry, store, publish_s = publish(
            params, ctx.config["program"]["family"])
        stamp(f"published ({publish_s:.1f} s, not set-up)", ctx)
        server = serve(ctx, registry, store)
        engine = server.engine
        del registry, store
    else:
        server = None
        engine = ServingEngine(model_config(ctx.config), params,
                               serve_config(tp), device=ctx.device)
    del params
    stamp("verified pull" if verified_pull else "engine", ctx)
    loop = Loop(engine, pool, tp["sessions"])
    loop.tick()
    stamp("first tick", ctx)
    warm_until = time.perf_counter() + tp["warm_seconds"]
    while time.perf_counter() < warm_until or \
            len(loop.done) < tp["sessions"]:
        loop.tick()
    stamp("warm-up", ctx)

    t_open = time.perf_counter()
    setup_s = time.time() - ctx.t_start - publish_s
    n_setup = len(loop.ticks)
    traced_s = min(tp["trace_seconds"], ctx.seconds / 2)
    with Window(ctx.trace) as win:
        while ctx.trace and time.perf_counter() - win.t0 < traced_s:
            loop.tick()
    n_traced = len(loop.ticks)
    rest = ctx.seconds - traced_s if ctx.trace else ctx.seconds
    t_rest = time.perf_counter()
    while time.perf_counter() - t_rest < rest:
        loop.tick()
    t_close = loop.ticks[-1]["t1"]
    memory_peak = peak_bytes(ctx.device)
    spread("window: ticks",
           [t["t1"] - t["t0"] for t in loop.ticks[n_setup:]])
    metrics, completed = window_metrics(loop, t_open, t_close)
    metrics["setup_s"] = setup_s

    counted = loop.ticks[n_traced:] if ctx.trace else loop.ticks[n_setup:]
    counters = tick_counters(counted, ref, m, tp["slots"])
    counters.update(model=m, traced_prefills=[
        T for t in loop.ticks[n_setup:n_traced] for T in t["prefill"]])

    picked = sample(loop, t_open, t_close, tp["check_requests"], ctx.seed)
    del server, engine, loop
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    params = ref.make_params(m, ctx.seed, ctx.device)
    numbers = judge(ref, m, params, picked)
    if control:
        counters["control"] = judge(ref, m, params, picked, lower=True)
    counters["numbers"] = numbers
    return Outcome(metrics=metrics, attempted=completed, failed=0,
                   checks=checks_from(numbers, ctx.cell["limits"]),
                   memory_peak=memory_peak, counters=counters,
                   trace=win.read())
