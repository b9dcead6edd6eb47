"""Serving launcher: batched decode with the continuum-aware engine.

  python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \
      --requests 16 --max-new 12

Runs on ``cuda`` unless ``--device cpu`` is given; without a CUDA device
the default raises.  The weights come from `initial_params` (seed 0 on
the device), the launchers' common hook.  Encoder-only models (hubert)
have no decode step and exit, as in the reference; a VLM's engine takes
text prompts only, as the reference's does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, reduced as make_reduced
from repro_torch.launch.train import initial_params
from repro_torch.serving import Request, ServeConfig, ServingEngine


def main(argv=None):
    """Serves `--requests` random prompts; returns the finished requests
    in the order they finished."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only — no decode serving")

    dev = resolve_device(args.device)
    params = initial_params(cfg, dev)
    engine = ServingEngine(cfg, params,
                           ServeConfig(max_seq_len=args.max_seq,
                                       batch_size=args.batch,
                                       temperature=args.temperature),
                           device=dev)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(3, min(cfg.vocab_size, 100),
                              rng.integers(4, 12)).tolist()
        engine.submit(Request(uid=i, prompt=prompt,
                              max_new_tokens=args.max_new))

    t0 = time.time()
    done = engine.run()
    dt = time.time() - t0
    total_new = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests, {total_new} tokens "
          f"in {dt:.2f}s ({total_new / max(dt, 1e-9):.1f} tok/s)")
    for r in done[:4]:
        print(f"  req {r.uid}: prompt[:6]={r.prompt[:6]} -> {r.generated}")
    return done


if __name__ == "__main__":
    main()
