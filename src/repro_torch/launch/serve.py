"""Serving launcher, LM mode: batched greedy decoding with the ServeEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
        [--smoke] [--device cuda] --requests 4 --new-tokens 8

Counterpart of ``repro.launch.serve``'s ``run_lm``: random parameters from
seed 0 (a ``torch.Generator`` on ``--device``), prompts of 4-6 random tokens
from numpy seed 0.  ``--spgemm`` (the multi-tenant SpGEMM service) is not
ported yet.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def run_lm(args) -> list:
    """Drive the fixed-slot LM ServeEngine over random prompts."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.transformer import init_transformer
    from repro_torch.serve import Request, ServeEngine

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = init_transformer(cfg, gen, device=args.device)
    eng = ServeEngine(cfg, params, batch_slots=args.slots,
                      max_seq=args.max_seq)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(prompt=rng.integers(0, cfg.vocab, 4 + i % 3),
                           max_new_tokens=args.new_tokens))
    done = eng.run()
    for i, r in enumerate(done):
        print(f"[serve] req{i}: prompt={[int(t) for t in r.prompt]} -> "
              f"{r.out_tokens}")
    return done


def main(argv=None):
    """Parse args and run the LM serving mode."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--spgemm", action="store_true",
                    help="serve SpGEMM requests (not ported yet)")
    ap.add_argument("--arch", help="architecture name")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    args = ap.parse_args(argv)
    if args.spgemm:
        raise NotImplementedError("the SpGEMM serving mode needs "
                                  "serve.SpGEMMService, not ported yet "
                                  "(ROADMAP Queue A item 9)")
    if not args.arch:
        ap.error("--arch is required")
    return run_lm(args)


if __name__ == "__main__":
    main()
