"""Serving launcher: LM decode engine or the multi-tenant SpGEMM service.

LM mode (batched greedy decoding with the ServeEngine)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
        [--smoke] [--device cuda] --requests 4 --new-tokens 8

SpGEMM mode (the pattern-coalescing micro-batcher over synthetic traffic)::

    PYTHONPATH=src python -m repro_torch.launch.serve --spgemm \
        [--device cuda] --requests 64 --tenants 4 --patterns 6 --max-batch 8

Counterpart of ``repro.launch.serve``.  LM mode: random parameters from
seed 0 (a ``torch.Generator`` on ``--device``), prompts of 4-6 random tokens
from numpy seed 0.  SpGEMM mode: the reference's patterns and values, drawn
from ``--seed`` in the same order, on ``--device``.
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


def run_spgemm(args) -> dict:
    """Drive the SpGEMMService over Zipf-popular synthetic patterns on
    ``args.device``; prints and returns its ``stats()``."""
    from repro_torch.serve import SpGEMMService
    from repro_torch.sparse.formats import csr_from_dense

    rng = np.random.default_rng(args.seed)
    n = args.n
    masks = [rng.random((n, n)) < args.density for _ in range(args.patterns)]
    b_side = [csr_from_dense((m * rng.standard_normal((n, n)))
                             .astype(np.float32), device=args.device)
              for m in masks]

    def fresh(pid):
        vals = rng.standard_normal((n, n)).astype(np.float32)
        return csr_from_dense((masks[pid] * vals).astype(np.float32),
                              device=args.device)

    svc = SpGEMMService(max_batch=args.max_batch, max_wait=args.max_wait,
                        max_queue=args.max_queue)
    # Zipf-distributed pattern popularity: a few hot patterns dominate,
    # which is what makes coalescing pay.
    ranks = np.arange(1, args.patterns + 1, dtype=np.float64)
    popularity = ranks ** -args.zipf
    popularity /= popularity.sum()
    for i in range(args.requests):
        pid = int(rng.choice(args.patterns, p=popularity))
        tenant = f"tenant{i % args.tenants}"
        svc.submit(tenant, fresh(pid), b_side[pid])
    svc.flush()
    s = svc.stats()
    print(f"[spgemm-serve] {s['requests_completed']} requests in "
          f"{s['dispatches']} dispatches "
          f"(coalescing ratio {s['coalescing_ratio']:.2f}, "
          f"{s['batched_dispatches']} batched / "
          f"{s['singleton_dispatches']} singleton)")
    print(f"[spgemm-serve] latency p50={s['latency_p50_ms']:.2f}ms "
          f"p99={s['latency_p99_ms']:.2f}ms shed={s['requests_shed']}")
    for tid, ten in s["tenants"].items():
        print(f"[spgemm-serve]   {tid}: {ten['completed']} done, "
              f"plan hit rate {ten['plan_hit_rate']:.2f} "
              f"({ten['plan_entries']} plans cached)")
    return s


def main(argv=None):
    """Parse args and dispatch to the LM or SpGEMM serving mode."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--spgemm", action="store_true",
                    help="serve SpGEMM requests instead of LM decoding")
    ap.add_argument("--arch", help="LM mode: architecture name")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    # SpGEMM-service knobs
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--patterns", type=int, default=6)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--zipf", type=float, default=1.2)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait", type=float, default=0.01)
    ap.add_argument("--max-queue", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.spgemm:
        return run_spgemm(args)
    if not args.arch:
        ap.error("--arch is required unless --spgemm is given")
    return run_lm(args)


if __name__ == "__main__":
    main()
