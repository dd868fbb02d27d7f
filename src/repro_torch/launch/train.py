"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --steps 100 --batch 8 --seq 256 [--ffn-mode topk] [--smoke] \
        [--device cuda|cpu]

Counterpart of ``repro.launch.train`` on one device: the data pipeline,
the train step, the trainer, checkpoints and restore.  ``--device``
(default ``cuda``) is where the parameters live and the step runs;
``--smoke`` swaps in the reduced config (``configs.smoke_config``), small
enough for the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.train import (Trainer, TrainerConfig, init_train_state,
                               make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ffn-mode", default=None,
                    choices=[None, "dense", "topk", "block_topk"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-feasible)")
    ap.add_argument("--device", default="cuda",
                    help="where the parameters live and the step runs")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.ffn_mode:
        k = cfg.topk_k or max(cfg.d_ff // 8, 1)
        cfg = dataclasses.replace(cfg, ffn_mode=args.ffn_mode, topk_k=k)

    device = torch.device(args.device)
    print(f"[train] {cfg.name}: ~{cfg.n_params()/1e9:.2f}B params "
          f"(active {cfg.n_active_params()/1e9:.2f}B), ffn={cfg.ffn_mode}, "
          f"device={device}")
    opt = adamw(linear_warmup_cosine(args.lr, 20, args.steps))
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_train_state(cfg, gen, opt, device)
    step = make_train_step(cfg, opt, args.microbatches)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=0)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix=f"ckpt_{cfg.name}_")
    tcfg = TrainerConfig(total_steps=args.steps,
                         checkpoint_every=args.ckpt_every,
                         checkpoint_dir=ckpt_dir)
    trainer = Trainer(tcfg, step, state, pipe)
    trainer.run()
    losses = [m["loss"] for m in trainer.history]
    print(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"ckpts in {ckpt_dir}")
    return trainer


if __name__ == "__main__":
    main()
