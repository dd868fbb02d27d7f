"""Deterministic synthetic token pipeline.

A copy of ``repro.data.pipeline`` (numpy only, so the batches are the
reference's bit for bit for the same ``(seed, step)``).  The batch at step
``t`` is a pure function of ``(seed, t)``: after a restart from a
checkpoint the stream resumes bit-identically, so recovery reproduces the
exact gradient sequence.  ``local_slice`` keeps one host's rows of the
global batch.

The "dataset" is a mixture of Zipfian unigrams with Markov bigram
structure, enough signal for a loss to fall in a few hundred steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    local_slice: slice = slice(None)  # this host's rows of the global batch
    prefetch: int = 2

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 0xA1A]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The full deterministic global batch for ``step`` (then sliced):
        int32 ``tokens`` and ``labels`` of ``(B, S)``."""
        rng = self._rng(step)
        b, s, v = self.global_batch, self.seq_len, self.vocab
        # Zipfian unigram base
        ranks = np.arange(1, v + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(v, size=(b, s + 1), p=probs)
        # learnable bigram structure: after token t comes (t*7+3)%v with
        # probability 1/2
        follow = (toks[:, :-1] * 7 + 3) % v
        coin = rng.random((b, s)) < 0.5
        toks[:, 1:] = np.where(coin, follow, toks[:, 1:])
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        return {"tokens": tokens[self.local_slice],
                "labels": labels[self.local_slice]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def synthetic_batch(cfg, shape_spec, rng: Optional[np.random.Generator] = None,
                    batch_override: Optional[int] = None) -> Dict:
    """One numpy batch matching an (arch, shape) cell (``shape_spec`` with
    ``global_batch`` and ``seq_len``), with the stub inputs the config
    has: ``vision_embeds`` and ``frames`` in float32."""
    rng = rng or np.random.default_rng(0)
    b = batch_override or shape_spec.global_batch
    s = shape_spec.seq_len
    out = {
        "tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
    }
    if cfg.frontend == "vision_stub":
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out
