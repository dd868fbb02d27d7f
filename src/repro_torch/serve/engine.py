"""Batched serving engine over ``decode_step``.

Counterpart of ``repro.serve.engine``, with the same semantics: a
fixed-slot batch; the prompts are fed through the decode path one token at
a time (ragged fronts padded with token 0, their logits discarded); then
greedy decoding until every request has its ``max_new_tokens``.  The steps
run eagerly under ``torch.no_grad()`` on the parameters' device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.sharding import Shardings, UNSHARDED
from repro_torch.models.transformer import decode_step, init_decode_cache


@dataclasses.dataclass
class Request:
    """One queued generation request (prompt in, greedy tokens out)."""

    prompt: np.ndarray          # (prompt_len,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Fixed-slot LM decode engine over ``decode_step``."""

    def __init__(self, cfg: ArchConfig, params: Dict, batch_slots: int,
                 max_seq: int, sh: Shardings = UNSHARDED):
        self.cfg = cfg
        self.params = params
        self.sh = sh
        self.slots = batch_slots
        self.max_seq = max_seq
        self.device = params["embed"].device
        self.cache = init_decode_cache(cfg, batch_slots, max_seq,
                                       device=self.device)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self.steps = 0  # decode_step calls so far

    def submit(self, req: Request):
        """Queue a request; it claims a batch slot as one frees up."""
        self.queue.append(req)

    def _fill_slots(self):
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                self.active[i] = self.queue.pop(0)

    @torch.no_grad()
    def _step(self, toks: np.ndarray) -> np.ndarray:
        """One decode step over all slots; the greedy next token of each."""
        logits, self.cache = decode_step(
            self.cfg, self.params, self.cache,
            torch.as_tensor(toks, device=self.device), self.sh)
        self.steps += 1
        return logits[:, 0].argmax(-1).cpu().numpy()

    def run(self, max_steps: int = 256):
        """Drive all requests to completion (greedy decoding)."""
        self._fill_slots()
        maxp = max((len(r.prompt) for r in self.active if r), default=0)
        nxt = np.zeros(self.slots, np.int64)
        for t in range(maxp):
            toks = np.zeros((self.slots, 1), np.int32)
            for i, r in enumerate(self.active):
                if r is not None and t < len(r.prompt):
                    toks[i, 0] = r.prompt[t]
            nxt = self._step(toks)
        for _ in range(max_steps):
            live = [i for i, r in enumerate(self.active) if r and not r.done]
            if not live:
                break
            toks = np.zeros((self.slots, 1), np.int32)
            for i in live:
                tok = int(nxt[i])
                self.active[i].out_tokens.append(tok)
                if len(self.active[i].out_tokens) >= self.active[i].max_new_tokens:
                    self.active[i].done = True
                toks[i, 0] = tok
            nxt = self._step(toks)
        return [r for r in self.active if r is not None]


@torch.no_grad()
def greedy_generate(cfg: ArchConfig, params: Dict, prompt: np.ndarray,
                    n_new: int, max_seq: int = 128) -> np.ndarray:
    """Single-sequence greedy generation (example/test helper)."""
    device = params["embed"].device
    cache = init_decode_cache(cfg, 1, max_seq, device=device)
    logits = None
    for t in prompt:
        logits, cache = decode_step(
            cfg, params, cache,
            torch.tensor([[int(t)]], dtype=torch.int32, device=device))
    out = []
    for _ in range(n_new):
        nxt = int(logits[0, 0].argmax())
        out.append(nxt)
        logits, cache = decode_step(
            cfg, params, cache,
            torch.tensor([[nxt]], dtype=torch.int32, device=device))
    return np.asarray(out, np.int32)
