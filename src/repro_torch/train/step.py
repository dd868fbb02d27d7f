"""The train step: loss -> gradients -> clip -> AdamW.

Counterpart of ``repro.train.step`` on one device (the reference's
``sh=`` shardings and its compressed all-reduce wait for the port's
multi-device pieces).  The loss is ``models.transformer.train_loss``; its
gradients come from ``torch.autograd.grad`` on detached leaf copies of the
parameters, so on the card the attention's gradient is K7's backward
kernel.  Microbatches run as a Python loop where the reference scans, and
accumulate in the reference's order: ``g_acc + g.float() / microbatches``
and ``loss_acc + l / microbatches``.  Clipping, AdamW and ``apply_updates``
run under ``no_grad``.

``TrainState.params`` is the model's parameter tree; the optimizer's state
(``AdamWState``'s ``mu`` and ``nu``) is keyed by the parameters' tree paths
(``models.transformer.param_keys``).  A step returns a new state and leaves
the one it was given as it was.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.optim import adamw, apply_updates, clip_by_global_norm
from repro_torch.optim.adamw import AdamWState, Optimizer
from repro_torch.sparse.formats import from_numpy


class TrainState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    params: Dict[str, Any]
    opt: Any           # the optimizer's state, keyed by tree path


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     opt: Optional[Optimizer] = None,
                     device="cuda") -> TrainState:
    """Random parameters from ``generator`` (``init_transformer``) on
    ``device``, and ``opt``'s initial state (default ``adamw(3e-4)``)."""
    params = transformer.init_transformer(cfg, generator, device)
    opt = opt or adamw(3e-4)
    return TrainState(torch.zeros((), dtype=torch.int32, device=device),
                      params, opt.init(transformer.flat_params(params)))


def train_state_from_numpy(cfg: ArchConfig, params: Mapping[str, np.ndarray],
                           mu: Mapping[str, np.ndarray],
                           nu: Mapping[str, np.ndarray], step: int = 0,
                           opt_step: int = 0, device="cuda") -> TrainState:
    """A ``TrainState`` carried across from host arrays keyed by tree path
    (the reference's parameters and AdamW moments), bit for bit, with the
    train step ``step`` and AdamW's step ``opt_step``."""
    keys = transformer.param_keys(cfg)
    for name, tree in (("mu", mu), ("nu", nu)):
        if set(tree) != set(keys):
            raise ValueError(f"{name}: expected the keys {sorted(keys)}, got "
                             f"{sorted(tree)}")

    def ints(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    return TrainState(
        ints(step), transformer.params_from_numpy(cfg, params, device),
        AdamWState(ints(opt_step),
                   {k: from_numpy(mu[k], device) for k in keys},
                   {k: from_numpy(nu[k], device) for k in keys}))


def make_train_step(cfg: ArchConfig, opt: Optional[Optimizer] = None,
                    microbatches: int = 1, clip_norm: float = 1.0):
    """Returns ``step(state, batch) -> (state, metrics)``; ``batch`` holds
    tensors on the parameters' device (``"tokens"``, ``"labels"`` and the
    config's stub inputs) with a batch axis that ``microbatches`` divides.
    ``metrics``: 0-d tensors ``loss``, ``grad_norm`` and ``step`` (the step
    before this one, float32)."""
    opt = opt or adamw(3e-4)

    def value_and_grad(flat, batch):
        live = {k: p.detach().requires_grad_() for k, p in flat.items()}
        loss = transformer.train_loss(cfg, transformer.tree_params(cfg, live),
                                      batch)
        keys = list(live)
        grads = torch.autograd.grad(loss, [live[k] for k in keys],
                                    allow_unused=True)
        # a parameter the loss does not reach gets zeros, as under jax.grad
        return loss.detach(), {k: torch.zeros_like(live[k]) if g is None
                               else g for k, g in zip(keys, grads)}

    def grads_of(flat, batch):
        if microbatches == 1:
            return value_and_grad(flat, batch)
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=next(iter(flat.values())).device)
        g_acc = {k: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for k, p in flat.items()}
        for i in range(microbatches):
            mb = {k: x.reshape(microbatches, x.shape[0] // microbatches,
                               *x.shape[1:])[i] for k, x in batch.items()}
            l, g = value_and_grad(flat, mb)
            with torch.no_grad():
                g_acc = {k: a + g[k].to(torch.float32) / microbatches
                         for k, a in g_acc.items()}
                loss_acc = loss_acc + l / microbatches
            del g
        return loss_acc, g_acc

    def step(state: TrainState, batch) -> tuple:
        flat = transformer.flat_params(state.params)
        loss, grads = grads_of(flat, batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, opt_state = opt.update(grads, state.opt, flat)
        del grads
        new = apply_updates(flat, updates)
        del updates
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": state.step.to(torch.float32)}
        return TrainState(state.step + 1, transformer.tree_params(cfg, new),
                          opt_state), metrics

    return step
