"""AdamW with float32 moments, and SGD, over dicts of tensors.

Counterpart of ``repro.optim.adamw`` (``adamw``, ``sgd``,
``apply_updates``, ``global_norm``, ``clip_by_global_norm``).  A parameter dict is walked in
sorted key order, the order ``jax.tree`` flattens a dict in, so sums over
the leaves add in the reference's order.  Updates are plain tensor math,
outside autograd.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Union

import torch

Params = Dict[str, torch.Tensor]
Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, mu_dtype=torch.float32) -> Optimizer:
    """AdamW with decoupled weight decay; moments in ``mu_dtype`` whatever
    the parameters' dtype."""

    def init(params: Params) -> AdamWState:
        def zeros():
            return {k: torch.zeros(p.shape, dtype=mu_dtype, device=p.device)
                    for k, p in params.items()}

        dev = next(iter(params.values())).device if params else "cpu"
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          zeros(), zeros())

    @torch.no_grad()
    def update(grads: Params, state: AdamWState, params: Params):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        stepf = step.to(torch.float32)
        b1t = 1 - torch.tensor(b1, dtype=torch.float32,
                               device=step.device) ** stepf
        b2t = 1 - torch.tensor(b2, dtype=torch.float32,
                               device=step.device) ** stepf
        updates, mu, nu = {}, {}, {}
        for key in sorted(grads):
            p = params[key]
            g32 = grads[key].to(mu_dtype)
            m = b1 * state.mu[key] + (1 - b1) * g32
            v = b2 * state.nu[key] + (1 - b2) * g32 * g32
            u = (m / b1t) / (torch.sqrt(v / b2t) + eps) \
                + weight_decay * p.to(mu_dtype)
            updates[key] = (-lr_t * u).to(p.dtype)
            mu[key], nu[key] = m, v
        return updates, AdamWState(step, mu, nu)

    return Optimizer(init=init, update=update)


class SGDState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    momentum: Params    # {} without momentum


def sgd(lr: Schedule, momentum: float = 0.0) -> Optimizer:
    """SGD, with a float32 momentum buffer when ``momentum`` is not 0."""

    def init(params: Params) -> SGDState:
        dev = next(iter(params.values())).device if params else "cpu"
        step = torch.zeros((), dtype=torch.int32, device=dev)
        if momentum == 0.0:
            return SGDState(step, {})
        return SGDState(step, {k: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device)
                               for k, p in params.items()})

    @torch.no_grad()
    def update(grads: Params, state: SGDState, params: Params):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        if momentum == 0.0:
            return ({k: (-lr_t * g).to(params[k].dtype)
                     for k, g in grads.items()}, SGDState(step, {}))
        m = {k: momentum * state.momentum[k] + g.to(torch.float32)
             for k, g in grads.items()}
        return ({k: (-lr_t * mm).to(params[k].dtype) for k, mm in m.items()},
                SGDState(step, m))

    return Optimizer(init=init, update=update)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    return {k: p + updates[k] for k, p in params.items()}


@torch.no_grad()
def global_norm(tree: Params) -> torch.Tensor:
    total = 0
    for key in sorted(tree):
        total = total + torch.sum(torch.square(tree[key].to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def clip_by_global_norm(grads: Params, max_norm: float):
    """(grads scaled so their global norm is at most ``max_norm``, the
    global norm before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype)
            for k, g in grads.items()}, norm
