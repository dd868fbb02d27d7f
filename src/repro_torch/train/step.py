"""The train step: loss -> gradients -> clip -> AdamW.

Counterpart of ``repro.train.step``.  The loss is
``models.transformer.train_loss``; its
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

Under a mesh (``sh=launch.sharding.make_shardings(mesh)``) the state's
tensors are DTensors: parameters placed by ``param_specs``, moments by
``optim.zero.zero1_state_specs`` or as the parameters, the batch split
over the batch dims (``shard_train_state``, ``launch.sharding.distribute``).
The gradients are reduced to the parameters' placements (the data-parallel
all-reduce), AdamW runs on each rank's moment shard, and the updates are
gathered back to the parameters' placements (ZeRO-1); the metrics are
plain replicated tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.sharding import (NamedSharding, Shardings, UNSHARDED,
                                         distribute, replicating)
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


def shard_train_state(cfg: ArchConfig, state: TrainState, mesh,
                      param_specs, moment_specs=None) -> TrainState:
    """``state`` (the same full values on every rank) placed on ``mesh``:
    each parameter by ``param_specs`` (a tree like ``state.params``), each
    moment by ``moment_specs`` (a tree of the same structure, e.g.
    ``optim.zero.zero1_state_specs``; default: the parameter's), the steps
    replicated (``launch.sharding.distribute``: where every split dim of
    the mesh has size 1 the placed leaf shares the full one's memory)."""
    from repro_torch.launch.sharding import P

    flat_p = transformer.flat_params(param_specs)
    flat_m = transformer.flat_params(moment_specs) if moment_specs \
        is not None else flat_p

    def place(x, spec):
        return distribute(x, NamedSharding(mesh, spec))

    params = {k: place(x, flat_p[k]) for k, x in
              transformer.flat_params(state.params).items()}
    opt = state.opt
    return TrainState(
        place(state.step, P()), transformer.tree_params(cfg, params),
        AdamWState(place(opt.step, P()),
                   {k: place(x, flat_m[k]) for k, x in opt.mu.items()},
                   {k: place(x, flat_m[k]) for k, x in opt.nu.items()}))


def make_train_step(cfg: ArchConfig, opt: Optional[Optimizer] = None,
                    microbatches: int = 1, clip_norm: float = 1.0, *,
                    sh: Shardings = UNSHARDED):
    """Returns ``step(state, batch) -> (state, metrics)``; ``batch`` holds
    tensors on the parameters' device (``"tokens"``, ``"labels"`` and the
    config's stub inputs) with a batch axis that ``microbatches`` divides
    (under a mesh: each rank's batch shard).  ``metrics``: 0-d tensors
    ``loss``, ``grad_norm`` and ``step`` (the step before this one,
    float32).  ``sh`` is keyword-only here (the reference's third
    positional argument), so the port's earlier positional
    ``microbatches`` keeps its place."""
    opt = opt or adamw(3e-4)

    def value_and_grad(flat, batch):
        live = {k: p.detach().requires_grad_() for k, p in flat.items()}
        loss = transformer.train_loss(cfg, transformer.tree_params(cfg, live),
                                      batch, sh)
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        keys = list(live)
        grads = torch.autograd.grad(loss, [live[k] for k in keys],
                                    allow_unused=True)
        # a parameter the loss does not reach gets zeros, as under jax.grad
        grads = {k: torch.zeros_like(live[k]) if g is None else g
                 for k, g in zip(keys, grads)}
        return loss.detach(), {k: _like(g, flat[k]) for k, g in
                               grads.items()}

    def grads_of(flat, batch):
        if microbatches == 1:
            return value_and_grad(flat, batch)
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=next(iter(flat.values())).device)
        g_acc = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in flat.items()}
        for i in range(microbatches):
            mb = {k: _microbatch(x, microbatches, i)
                  for k, x in batch.items()}
            l, g = value_and_grad(flat, mb)
            with torch.no_grad():
                g_acc = {k: a + g[k].to(torch.float32) / microbatches
                         for k, a in g_acc.items()}
                loss_acc = loss_acc + l / microbatches
            del g
        return loss_acc, g_acc

    def step(state: TrainState, batch) -> tuple:
        with replicating(sh):
            flat = transformer.flat_params(state.params)
            loss, grads = grads_of(flat, batch)
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            updates, opt_state = opt.update(grads, state.opt, flat)
            del grads
            if sh.mesh is not None:  # ZeRO-1: gather each update back
                updates = {k: _like(u, flat[k]) for k, u in updates.items()}
                opt_state = _keep_placements(opt_state, state.opt)
            new = apply_updates(flat, updates)
            del updates
            metrics = {"loss": loss, "grad_norm": _full(gnorm),
                       "step": _full(state.step).to(torch.float32)}
            return TrainState(state.step + 1,
                              transformer.tree_params(cfg, new),
                              opt_state), metrics

    return step


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _like(x, ref):
    """``x`` redistributed to ``ref``'s placements (a no-op for plain
    tensors): a gradient's partial sums over the batch dims are
    all-reduced, a moment-shaped update is all-gathered."""
    if isinstance(ref, DTensor) and tuple(x.placements) != \
            tuple(ref.placements):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def _keep_placements(new, old):
    """The optimizer state ``new`` with each tensor placed as in ``old``."""
    return type(new)(*(
        {k: _like(v, o[k]) for k, v in n.items()} if isinstance(n, dict)
        else _like(n, o) for n, o in zip(new, old)))


def _microbatch(x, n: int, i: int):
    """Microbatch ``i`` of ``n`` along the batch axis; under a mesh, of each
    rank's batch shard (the global microbatch is the union of the ranks'
    slices)."""
    if isinstance(x, DTensor):
        local = x.to_local()
        return DTensor.from_local(
            local.reshape(n, local.shape[0] // n, *local.shape[1:])[i],
            x.device_mesh, x.placements, run_check=False)
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
