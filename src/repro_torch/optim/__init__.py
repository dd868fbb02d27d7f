"""Optimizers over dicts of tensors (Optax-style API).

``opt.init(params) -> state``; ``opt.update(grads, state, params) ->
(updates, state)``; apply with ``apply_updates``.  Counterpart of the part
of ``repro.optim`` that the GNN trainer uses.
"""
from repro_torch.optim.adamw import (
    AdamWState, Optimizer, adamw, apply_updates, clip_by_global_norm,
    global_norm,
)

__all__ = ["AdamWState", "Optimizer", "adamw", "apply_updates",
           "global_norm", "clip_by_global_norm"]
