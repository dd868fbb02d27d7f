"""Optimizers over dicts of tensors (Optax-style API).

``opt.init(params) -> state``; ``opt.update(grads, state, params) ->
(updates, state)``; apply with ``apply_updates``.  Counterpart of
``repro.optim``, less ``compressed_psum`` and ``zero1_state_specs``, which
wait for the port's multi-device pieces.
"""
from repro_torch.optim.adamw import (
    AdamWState, Optimizer, SGDState, adamw, apply_updates,
    clip_by_global_norm, global_norm, sgd,
)
from repro_torch.optim.compression import int8_compress, int8_decompress
from repro_torch.optim.schedules import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamWState", "Optimizer", "SGDState", "adamw", "sgd",
           "apply_updates", "global_norm", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup_cosine",
           "int8_compress", "int8_decompress"]
