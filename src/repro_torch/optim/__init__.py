"""Optimizers over dicts of tensors (Optax-style API).

``opt.init(params) -> state``; ``opt.update(grads, state, params) ->
(updates, state)``; apply with ``apply_updates``.  Counterpart of
``repro.optim``; ``compressed_psum`` is the int8 all-reduce over a mesh
dim, ``zero1_state_specs`` the moments' ZeRO-1 specs.
"""
from repro_torch.optim.adamw import (
    AdamWState, Optimizer, SGDState, adamw, apply_updates,
    clip_by_global_norm, global_norm, sgd,
)
from repro_torch.optim.compression import (compressed_psum, int8_compress,
                                           int8_decompress)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup_cosine
from repro_torch.optim.zero import zero1_state_specs

__all__ = ["AdamWState", "Optimizer", "SGDState", "adamw", "sgd",
           "apply_updates", "global_norm", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup_cosine",
           "int8_compress", "int8_decompress", "compressed_psum",
           "zero1_state_specs"]
