"""LM models, counterpart of ``repro.models``: the dense attention+FFN
stack (``transformer``), GQA attention with the fused flash kernel on its
full-sequence path (``attention``), the dense and TopK FFNs (``ffn``) and
the shared substrate (``common``)."""
from repro_torch.models.transformer import (
    decode_step, forward_hidden, init_decode_cache, init_transformer,
    params_from_numpy, train_loss,
)

__all__ = [
    "decode_step", "forward_hidden", "init_decode_cache", "init_transformer",
    "params_from_numpy", "train_loss",
]
