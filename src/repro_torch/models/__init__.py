"""LM models, counterpart of ``repro.models``: the stack of every config
(``transformer``), GQA and MLA attention with the fused flash kernel on
their full-sequence path (``attention``), the dense, TopK and MoE FFNs
(``ffn``), the Mamba2 and RWKV6 blocks (``mamba2``, ``rwkv6``) and the
shared substrate (``common``)."""
from repro_torch.models.transformer import (
    Transformer, decode_step, forward_hidden, init_decode_cache,
    init_transformer, param_specs, params_from_numpy, train_loss,
)

__all__ = [
    "Transformer", "decode_step", "forward_hidden", "init_decode_cache",
    "init_transformer", "param_specs", "params_from_numpy", "train_loss",
]
