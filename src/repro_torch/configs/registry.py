"""Config registry + reduced smoke configs (counterpart of
``repro.configs.registry``, the same table).

``smoke_config`` shrinks every dimension while preserving the family traits
(MoE stays MoE, MLA stays MLA, hybrid keeps its pattern) so CPU smoke tests
exercise the same code paths the full dry-run compiles.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

_MODULES = {
    "deepseek-67b": "deepseek_67b",
    "internlm2-20b": "internlm2_20b",
    "granite-3-2b": "granite_3_2b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "internvl2-76b": "internvl2_76b",
    "zamba2-1.2b": "zamba2_1_2b",
    "whisper-large-v3": "whisper_large_v3",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config: tiny dims, few layers, tiny vocab."""
    full = get_config(name)
    kw = dict(
        n_layers=min(full.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(full.n_kv_heads, 2) if full.n_kv_heads < full.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        encoder_layers=2 if full.encoder_layers else 0,
        encoder_seq=16 if full.encoder_layers else full.encoder_seq,
        vision_patches=8 if full.frontend == "vision_stub" else full.vision_patches,
        ssm_state=16, ssm_head_dim=16, ssm_conv=4,
        shared_attn_every=2,
        sliding_window=16 if full.sliding_window else 0,
        loss_chunks=2,
        dtype="float32",  # CPU smoke tests check numerics in fp32
        remat="none",
    )
    if full.moe:
        kw["moe"] = MoEConfig(
            n_experts=4,
            top_k=min(full.moe.top_k, 2),
            d_ff_expert=64,
            n_shared=min(full.moe.n_shared, 1),
        )
    if full.mla:
        kw["mla"] = MLAConfig(kv_lora=32, qk_nope_dim=16, qk_rope_dim=8,
                              v_head_dim=16)
    if full.ffn_mode != "dense":
        kw["topk_k"] = 32
    return dataclasses.replace(full, **kw)
