"""llama4-scout-17b-a16e [moe] — 16 experts, top-1 routing
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    attention="gqa", rope_theta=500000.0,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, n_shared=0),
)
