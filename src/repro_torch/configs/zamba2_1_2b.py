"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242].  38 Mamba2 layers; one *weight-shared* attention+FFN
block applied every ``shared_attn_every`` layers (the Zamba trick).
Sub-quadratic: runs the long_500k shape (DESIGN.md §5)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, head_dim=64,
    attention="gqa", block_pattern="M", shared_attn_every=6,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    sliding_window=4096,  # shared-attn block uses windowed attention at 500k
)
