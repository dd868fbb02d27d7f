"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay
[arXiv:2404.05892].  Sub-quadratic: runs the long_500k shape."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536, head_dim=64,
    attention="none", block_pattern="R",
)
