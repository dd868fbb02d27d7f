"""deepseek-67b [dense] — llama-arch GQA [arXiv:2401.02954]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400, head_dim=128,
    attention="gqa", rope_theta=10000.0,
)
