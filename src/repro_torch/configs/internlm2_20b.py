"""internlm2-20b [dense] — GQA [arXiv:2403.17297]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92544, head_dim=128,
    attention="gqa", rope_theta=1000000.0,
)
