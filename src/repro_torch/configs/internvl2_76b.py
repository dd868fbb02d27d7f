"""internvl2-76b [vlm] — InternViT stub + InternLM2-like backbone
[arXiv:2404.16821].  The vision frontend is a STUB per the brief:
``input_specs`` provides precomputed patch embeddings that replace the
first ``vision_patches`` token positions."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    attention="gqa", rope_theta=1000000.0,
    frontend="vision_stub", vision_patches=256,
)
