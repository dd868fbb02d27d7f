"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + 64 routed experts
top-6 + 2 shared [arXiv:2405.04434].

Note (DESIGN.md §5): the pool row lists both "64e top-6" and "2 shared+160
routed"; 160 contradicts the Lite config in arXiv:2405.04434 (§Lite: 64
routed, 2 shared, top-6, expert d_ff 1408, first layer dense d_ff 10944),
so we follow the paper's 64.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944,  # first (dense) layer FFN width
    vocab=102400,
    attention="mla",
    mla=MLAConfig(kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    first_layer_dense_ffn=True,
    rope_theta=10000.0,
)
