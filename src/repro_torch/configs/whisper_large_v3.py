"""whisper-large-v3 [audio] — enc-dec; conv frontend is a STUB
[arXiv:2212.04356]: ``input_specs`` provides precomputed frame embeddings
(B, encoder_seq, d_model)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, head_dim=64,
    attention="gqa", rope_theta=10000.0,
    encoder_layers=32, encoder_seq=1500, frontend="audio_stub",
)
