"""whisper-medium [audio] — enc-dec, conv frontend stubbed to
precomputed frame embeddings. [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865, head_dim=64,
    enc_layers=24, enc_seq=1500, norm="layer", act="gelu",
)

SMOKE = ArchConfig(
    name="whisper-smoke", family="encdec", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
    enc_layers=2, enc_seq=32, norm="layer", act="gelu",
)
