"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (vision frontend
stubbed to precomputed patch embeddings). [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_ff=8960, vocab=151936, head_dim=128,
    qkv_bias=True, mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="qwen2-vl-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
    qkv_bias=True, mrope_sections=(2, 3, 3), rope_theta=1_000_000.0,
)
