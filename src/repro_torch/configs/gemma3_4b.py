"""gemma3-4b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt family; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense", n_layers=34, d_model=2560,
    n_heads=8, n_kv_heads=4, d_ff=10240, vocab=262144, head_dim=256,
    sliding_window=1024, global_every=5, rope_theta=10000.0,
    rope_theta_global=1_000_000.0, act="gelu_tanh",
)

SMOKE = ArchConfig(
    name="gemma3-smoke", family="dense", n_layers=6, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
    sliding_window=8, global_every=5, rope_theta=10000.0,
    rope_theta_global=1_000_000.0, act="gelu_tanh",
)
