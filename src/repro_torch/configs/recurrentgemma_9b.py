"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 recurrent :
1 attention, MQA. [arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab=256000, head_dim=256,
    block_pattern=("rec", "rec", "attn"), lru_width=4096,
    sliding_window=2048, conv_width=4, act="gelu_tanh",
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="recurrentgemma-smoke", family="hybrid", n_layers=5, d_model=64,
    n_heads=4, n_kv_heads=1, d_ff=128, vocab=256, head_dim=16,
    block_pattern=("rec", "rec", "attn"), lru_width=64,
    sliding_window=8, conv_width=4, act="gelu_tanh", tie_embeddings=True,
)
