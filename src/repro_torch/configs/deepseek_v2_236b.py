"""deepseek-v2-236b [moe] — MLA kv_lora=512 q_lora=1536, 2 shared +
160 routed experts top-6. [arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, d_ff=12288, vocab=102400,
    kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
    first_dense_layers=1,
)

SMOKE = ArchConfig(
    name="dsv2-236b-smoke", family="moe", n_layers=3, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    kv_lora_rank=32, q_lora_rank=48, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16,
    n_experts=8, n_shared_experts=1, top_k=2, moe_d_ff=32,
    first_dense_layers=1,
)
