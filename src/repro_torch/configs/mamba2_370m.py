"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm", n_layers=48, d_model=1024,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
    conv_width=4, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="mamba2-smoke", family="ssm", n_layers=2, d_model=64,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=256,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_ngroups=1,
    conv_width=4, tie_embeddings=True,
)
