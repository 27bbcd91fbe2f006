"""Architecture config schema (the fields of `repro.configs.base`)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm | cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # attention pattern
    sliding_window: Optional[int] = None
    global_every: int = 0
    rope_theta: float = 10000.0
    rope_theta_global: float = 0.0
    qkv_bias: bool = False
    attn_soft_cap: Optional[float] = None

    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    conv_width: int = 4

    # hybrid (recurrentgemma)
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0

    # enc-dec (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500

    # vlm
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # misc
    scan_unroll: int = 1
    remat: bool = False
    moe_block_dispatch: int = 0
    window_kv_cache: bool = False
    logit_sharding: tuple = ()
    act: str = "silu"
    norm: str = "rms"
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)
