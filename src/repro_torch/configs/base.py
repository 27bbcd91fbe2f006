"""Architecture config schema (the fields of `repro.configs.base`), its
parameter counts, and the dry run's shape cells (`SHAPES`)."""
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

    def param_count(self) -> int:
        """Approximate total parameter count N (for 6ND roofline math)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            din = self.ssm_expand * d
            nh = din // self.ssm_headdim
            per = d * (2 * din + 2 * self.ssm_ngroups * self.ssm_state
                       + nh) + din * d + din  # in_proj(z,x,B,C,dt)+out
            return emb + L * per
        hd = self.hd
        if self.kv_lora_rank:  # MLA
            qk = self.qk_nope_dim + self.qk_rope_dim
            attn = d * (self.kv_lora_rank + self.qk_rope_dim)
            attn += self.kv_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.v_head_dim)
            if self.q_lora_rank:
                attn += d * self.q_lora_rank \
                    + self.q_lora_rank * self.n_heads * qk
            else:
                attn += d * self.n_heads * qk
            attn += self.n_heads * self.v_head_dim * d
        else:
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d
        dense_ffn = 3 * d * self.d_ff
        if self.n_experts:
            moe_ffn = 3 * d * self.moe_d_ff * (
                self.n_experts + self.n_shared_experts)
            n_moe = L - self.first_dense_layers
            ffn_total = (self.first_dense_layers * dense_ffn
                         + n_moe * moe_ffn)
        else:
            ffn_total = L * dense_ffn
        n_attn_layers = L
        if self.block_pattern:
            # hybrid: recurrent blocks replace attention
            n_rec = round(L * self.block_pattern.count("rec")
                          / len(self.block_pattern))
            n_attn_layers = L - n_rec
            lru = self.lru_width or d
            rec = d * lru * 3 + lru * d + 2 * lru  # gates+in/out proj
            ffn_total += 0  # ffn in every block already counted
            return emb + n_attn_layers * attn + n_rec * rec + ffn_total
        if self.family == "encdec":
            # enc self-attn + dec self-attn + dec cross-attn
            return emb + (self.enc_layers + L) * (attn + dense_ffn) \
                + L * attn
        return emb + n_attn_layers * attn + ffn_total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        total = self.param_count()
        all_moe = 3 * d * self.moe_d_ff * self.n_experts \
            * (L - self.first_dense_layers)
        act_moe = 3 * d * self.moe_d_ff * self.top_k \
            * (L - self.first_dense_layers)
        return total - all_moe + act_moe


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# the archs whose memory path is sub-quadratic, the only ones the dry run
# gives the long_500k decode cell
LONG_CONTEXT_OK = {"mamba2-370m", "recurrentgemma-9b", "gemma3-4b"}
