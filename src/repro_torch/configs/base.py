"""Config dataclasses: copies of the reference's ``configs/base.py``
(``TahomaCNNConfig``, the LM architecture configs with their derived
properties, and the input-shape cell ``ShapeConfig``). Pure Python; a
test pins every field and default to the reference's."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0          # per shared expert
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block hyperparameters."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1
    a_init_range: Tuple[float, float] = (1.0, 16.0)


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper)."""
    n_layers: int = 4
    n_frames: int = 1500


@dataclass(frozen=True)
class VisionConfig:
    """VLM frontend: patch embeddings merged into the token stream, M-RoPE
    position ids as (3, B, S)."""
    n_patches: int = 256
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # over head_dim/2


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "silu"              # silu (gated) | gelu (non-gated)
    norm_eps: float = 1e-5
    max_seq_len: int = 524288
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one SHARED attention+MLP block applied every k SSM
    # blocks (weight re-use across depth).
    hybrid_attn_every: int = 0
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    # sub-quadratic sequence mixing available?
    subquadratic: bool = False
    dtype: str = "bfloat16"
    source: str = ""               # provenance tag [arXiv/hf; tier]
    # q/ssm heads are zero-masked-padded up to a multiple of this (an output
    # head mask keeps the numerics of the unpadded model).
    head_pad_to: int = 1

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---- derived ----
    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.d_inner // self.ssm.head_dim

    @property
    def conv_dim(self) -> int:
        assert self.ssm is not None
        return self.d_inner + 2 * self.ssm.n_groups * self.ssm.d_state

    def padded_vocab(self, multiple: int = 256) -> int:
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    @staticmethod
    def _pad_to(n: int, m: int) -> int:
        return ((n + m - 1) // m) * m

    @property
    def n_heads_padded(self) -> int:
        return self._pad_to(self.n_heads, self.head_pad_to)

    @property
    def ssm_heads_padded(self) -> int:
        return self._pad_to(self.ssm_heads, self.head_pad_to)

    @property
    def d_inner_padded(self) -> int:
        assert self.ssm is not None
        return self.ssm_heads_padded * self.ssm.head_dim

    @property
    def conv_dim_padded(self) -> int:
        assert self.ssm is not None
        return self.d_inner_padded + 2 * self.ssm.n_groups * self.ssm.d_state


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell. kind determines which step fn is built:
    train -> train_step, prefill -> prefill_step, decode -> decode_step."""
    name: str
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int
    # training controls
    microbatch_seqs_per_shard: int = 1   # grad-accum granularity
    remat_policy: str = "full"           # full | dots | none
    train_attn_chunk: int = 0            # >0: chunked (flash) train attention
    grad_accum_dtype: str = "float32"    # fp32 | bfloat16 accumulation
    # serving controls
    kv_dtype: str = "bfloat16"           # physical representation of cache
    attn_chunk: int = 1024               # jnp-flash chunk for long prefill
    params_tp_only: bool = False         # serve: drop ZeRO/FSDP weight axes
    prefill_last_only: bool = False      # prefill: head on last token only


@dataclass(frozen=True)
class TahomaCNNConfig:
    """Paper Fig. 3 family: [conv->relu->maxpool] x L -> dense relu -> sigmoid.

    A (architecture space): n_conv_layers x conv_nodes x dense_nodes.
    F (representation space) lives in core/transforms.py, not here.
    """
    n_conv_layers: int = 2
    conv_nodes: int = 32
    dense_nodes: int = 32
    kernel_size: int = 3
    input_hw: int = 60
    input_channels: int = 3

    @property
    def arch_id(self) -> str:
        return f"cnn_l{self.n_conv_layers}_c{self.conv_nodes}_d{self.dense_nodes}"
