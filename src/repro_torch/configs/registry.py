"""--arch <id> registry over the reference's ten LM architectures (the ssm
family: mamba2-130m and the zamba2 hybrid; the dense family: deepseek-7b,
minitron-4b, granite-20b and qwen2.5-32b; the moe family: phi3.5-moe and
deepseek-v2 with MLA; the vlm qwen2-vl with M-RoPE; the audio
encoder-decoder whisper-tiny), with their reduced ("smoke") variants:
same family and block structure, tiny widths and depths, as the
reference's ``smoke_config`` builds them."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (deepseek_7b, deepseek_v2_236b, granite_20b,
                                 mamba2_130m, minitron_4b, phi3_5_moe,
                                 qwen2_5_32b, qwen2_vl_72b, whisper_tiny,
                                 zamba2_1_2b)
from repro_torch.configs.base import (ArchConfig, EncoderConfig, MLAConfig,
                                      MoEConfig, SSMConfig, VisionConfig)

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (whisper_tiny.CONFIG, mamba2_130m.CONFIG,
                        granite_20b.CONFIG, deepseek_7b.CONFIG,
                        qwen2_5_32b.CONFIG, minitron_4b.CONFIG,
                        deepseek_v2_236b.CONFIG, phi3_5_moe.CONFIG,
                        qwen2_vl_72b.CONFIG, zamba2_1_2b.CONFIG)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown --arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced config of the same family for CPU smoke tests."""
    c = get_arch(name)
    kw: dict = dict(n_layers=2, d_model=64, vocab_size=503,  # odd vocab
                    max_seq_len=256)                         # pads
    if c.uses_attention:
        kw.update(n_heads=4, n_kv_heads=min(c.n_kv_heads, 2) or 2,
                  head_dim=16, d_ff=128)
    if c.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=4, top_k=2, d_ff_expert=32,
            num_shared_experts=c.moe.num_shared_experts,
            d_ff_shared=32 if c.moe.num_shared_experts else 0)
        kw["d_ff"] = 32
    if c.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
        kw["head_dim"] = 16
    if c.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                              n_groups=1, chunk_size=32)
        if c.family == "ssm":
            kw.pop("n_heads", None)
    if c.encoder is not None:
        kw["encoder"] = EncoderConfig(n_layers=2, n_frames=32)
    if c.vision is not None:
        kw["vision"] = VisionConfig(n_patches=8, mrope_sections=(2, 3, 3))
    if c.hybrid_attn_every:
        kw["n_layers"] = 4
        kw["hybrid_attn_every"] = 2
    return dataclasses.replace(c, **kw)
