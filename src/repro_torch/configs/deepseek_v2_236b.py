"""deepseek-v2-236b [moe]: MLA (kv_lora=512) + MoE 2 shared + 160 routed
top-6, expert d_ff=1536. [arXiv:2405.04434; hf]

MLA's latent KV cache (c_kv=512 + k_rope=64 per token instead of
2*128heads*128dim) is itself a *physical-representation* optimization of
the cache — the paper's core idea applied inside the model (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,             # MLA; kv heads notional
    d_ff=1536,                  # per routed expert
    vocab_size=102400,
    head_dim=128,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                  num_shared_experts=2, d_ff_shared=1536),
    source="[arXiv:2405.04434; hf]",
)
