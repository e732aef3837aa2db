"""zamba2-1.2b [hybrid]: Mamba2 backbone + ONE shared attention(+MLP) block
applied every 6 SSM blocks (weight re-use across depth; per-invocation LoRA
omitted, as in the reference). [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,                # mamba2 blocks
    d_model=2048,
    n_heads=32,                 # shared attn block (MHA kv=32)
    n_kv_heads=32,
    d_ff=8192,                  # shared block MLP
    vocab_size=32000,
    head_dim=64,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1),
    hybrid_attn_every=6,
    subquadratic=True,
    source="[arXiv:2411.15242; hf]",
)
