"""mamba2-130m [ssm]: attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,                  # attention-free
    n_kv_heads=0,
    d_ff=0,                     # no MLP; SSD block only
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
    subquadratic=True,
    tie_embeddings=True,
    source="[arXiv:2405.21060; unverified]",
)
