"""qwen2-vl-72b [vlm]: M-RoPE, dynamic resolution; transformer BACKBONE only
(patch frontend is a STUB: the caller passes precomputed patch
embeddings + 3-axis position ids). [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ArchConfig, VisionConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    vision=VisionConfig(n_patches=256, mrope_sections=(16, 24, 24)),
    source="[arXiv:2409.12191; hf]",
)
