"""whisper-tiny [audio]: enc-dec, conv frontend stubbed: the caller passes
precomputed frame embeddings. [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                 # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,               # GQA kv=6 (== MHA at this size)
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    qkv_bias=True,              # whisper uses biases on q/v
    tie_embeddings=True,
    norm="layernorm",
    act="gelu",
    rope_theta=0.0,             # whisper uses absolute (sinusoidal) positions
    encoder=EncoderConfig(n_layers=4, n_frames=1500),
    max_seq_len=32768,          # learned decoder positions sized for decode_32k
    source="[arXiv:2212.04356; unverified]",
)
