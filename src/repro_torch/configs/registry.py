"""--arch <id> registry of the LM architectures the port runs so far (the
SSM family: mamba2-130m and the zamba2 hybrid), with their reduced
("smoke") variants: same family and block structure, tiny widths and
depths, as the reference's ``smoke_config`` builds them."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import mamba2_130m, zamba2_1_2b
from repro_torch.configs.base import ArchConfig, SSMConfig

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (mamba2_130m.CONFIG, zamba2_1_2b.CONFIG)}

# Registered in the reference, not ported yet (ROADMAP Queue 1, item 5:
# the rest of the LM substrate).
WAITING = ("whisper-tiny", "granite-20b", "deepseek-7b", "qwen2.5-32b",
           "minitron-4b", "deepseek-v2-236b", "phi3.5-moe-42b-a6.6b",
           "qwen2-vl-72b")


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in WAITING:
        raise NotImplementedError(
            f"--arch {name!r} is not ported yet (ROADMAP Queue 1, item 5: the "
            f"rest of the LM substrate, the dense/moe/MLA/vlm/audio "
            f"families); ported: {sorted(ARCHS)}")
    raise KeyError(f"unknown --arch {name!r}; known: {sorted(ARCHS)}")


def smoke_config(name: str) -> ArchConfig:
    """Reduced config of the same family for CPU smoke tests."""
    c = get_arch(name)
    kw: dict = dict(n_layers=2, d_model=64, vocab_size=503,  # odd vocab
                    max_seq_len=256)                         # pads
    if c.uses_attention:
        kw.update(n_heads=4, n_kv_heads=min(c.n_kv_heads, 2) or 2,
                  head_dim=16, d_ff=128)
    kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                          n_groups=1, chunk_size=32)
    if c.hybrid_attn_every:
        kw["n_layers"] = 4
        kw["hybrid_attn_every"] = 2
    return dataclasses.replace(c, **kw)
