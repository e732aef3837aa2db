"""The four assigned input-shape cells (shared by all 10 architectures), a
copy of the reference's ``configs/shapes.py``.

``decode_32k``/``long_500k`` build ``decode_step`` (one new token against a
KV/state cache of seq_len), ``prefill_32k`` builds ``prefill_step``, and
``train_4k`` builds ``train_step``.
"""
from repro_torch.configs.base import ShapeConfig

TRAIN_4K = ShapeConfig(
    name="train_4k", kind="train", seq_len=4096, global_batch=256,
    microbatch_seqs_per_shard=1, remat_policy="full",
)
PREFILL_32K = ShapeConfig(
    name="prefill_32k", kind="prefill", seq_len=32768, global_batch=32,
    attn_chunk=2048,
)
DECODE_32K = ShapeConfig(
    name="decode_32k", kind="decode", seq_len=32768, global_batch=128,
)
LONG_500K = ShapeConfig(
    name="long_500k", kind="decode", seq_len=524288, global_batch=1,
)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(arch, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k needs sub-quadratic sequence mixing (SSM/hybrid); pure
    full-attention archs skip it (recorded, per DESIGN.md §5)."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "SKIPPED: pure full-attention arch; long_500k needs sub-quadratic attention"
    return True, ""
