"""Per-(arch-family x phase) deployment configurations, a copy of the
reference's ``configs/deployment.py`` (its hill-climb results, taken as
they are: no number here was measured on the card).

``tuned_shape(arch, shape)`` returns the ShapeConfig a production launch
should actually use:

* decode: TP-resident weights (no ZeRO gathers at serve time) + int8 KV
  cache — EXCEPT tiny-model long-context cells, where replicating weights
  across the data axis amplifies weight reads past the cache savings;
* prefill: TP-resident weights + last-token-only LM head;
* train: MoE archs get chunked (flash) attention, dots-remat and 4-seq
  microbatches (targets ZeRO expert-weight regathers); dense/SSM archs
  keep the baseline.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeConfig


def tuned_shape(arch: ArchConfig, shape: ShapeConfig) -> ShapeConfig:
    kw: dict = {}
    if shape.kind == "decode":
        small_long = shape.global_batch == 1 and arch.subquadratic
        if not small_long:
            kw.update(params_tp_only=True, kv_dtype="int8")
    elif shape.kind == "prefill":
        kw.update(params_tp_only=True, prefill_last_only=True)
    elif shape.kind == "train" and arch.moe is not None:
        kw.update(train_attn_chunk=1024, remat_policy="dots",
                  microbatch_seqs_per_shard=4)
    return dataclasses.replace(shape, **kw) if kw else shape
