"""config -> Model: uniform init/forward/prefill/decode, ported from the
reference's ``models/factory.py`` for the families the port runs
(``dense``, ``ssm`` and ``hybrid``)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.serve import kvcache


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable[..., Any]         # (generator, device=None) -> params
    forward: Callable[..., Any]      # (params, batch, **opt) -> (logits, aux, cache|None)
    prefill: Callable[..., Any]      # (params, batch, **opt) -> (logits, cache)
    decode: Callable[..., Any]       # (params, cache, batch) -> (logits, cache)
    init_cache: Callable[..., Any]   # (batch, seq, kv_dtype, device=None) -> cache


def build_model(cfg: ArchConfig) -> Model:
    transformer.check_family(cfg)
    return Model(
        cfg=cfg,
        init=lambda gen, device=None: transformer.init_decoder(
            gen, cfg, device=device),
        forward=lambda p, b, **kw: transformer.forward(p, b, cfg, **kw),
        prefill=lambda p, b, **kw: transformer.prefill(p, b, cfg, **kw),
        decode=lambda p, c, b: transformer.decode_step(p, c, b, cfg),
        init_cache=lambda batch, seq, kv_dtype="bfloat16", device=None:
            kvcache.init_cache(cfg, batch, seq, kv_dtype, device=device),
    )


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()
