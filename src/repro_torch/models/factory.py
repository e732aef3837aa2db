"""config -> Model: uniform init/forward/prefill/decode across families,
ported from the reference's ``models/factory.py``: the audio family
through ``models/encdec``, every other family through
``models/transformer``."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer
from repro_torch.serve import kvcache


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable[..., Any]         # (generator, device=None) -> params
    forward: Callable[..., Any]      # (params, batch, **opt) -> (logits, aux, cache|None)
    prefill: Callable[..., Any]      # (params, batch, **opt) -> (logits, cache)
    decode: Callable[..., Any]       # (params, cache, batch) -> (logits, cache)
    init_cache: Callable[..., Any]   # (batch, seq, kv_dtype, device=None) -> cache


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family == "audio":
        mod, init = encdec, encdec.init_encdec
    else:
        transformer.check_family(cfg)
        mod, init = transformer, transformer.init_decoder
    return Model(
        cfg=cfg,
        init=lambda gen, device=None: init(gen, cfg, device=device),
        forward=lambda p, b, **kw: mod.forward(p, b, cfg, **kw),
        prefill=lambda p, b, **kw: mod.prefill(p, b, cfg, **kw),
        decode=lambda p, c, b: mod.decode_step(p, c, b, cfg),
        init_cache=lambda batch, seq, kv_dtype="bfloat16", device=None:
            kvcache.init_cache(cfg, batch, seq, kv_dtype, device=device),
    )


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()
