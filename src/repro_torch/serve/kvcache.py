"""KV / state cache layouts and physical representations, ported from the
reference's ``serve/kvcache.py`` for the ``ssm`` and ``hybrid`` families.

The cache dtype is a physical representation choice: bfloat16 or float32,
or int8 with per-(token, head) f32 scales.

Layouts (stacked over layers):
  attention: k/v (L, B, T, KHp, Dh) [+ k_scale/v_scale (L,B,T,KHp) if int8]
  SSM:       conv_x/b/c (L, B, ch, K-1), state (L, B, H, P, N) fp32
  hybrid:    SSM stack + shared-attn k/v (J, B, T, KHp, Dh), J = invocations
  pos:       (B,) int32 -- number of valid tokens (same for all layers)

Unlike the reference, ``write_kv_layer`` writes the new token into the
cache tensors in place (the reference returns a new cache): a decode step
then writes one token per row instead of copying the cache.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import layout_from_cfg
from repro_torch.models.common import DTYPES
from repro_torch.models.ssm import init_ssm_cache


def _q8(x):
    """(..., Dh) -> int8 values + f32 scale over the last axis."""
    xf = x.to(torch.float32)
    scale = torch.clamp(torch.amax(torch.abs(xf), dim=-1) / 127.0, min=1e-8)
    q = torch.round(xf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _dq8(q, scale, dtype):
    return (q.to(torch.float32) * scale[..., None].to(torch.float32)
            ).to(dtype)


def init_attn_kv(cfg, batch: int, seq: int, kv_dtype: str = "bfloat16",
                 n_layers: int | None = None, *, device):
    l = n_layers if n_layers is not None else cfg.n_layers
    shape = (l, batch, seq, layout_from_cfg(cfg).khp, cfg.head_dim)
    if kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    dt = DTYPES[kv_dtype]
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def write_kv_layer(layer_cache, k_new, v_new, pos):
    """layer_cache: (B,T,KH,Dh) tensors [+ scales]; k_new/v_new (B,1,KH,Dh);
    pos (B,) write index. Writes in place and returns ``layer_cache``."""
    bidx = torch.arange(k_new.shape[0], device=k_new.device)
    pos = pos.long()
    if "k_scale" in layer_cache:
        kq, ks = _q8(k_new)
        vq, vs = _q8(v_new)
        layer_cache["k"][bidx, pos] = kq[:, 0]
        layer_cache["v"][bidx, pos] = vq[:, 0]
        layer_cache["k_scale"][bidx, pos] = ks[:, 0]
        layer_cache["v_scale"][bidx, pos] = vs[:, 0]
    else:
        dt = layer_cache["k"].dtype
        layer_cache["k"][bidx, pos] = k_new[:, 0].to(dt)
        layer_cache["v"][bidx, pos] = v_new[:, 0].to(dt)
    return layer_cache


def read_kv_layer(layer_cache, dtype=torch.bfloat16):
    """-> k, v (B,T,KH,Dh) in the compute dtype."""
    if "k_scale" in layer_cache:
        return (_dq8(layer_cache["k"], layer_cache["k_scale"], dtype),
                _dq8(layer_cache["v"], layer_cache["v_scale"], dtype))
    return layer_cache["k"].to(dtype), layer_cache["v"].to(dtype)


def init_cache(cfg, batch: int, seq: int, kv_dtype: str = "bfloat16", *,
               device=None):
    """Full decode cache of an ``ssm`` or ``hybrid`` model. 'pos' counts
    valid tokens. Runs on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    if cfg.family not in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r}: only the ssm and hybrid caches are "
            f"ported (ROADMAP Queue 1, item 5: the rest of the LM "
            f"substrate)")
    cache: dict = {"pos": torch.zeros((batch,), dtype=torch.int32,
                                      device=dev)}
    one = init_ssm_cache(cfg, batch, device=dev)
    cache["ssm"] = {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
                    for k, v in one.items()}
    if cfg.family == "hybrid":
        n_inv = cfg.n_layers // cfg.hybrid_attn_every
        cache["shared_attn"] = init_attn_kv(cfg, batch, seq, kv_dtype,
                                            n_layers=n_inv, device=dev)
    return cache
