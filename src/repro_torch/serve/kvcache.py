"""KV / state cache layouts and physical representations, ported from the
reference's ``serve/kvcache.py``.

The cache dtype is a physical representation choice: bfloat16 or float32,
or int8 with per-(token, head) f32 scales (MLA's latent cache and the
audio family's cross cache stay bf16 when int8 is asked, as in the
reference).

Layouts (stacked over layers):
  attention: k/v (L, B, T, KHp, Dh) [+ k_scale/v_scale (L,B,T,KHp) if int8]
             (cache["kv"] of the dense, moe and vlm families)
  MLA:       c_kv (L, B, T, r), k_rope (L, B, T, rope)   (cache["mla"])
  SSM:       conv_x/b/c (L, B, ch, K-1), state (L, B, H, P, N) fp32
  hybrid:    SSM stack + shared-attn k/v (J, B, T, KHp, Dh), J = invocations
  audio:     decoder self-attention k/v as attention ("self"), and the
             cross-attention k/v of the encoder's frames (L, B, n_frames,
             KHp, Dh) ("cross"), written once by prefill
  pos:       (B,) int32 -- number of valid tokens (same for all layers)

Under a step's mesh context on a 'model' axis of more than 1
(``sharding.policy.use_ctx_mesh``), ``init_cache`` holds this rank's KV
heads (the self cache, the audio family's cross cache too) and SSM heads
(``attention.cache_kv_heads``, ``ssm.init_ssm_cache``), as the rank's
prefill writes them; MLA's latent cache is whole and the same on every
rank (each rank folds its heads' up-projections over it).

In a context-parallel decode step (``policy.ctx_dp``: the batch does not
split over the data-parallel axes), ``init_cache`` holds this rank's
block of each sequence axis that the 'data' ranks divide, as the
reference's ``cache_pspecs`` splits it: the self caches' ``seq / n``
positions from ``rank * seq / n`` on (``k``/``v`` and their int8 scales,
MLA's ``c_kv``/``k_rope``, the hybrid's shared-attention k/v), and the
audio family's cross cache where ``n`` divides its frames
(``seq_block``). A new token is written only on the rank whose block
holds its position, at its place in the block (``write_rows``).

Unlike the reference, ``write_kv_layer`` writes the new token into the
cache tensors in place (the reference returns a new cache): a decode step
then writes one token per row instead of copying the cache.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import cache_kv_heads
from repro_torch.models.common import DTYPES
from repro_torch.models.ssm import init_ssm_cache
from repro_torch.sharding import policy


# the leaves whose axis 2 is a sequence (stacked over layers: L, B, T, ...)
SEQ_LEAVES = ("k", "v", "k_scale", "v_scale", "c_kv", "k_rope")


def _q8(x):
    """(..., Dh) -> int8 values + f32 scale over the last axis."""
    xf = x.to(torch.float32)
    scale = torch.clamp(torch.amax(torch.abs(xf), dim=-1) / 127.0, min=1e-8)
    q = torch.round(xf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _dq8(q, scale, dtype):
    return (q.to(torch.float32) * scale[..., None].to(torch.float32)
            ).to(dtype)


def seq_block(seq: int) -> tuple[int | None, int]:
    """(first position, length) of this rank's block of a cache sequence
    axis of ``seq`` positions in a context-parallel decode step
    (``policy.ctx_dp``); (None, ``seq``) where the axis is whole on every
    rank (no such step, or the 'data' ranks do not divide ``seq``)."""
    dp = policy.ctx_dp()
    start = None if dp is None else dp.block(seq)
    return start, (seq if start is None else seq // dp.size)


def write_rows(pairs, pos, start=None):
    """``x[b, pos[b]] = new[b]`` in place for each (x, new) of ``pairs``: a
    cache leaf x (B, T, ...) and the new token's values (B, ...) in x's
    dtype. With ``start`` (x is the block of positions [start, start +
    T)), only the rows whose position falls in the block are written, at
    ``pos - start``; the others keep their values (a row's slot is read
    and written back: no host sync)."""
    bidx = torch.arange(pairs[0][1].shape[0], device=pos.device)
    pos = pos.long()
    if start is not None:
        t = pairs[0][0].shape[1]
        at = pos - start
        mine = (at >= 0) & (at < t)
        pos = at.clamp(0, t - 1)
    for x, new in pairs:
        if start is not None:
            new = torch.where(mine.view((-1,) + (1,) * (new.dim() - 1)),
                              new, x[bidx, pos])
        x[bidx, pos] = new


def init_attn_kv(cfg, batch: int, seq: int, kv_dtype: str = "bfloat16",
                 n_layers: int | None = None, *, device):
    l = n_layers if n_layers is not None else cfg.n_layers
    shape = (l, batch, seq_block(seq)[1], cache_kv_heads(cfg), cfg.head_dim)
    if kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    dt = DTYPES[kv_dtype]
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def write_kv_layer(layer_cache, k_new, v_new, pos, start=None):
    """layer_cache: (B,T,KH,Dh) tensors [+ scales]; k_new/v_new (B,1,KH,Dh);
    pos (B,) write index; ``start``: the first position of the cache's
    block (``seq_block``; None: the whole sequence). Writes in place
    (``write_rows``) and returns ``layer_cache``."""
    if "k_scale" in layer_cache:
        kq, ks = _q8(k_new)
        vq, vs = _q8(v_new)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        dt = layer_cache["k"].dtype
        new = {"k": k_new.to(dt), "v": v_new.to(dt)}
    write_rows([(layer_cache[k], x[:, 0]) for k, x in new.items()], pos,
               start)
    return layer_cache


def read_kv_layer(layer_cache, dtype=torch.bfloat16):
    """-> k, v (B,T,KH,Dh) in the compute dtype."""
    if "k_scale" in layer_cache:
        return (_dq8(layer_cache["k"], layer_cache["k_scale"], dtype),
                _dq8(layer_cache["v"], layer_cache["v_scale"], dtype))
    return layer_cache["k"].to(dtype), layer_cache["v"].to(dtype)


def init_mla_kv(cfg, batch: int, seq: int, kv_dtype: str = "bfloat16", *,
                device):
    m = cfg.mla
    dt = torch.bfloat16 if kv_dtype == "int8" else DTYPES[kv_dtype]
    t = seq_block(seq)[1]
    return {"c_kv": torch.zeros((cfg.n_layers, batch, t, m.kv_lora_rank),
                                dtype=dt, device=device),
            "k_rope": torch.zeros((cfg.n_layers, batch, t,
                                   m.qk_rope_head_dim), dtype=dt,
                                  device=device)}


def init_cache(cfg, batch: int, seq: int, kv_dtype: str = "bfloat16", *,
               device=None):
    """Full decode cache for any family (this rank's heads and sequence
    blocks under a step's mesh context). 'pos' counts valid tokens. Runs
    on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    cache: dict = {"pos": torch.zeros((batch,), dtype=torch.int32,
                                      device=dev)}
    if cfg.family in ("ssm", "hybrid"):
        one = init_ssm_cache(cfg, batch, device=dev)
        cache["ssm"] = {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
                        for k, v in one.items()}
        if cfg.family == "hybrid":
            n_inv = cfg.n_layers // cfg.hybrid_attn_every
            cache["shared_attn"] = init_attn_kv(cfg, batch, seq, kv_dtype,
                                                n_layers=n_inv, device=dev)
    elif cfg.mla is not None:
        cache["mla"] = init_mla_kv(cfg, batch, seq, kv_dtype, device=dev)
    elif cfg.family == "audio":
        cache["self"] = init_attn_kv(cfg, batch, seq, kv_dtype, device=dev)
        cache["cross"] = init_attn_kv(cfg, batch, cfg.encoder.n_frames,
                                      "bfloat16", device=dev)
    else:
        cache["kv"] = init_attn_kv(cfg, batch, seq, kv_dtype, device=dev)
    return cache
