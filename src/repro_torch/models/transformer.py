"""Decoder-only model assembly for the ``dense`` (GQA/MQA attention +
MLP), ``ssm`` and ``hybrid`` (zamba2) families, ported from the
reference's ``models/transformer.py``.

Parameters are plain dicts of tensors with the reference's tree and leaf
names, the per-layer leaves stacked on a leading ``(L, ...)`` axis; the
layer loop is a Python loop over that axis. The hybrid family runs
[k SSM layers -> the ONE shared attention+MLP block] segments.

Three entry points, shared by serving and the tests:
  forward(params, batch)          -> (logits (B,S,Vp), aux, cache pieces)
  prefill(params, batch)          -> (last logits (B,Vp), cache)
  decode_step(params, cache, tok) -> (logits (B,Vp), cache)

On the full-sequence path the SSD runs through the ``ssd_scan`` kernel
wrapper and every attention block's causal attention (the dense family's
layers, the hybrid's shared block) through the ``flash_attention`` kernel
wrapper; decode keeps the plain recurrences (``ssd_decode``, ``sdpa`` over
the cache), as the reference does. ``decode_step`` writes the new token's
state into ``cache`` in place.

The reference's ``attn_chunk`` (query chunks of ``chunked_sdpa`` for long
prefill) has no counterpart here: on the card the flash kernel tiles the
queries itself (64 rows a block) whatever chunk the reference would use,
and on CPU tensors its plain version computes the same softmax attention
unchunked. ``attention.chunked_sdpa`` is the reference's chunked
function, held against it by the tests.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as attn
from repro_torch.models import ffn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    DTYPES, apply_norm, embed_tokens, init_embedding, init_lm_head,
    init_norm, lm_logits, pdtype, rope_for_heads)
from repro_torch.serve import kvcache

FAMILIES = ("dense", "ssm", "hybrid")


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES or cfg.moe is not None \
            or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: only the dense, ssm and hybrid families (GQA "
            f"attention, dense MLP) are ported (ROADMAP Queue 1: the rest "
            f"of the LM substrate, moe/MLA/vlm/audio)")


# ------------------------------------------------------------------ trees --
def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(trees):
    """A list of equally shaped trees -> one tree of stacked leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _layer(tree, i):
    """Leaf-wise ``x[i]`` (views: writes reach the stacked tensors)."""
    return _tree_map(lambda x: x[i], tree)


# ------------------------------------------------------------------- init --
def _init_dense_layer(gen, cfg, *, device):
    return {"ln1": init_norm(cfg, device=device),
            "ln2": init_norm(cfg, device=device),
            "attn": attn.init_gqa(gen, cfg, device=device),
            "mlp": ffn.init_mlp(gen, cfg, device=device)}


def _init_ssm_layer(gen, cfg, *, device):
    return {"ln1": init_norm(cfg, device=device),
            "ssm": ssm_mod.init_ssm(gen, cfg, device=device)}


def init_decoder(gen: torch.Generator, cfg, *, device=None):
    """Random weights with the reference's tree, shapes and scales, drawn
    from ``gen``. Runs on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    check_family(cfg)
    p: dict[str, Any] = {"embed": init_embedding(gen, cfg, device=dev),
                         "final_norm": init_norm(cfg, device=dev)}
    p.update(init_lm_head(gen, cfg, device=dev))
    init_layer = (_init_dense_layer if cfg.family == "dense"
                  else _init_ssm_layer)
    p["layers"] = _stack([init_layer(gen, cfg, device=dev)
                          for _ in range(cfg.n_layers)])
    if cfg.family == "hybrid":
        p["shared"] = _init_dense_layer(gen, cfg, device=dev)  # ONE block
    return p


def params_from_jax(params_np, device=None):
    """The reference's parameter tree, already converted to numpy on the
    caller's side -> the same tree of tensors on ``device`` (default: the
    card). Leaves keep their shapes and dtypes; JAX's bfloat16 arrays
    (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses) cross
    through a 16-bit integer view."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(arr)).to(dev)

    return conv(params_np)


# ------------------------------------------------------------------ block --
def _make_rope(cfg, positions):
    """-> (cos, sin) shaped (B, S, 1, head_dim/2), or None."""
    if not cfg.uses_attention:
        return None
    return rope_for_heads(positions, cfg.head_dim, cfg.rope_theta)


def _dense_block(lp, h, cfg, rope, *, cache_slice=None, pos=None):
    """One attention+MLP block (GQA). cache_slice given => decode (S==1).
    Returns (h, collected k/v of a full pass, updated cache slice)."""
    ain = apply_norm(lp["ln1"], h, cfg)
    lo = attn.layout_from_cfg(cfg)
    rope4 = None if rope is None else (rope[0], rope[1], rope[0], rope[1])
    q, k, v = attn.gqa_qkv(lp["attn"], ain, cfg, rope=rope4)
    collected = new_cache = None
    if cache_slice is not None:
        new_cache = kvcache.write_kv_layer(cache_slice, k, v, pos)
        kf, vf = kvcache.read_kv_layer(new_cache, h.dtype)
        k_valid = (torch.arange(kf.shape[1], device=h.device)[None]
                   <= pos[:, None])
        ctx = attn.sdpa(q, kf, vf, k_valid=k_valid, gp=lo.gp)
    else:
        # the kernel takes (B,H,S,D) with the KV heads repeated, at any
        # strides with a contiguous last dimension: the transposed views
        # of the model's (B,S,H,D) tensors go in as they are, and the
        # output comes back in q's layout, so transposing it back is a
        # contiguous (B,S,H,D) tensor. No copy either way.
        ctx = flash_attention(
            q.transpose(1, 2), attn.repeat_kv(k, lo.gp).transpose(1, 2),
            attn.repeat_kv(v, lo.gp).transpose(1, 2), causal=True
        ).transpose(1, 2)
        collected = {"k": k, "v": v}
    h = h + attn.gqa_out(lp["attn"], ctx, cfg)
    h = h + ffn.apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg), cfg)
    return h, collected, new_cache


def _ssm_layer(params, i, h, cfg, **kw):
    lp = _layer(params["layers"], i)
    out, st = ssm_mod.apply_ssm(lp["ssm"], apply_norm(lp["ln1"], h, cfg),
                                cfg, **kw)
    return h + out, st


def hybrid_segments(cfg):
    """[(n_ssm_layers, has_shared_attn_after), ...]."""
    every = cfg.hybrid_attn_every
    segs = []
    done = 0
    while done < cfg.n_layers:
        n = min(every, cfg.n_layers - done)
        done += n
        segs.append((n, n == every))
    return segs


# ---------------------------------------------------------------- forward --
def _embed_input(params, batch, cfg):
    return embed_tokens(params["embed"], batch["tokens"], cfg).to(
        pdtype(cfg))


def forward(params, batch, cfg, *, collect_cache=False,
            logits_last_only=False):
    """Full-sequence pass. Returns (logits, aux, cache_pieces|None).
    logits_last_only: the LM head on the final position only."""
    check_family(cfg)
    h = _embed_input(params, batch, cfg)
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    rope = _make_rope(cfg, positions)
    if cfg.family == "dense":
        kv = []
        for i in range(cfg.n_layers):
            h, coll, _ = _dense_block(_layer(params["layers"], i), h, cfg,
                                      rope)
            if collect_cache:
                kv.append(coll)
        cache_pieces = _stack(kv) if collect_cache else None
    elif cfg.family == "ssm":
        states = []
        for i in range(cfg.n_layers):
            h, st = _ssm_layer(params, i, h, cfg, collect_state=collect_cache)
            states.append(st)
        cache_pieces = _stack(states) if collect_cache else None
    else:
        h, cache_pieces = _hybrid_forward(params, h, cfg, rope,
                                          collect_cache=collect_cache)
    if logits_last_only:
        h = h[:, -1:]
    h = apply_norm(params["final_norm"], h, cfg)
    logits = lm_logits(params, params["embed"], h, cfg)
    return logits, torch.zeros((), device=h.device), cache_pieces


def _hybrid_forward(params, h, cfg, rope, *, collect_cache):
    ssm_states, shared_kv = [], []
    lo_i = 0
    for n, has_attn in hybrid_segments(cfg):
        for i in range(lo_i, lo_i + n):
            h, st = _ssm_layer(params, i, h, cfg, collect_state=collect_cache)
            ssm_states.append(st)
        lo_i += n
        if has_attn:
            h, coll, _ = _dense_block(params["shared"], h, cfg, rope)
            shared_kv.append(coll)
    if not collect_cache:
        return h, None
    return h, {"ssm": _stack(ssm_states),
               "shared": _stack(shared_kv) if shared_kv else None}


# ---------------------------------------------------------------- prefill --
def prefill(params, batch, cfg, *, kv_dtype="bfloat16", last_only=False):
    """Returns (last-token logits (B,Vp), decode-ready cache). The dense
    family's k/v go to the cache in ``kv_dtype`` (int8 with per-(token,
    head) scales); as in the reference, the hybrid's shared-attention k/v
    go in bf16 when ``kv_dtype`` is int8 (int8 caches come from
    ``init_cache``). last_only: the LM head on the final position only."""
    logits, _, pieces = forward(params, batch, cfg, collect_cache=True,
                                logits_last_only=last_only)
    b, s = batch["tokens"].shape
    cache: dict = {"pos": torch.full((b,), s, dtype=torch.int32,
                                     device=logits.device)}
    cache_dt = torch.bfloat16 if kv_dtype == "int8" else DTYPES[kv_dtype]
    if cfg.family == "dense":
        if kv_dtype == "int8":
            kq, ks = kvcache._q8(pieces["k"])
            vq, vs = kvcache._q8(pieces["v"])
            cache["kv"] = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            cache["kv"] = {"k": pieces["k"].to(cache_dt),
                           "v": pieces["v"].to(cache_dt)}
    elif cfg.family == "ssm":
        cache["ssm"] = pieces
    else:
        cache["ssm"] = pieces["ssm"]
        if pieces["shared"] is not None:
            cache["shared_attn"] = {"k": pieces["shared"]["k"].to(cache_dt),
                                    "v": pieces["shared"]["v"].to(cache_dt)}
    return logits[:, -1], cache


# ----------------------------------------------------------------- decode --
def decode_step(params, cache, batch, cfg):
    """One token: batch["tokens"] (B,1). Returns (logits (B,Vp), cache);
    the cache is updated in place."""
    check_family(cfg)
    h = _embed_input(params, batch, cfg)
    pos = cache["pos"]                                  # (B,) write index
    rope = _make_rope(cfg, pos[:, None])
    if cfg.family == "dense":
        for i in range(cfg.n_layers):
            h, _, _ = _dense_block(_layer(params["layers"], i), h, cfg, rope,
                                   cache_slice=_layer(cache["kv"], i),
                                   pos=pos)
    else:
        h = _ssm_decode(params, h, cache, cfg, rope, pos)
    h = apply_norm(params["final_norm"], h, cfg)
    logits = lm_logits(params, params["embed"], h, cfg)
    cache["pos"] = pos + 1
    return logits[:, -1], cache


def _ssm_decode(params, h, cache, cfg, rope, pos):
    """The SSM stack's step (and the hybrid's shared block between its
    segments), writing each layer's state into ``cache`` in place."""
    lo_i = inv = 0
    segs = (hybrid_segments(cfg) if cfg.family == "hybrid"
            else [(cfg.n_layers, False)])
    for n, has_attn in segs:
        for i in range(lo_i, lo_i + n):
            h, nc = _ssm_layer(params, i, h, cfg,
                               cache=_layer(cache["ssm"], i))
            for name, val in nc.items():
                cache["ssm"][name][i] = val
        lo_i += n
        if has_attn:
            lc = _layer(cache["shared_attn"], inv)
            inv += 1
            h, _, _ = _dense_block(params["shared"], h, cfg, rope,
                                   cache_slice=lc, pos=pos)
    return h
