"""Shared LM building blocks, ported from the reference's
``models/common.py``.

* ``init_*`` functions return nested dicts of tensors with the reference's
  tree and leaf names, drawn from a ``torch.Generator`` with the
  reference's shapes and scales (the numbers differ from JAX's: parity
  tests carry weights over with ``transformer.params_from_jax``).
* Norms compute in float32 and cast back; params live in ``cfg.dtype``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding import policy

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def pdtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def _uniform(gen, shape, lo, hi, device):
    u = torch.rand(shape, generator=gen, device=gen.device).to(device)
    return u * (hi - lo) + lo


def dense_init(gen, shape, in_axis: int = 0, dtype=torch.bfloat16,
               scale=1.0, *, device):
    std = scale / math.sqrt(max(shape[in_axis], 1))
    return (_normal(gen, shape, device) * std).to(dtype)


def embed_init(gen, shape, dtype=torch.bfloat16, *, device):
    return (_normal(gen, shape, device) * 0.02).to(dtype)


# ---------------------------------------------------------------- norms ----
def init_norm(cfg, *, device):
    p = {"scale": torch.ones((cfg.d_model,), dtype=pdtype(cfg),
                             device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=pdtype(cfg),
                                device=device)
    return p


def apply_norm(p, x, cfg):
    xf = x.to(torch.float32)
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                              + cfg.norm_eps)
    else:  # layernorm
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    out = xf * p["scale"].to(torch.float32)
    if "bias" in p:
        out = out + p["bias"].to(torch.float32)
    return out.to(x.dtype)


def rmsnorm_vec(x, scale, eps=1e-5):
    """Norm over the last axis for vectors of any width (MLA latents)."""
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale.to(torch.float32)).to(x.dtype)


# ----------------------------------------------------------------- RoPE ----
def rope_angles(positions, dim: int, theta: float):
    """positions (...,) int -> cos/sin of shape (..., dim//2), float32."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    inv = torch.from_numpy(np.asarray(inv, np.float32)).to(positions.device)
    ang = positions.to(torch.float32)[..., None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., dim); cos/sin broadcastable to (..., dim//2). Pairs are the
    llama 'rotate_half' convention (first/second half split)."""
    d = x.shape[-1] // 2
    xf1, xf2 = x[..., :d].to(torch.float32), x[..., d:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)


def rope_for_heads(positions, head_dim: int, theta: float):
    """positions (B, S) -> cos/sin (B, S, 1, head_dim//2) for (B,S,H,D) q/k."""
    cos, sin = rope_angles(positions, head_dim, theta)
    return cos[:, :, None, :], sin[:, :, None, :]


def mrope_for_heads(positions3, head_dim: int, theta: float, sections):
    """Qwen2-VL M-RoPE: positions3 (3, B, S) carries the (t, h, w) position
    streams; the head_dim//2 frequency slots are split into ``sections``
    and each section takes its angles from its stream. -> cos/sin
    (B, S, 1, head_dim//2)."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} vs head_dim "
                         f"{head_dim}")
    cos3, sin3 = rope_angles(positions3, head_dim, theta)  # (3,B,S,hd/2)
    bounds = np.cumsum((0,) + tuple(sections)).tolist()
    parts = list(enumerate(zip(bounds[:-1], bounds[1:])))
    cos = torch.cat([cos3[i, ..., lo:hi] for i, (lo, hi) in parts], -1)
    sin = torch.cat([sin3[i, ..., lo:hi] for i, (lo, hi) in parts], -1)
    return cos[:, :, None, :], sin[:, :, None, :]


def sinusoidal_positions(n_pos: int, d_model: int, *, device=None):
    """Whisper-style sinusoidal embeddings (n_pos, d_model), float32,
    computed in float64 on the host as the reference computes them."""
    half = d_model // 2
    freq = np.exp(-np.log(10000.0) * np.arange(half) / max(half - 1, 1))
    t = np.arange(n_pos)[:, None] * freq[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], axis=1)
                            .astype(np.float32)).to(device)


# ----------------------------------------------------------- embeddings ----
def init_embedding(gen, cfg, *, device):
    return {"embedding": embed_init(gen, (cfg.padded_vocab(), cfg.d_model),
                                    pdtype(cfg), device=device)}


def _vocab_split(n_rows: int, cfg):
    """The ambient 'model' axis (``policy.ctx_tp``) when this rank holds
    ``n_rows`` of the padded vocab's rows, a share of them, else None."""
    tp = policy.ctx_tp()
    if tp is None or n_rows == cfg.padded_vocab():
        return None
    return tp


def embed_tokens(p, tokens, cfg):
    """The tokens' rows of the embedding. Under a 'model' split of the
    vocab rows each rank looks up the tokens in its rows (zeros for the
    others) and the ranks' rows are summed: one nonzero term, exact."""
    tp = _vocab_split(p["embedding"].shape[0], cfg)
    if tp is None:
        return p["embedding"][tokens.long()]
    rows = p["embedding"].shape[0]
    t = tokens.long() - tp.rank * rows
    mine = (t >= 0) & (t < rows)
    e = p["embedding"][t.clamp(0, rows - 1)]
    return policy.reduce_from_tp(torch.where(mine[..., None], e, 0.0), tp)


def init_lm_head(gen, cfg, *, device):
    if cfg.tie_embeddings:
        return {}
    return {"lm_head": dense_init(gen, (cfg.d_model, cfg.padded_vocab()), 0,
                                  pdtype(cfg), device=device)}


def lm_logits(head_p, embed_p, h, cfg):
    """Logits over the padded vocab; under a 'model' split of the head
    (``lm_head`` columns, or the tied embedding's rows), this rank's
    columns (vocab-parallel: ``whole_logits`` gathers them)."""
    tp = _vocab_split(embed_p["embedding"].shape[0] if cfg.tie_embeddings
                      else head_p["lm_head"].shape[1], cfg)
    if tp is not None:
        h = policy.copy_to_tp(h, tp)
    if cfg.tie_embeddings:
        return h @ embed_p["embedding"].T
    return h @ head_p["lm_head"]


def whole_logits(logits, cfg):
    """Vocab-parallel logits (``lm_logits``) whole on every rank: each
    rank's columns in a zero-filled row, summed over the 'model' ranks
    (exact: one nonzero term a column). As they are without a split."""
    tp = policy.ctx_tp()
    vp = logits.shape[-1]
    if tp is None or vp == cfg.padded_vocab():
        return logits
    out = logits.new_zeros(logits.shape[:-1] + (vp * tp.size,))
    out.narrow(-1, tp.rank * vp, vp).copy_(logits)
    return policy.reduce_from_tp(out, tp)


def activation(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax default
            "relu": F.relu}[name]
