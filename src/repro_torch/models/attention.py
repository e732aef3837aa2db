"""GQA/MQA attention (optional QKV bias, RoPE), ported from the
reference's ``models/attention.py``: head padding layout, projections,
the decode ``sdpa`` over the cache and the masked output projection, and
``chunked_sdpa``, the reference's query-chunked attention as a plain
function.

The full-sequence causal attention of prefill/forward is not here: the
decoder block calls the ``flash_attention`` kernel wrapper
(``kernels/flash_attention.py``) on (B,H,S,D) q/k/v with the KV heads
repeated (``repeat_kv``). MLA and cross-attention are not ported yet.

Head padding: q heads are padded per KV group up to a multiple of
``cfg.head_pad_to`` and zero-masked before ``wo``, so the numerics equal
the unpadded model's (the reference pads for its tensor-parallel mesh; on
one card ``head_pad_to`` is 1 and the layout is the identity).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.common import apply_rope, dense_init, pdtype


class HeadLayout(NamedTuple):
    n_q: int          # true q heads
    n_kv: int         # true kv heads
    hp: int           # padded q heads
    khp: int          # padded kv heads
    gp: int           # padded group size (hp // khp)

    def q_mask(self, device=None) -> torch.Tensor:
        """(hp,) 1.0 for real q heads."""
        i = torch.arange(self.hp, device=device)
        if self.khp == self.n_kv:     # per-group padding
            g = self.n_q // self.n_kv
            return ((i % self.gp) < g).to(torch.float32)
        return (i < self.n_q).to(torch.float32)

    def q_head_is_real(self, i: int) -> bool:
        if self.khp == self.n_kv:
            g = self.n_q // self.n_kv
            return (i % self.gp) < g
        return i < self.n_q


def head_layout(n_q: int, n_kv: int, pad_to: int) -> HeadLayout:
    if pad_to <= 1 or n_q % pad_to == 0:
        return HeadLayout(n_q, n_kv, n_q, n_kv, n_q // max(n_kv, 1))
    g = n_q // n_kv
    if g == 1:  # MHA: pad q and kv in lockstep (mapping i -> i preserved)
        hp = ((n_q + pad_to - 1) // pad_to) * pad_to
        return HeadLayout(n_q, n_kv, hp, hp, 1)
    for gp in range(g, 64 * g):
        if (n_kv * gp) % pad_to == 0:
            return HeadLayout(n_q, n_kv, n_kv * gp, n_kv, gp)
    return HeadLayout(n_q, n_kv, n_q, n_kv, g)  # no padding found


def layout_from_cfg(cfg) -> HeadLayout:
    return head_layout(cfg.n_heads, cfg.n_kv_heads, cfg.head_pad_to)


def init_gqa(gen, cfg, *, device):
    lo = layout_from_cfg(cfg)
    d, dh = cfg.d_model, cfg.head_dim
    dt = pdtype(cfg)
    p = {name: dense_init(gen, shape, 0, dt, device=device)
         for name, shape in (("wq", (d, lo.hp * dh)), ("wk", (d, lo.khp * dh)),
                             ("wv", (d, lo.khp * dh)),
                             ("wo", (lo.hp * dh, d)))}
    if cfg.qkv_bias:
        for name, width in (("bq", lo.hp), ("bk", lo.khp), ("bv", lo.khp)):
            p[name] = torch.zeros((width * dh,), dtype=dt, device=device)
    return p


def gqa_qkv(p, x, cfg, rope=None):
    """Project to q (B,S,hp,dh) and k,v (B,S,khp,dh); apply rope if given
    as (cos_q, sin_q, cos_k, sin_k)."""
    lo = layout_from_cfg(cfg)
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, lo.hp, cfg.head_dim)
    k = k.reshape(b, s, lo.khp, cfg.head_dim)
    v = v.reshape(b, s, lo.khp, cfg.head_dim)
    if rope is not None:
        cos_q, sin_q, cos_k, sin_k = rope
        q = apply_rope(q, cos_q, sin_q)
        k = apply_rope(k, cos_k, sin_k)
    return q, k, v


def repeat_kv(k, gp: int):
    """(B,T,khp,dh) -> (B,T,khp*gp,dh), each KV head repeated gp times."""
    if gp == 1:
        return k
    b, t, kh, dh = k.shape
    return k[:, :, :, None, :].expand(b, t, kh, gp, dh).reshape(
        b, t, kh * gp, dh)


def sdpa(q, k, v, *, k_valid, gp: int = 1):
    """GQA-grouped scaled-dot-product attention over the decode cache.
    q (B,S,H,dh); k/v (B,T,KH,dh) with H = KH*gp -> (B,S,H,dh); k_valid
    (B,T) bool marks the cache entries that exist. q is regrouped to
    (B,S,KH,gp,dh); k/v are never repeated."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    if h != kh * gp:
        raise ValueError(f"sdpa: {h} q heads vs {kh} kv heads x {gp}")
    qg = q.reshape(b, s, kh, gp, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32) \
        * dh ** -0.5
    scores = scores.masked_fill(~k_valid[:, None, None, None, :],
                                torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgst,btkd->bskgd", probs.to(q.dtype), v)
    return ctx.reshape(b, s, h, v.shape[-1])


def chunked_sdpa(q, k, v, *, causal: bool, chunk: int, gp: int = 1):
    """The reference's jnp-flash as a plain function: softmax attention one
    query chunk at a time, so the (S x T) scores are never all held.
    q (B,S,H,dh) with S a multiple of ``chunk``; k/v (B,T,KH,dh), H =
    KH*gp, GQA-grouped as ``sdpa`` (k/v never repeated). The causal mask
    compares absolute positions, query i seeing keys 0..i."""
    b, s, h, dh = q.shape
    kh, t = k.shape[2], k.shape[1]
    if s % chunk or h != kh * gp:
        raise ValueError(f"chunked_sdpa: S {s}, chunk {chunk}, {h} q heads "
                         f"vs {kh} kv heads x {gp}")
    kpos = torch.arange(t, device=q.device)
    neg = torch.finfo(torch.float32).min
    outs = []
    for c0 in range(0, s, chunk):
        qc = q[:, c0:c0 + chunk].reshape(b, chunk, kh, gp, dh)
        scores = torch.einsum("bskgd,btkd->bkgst", qc, k).to(torch.float32)
        scores = scores * dh ** -0.5
        if causal:
            qpos = c0 + torch.arange(chunk, device=q.device)
            scores = scores.masked_fill(
                (qpos[:, None] < kpos[None, :])[None, None, None], neg)
        probs = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bkgst,btkd->bskgd", probs.to(q.dtype), v))
    return torch.cat(outs, 1).reshape(b, s, h, v.shape[-1])


def gqa_out(p, ctx, cfg):
    """Mask padded heads (exact-zero contribution), then w_o."""
    lo = layout_from_cfg(cfg)
    b, s = ctx.shape[:2]
    if lo.hp != lo.n_q:
        ctx = ctx * lo.q_mask(ctx.device)[None, None, :, None].to(ctx.dtype)
    return ctx.reshape(b, s, lo.hp * cfg.head_dim) @ p["wo"]
