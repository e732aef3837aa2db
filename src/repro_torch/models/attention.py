"""Attention, ported from the reference's ``models/attention.py``: GQA/MQA
(optional QKV bias, RoPE or M-RoPE angles from the caller), the head
padding layout, projections (cross-attention through ``kv_x``), ``sdpa``
(the decode attention over a cache, causal or not, v heads of another
width than q/k), the masked output projection, ``chunked_sdpa`` (the
reference's query-chunked attention as a plain function), and MLA
(DeepSeek-V2: low-rank q, a latent KV of ``kv_lora_rank`` + a shared rope
key, its full-sequence attention and the absorbed decode).

The full-sequence GQA attention of prefill/forward is not here: the
decoder block and the encoder-decoder call the ``flash_attention`` kernel
wrapper (``kernels/flash_attention.py``) on (B,H,S,D) q/k/v with the KV
heads repeated (``repeat_kv``). MLA's full attention stays plain
(``mla_attention_full`` runs ``sdpa``), on the card too: its q/k heads
are qk_nope + qk_rope wide and its v heads v_head_dim, and the kernel, as
the reference's Pallas kernel, has one head width for q, k and v.

Head padding: q heads are padded per KV group up to a multiple of
``cfg.head_pad_to`` and zero-masked before ``wo``, so the numerics equal
the unpadded model's (the reference pads for its tensor-parallel mesh; on
one card ``head_pad_to`` is 1 and the layout is the identity).

Tensor parallelism (a step under ``policy.use_ctx_mesh`` on a 'model'
axis of more than 1, with ``wq`` split by the policy): ``wq``/``bq`` hold
this rank's ``hp / tp`` q heads and ``wo`` their rows; the projections
are column-parallel (``policy.copy_to_tp`` before them) and ``wo``
row-parallel (``policy.reduce_from_tp`` after it). ``HeadLayout.
rank_heads`` names the KV heads the rank's q heads read. Where the KV
heads split over 'model' as the q heads do, ``wk``/``wv`` hold exactly
those; where they do not (granite-20b's one KV head, qwen2.5-32b's 8 on
16 ranks), the policy still splits ``wk``/``wv`` columns inside a head,
and the rank gathers them over 'model' (``policy.gather_tp``) and keeps
its KV heads; ``bk``/``bv`` are replicated and sliced. MLA (``mla_split``)
splits its heads the same way: ``w_uq``/``w_uk``/``w_uv`` hold the rank's
``n_heads / tp`` heads' columns and ``wo`` their rows, while the latent
projections and norms (``w_dq``, ``q_norm``, ``w_dkv``, ``kv_norm``) are
replicated: the normalized latents ``cq``, ``c_kv`` and the shared rope
key are computed whole on every rank (the decode cache is whole and the
same on every rank) and enter the rank's heads through
``policy.copy_to_tp``.

Context-parallel decode (a decode step under ``policy.ctx_dp``: the batch
does not split over the data-parallel axes, and each 'data' rank holds a
block of the cache's sequence): ``cache_attention`` and
``mla_attention_decode`` compute the rank's partial softmax over its
block, flash-decoding style (``sdpa_partial``: the running max ``m``,
the sum of exponentials ``l`` and the unnormalised f32 accumulator
``o``, keys valid by their global position), and ``combine_partials``
joins the ranks' partials over 'data' with one max and one sum
all-reduce. A rank with no valid key in its block contributes exactly
zero: its ``m`` is -inf and its weight ``exp(m - max m)`` 0. MLA combines
in the latent space, before ``w_uv``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.common import (apply_rope, dense_init, pdtype,
                                      rmsnorm_vec)
from repro_torch.sharding import policy


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

    def rank_heads(self, size: int, rank: int) -> "RankHeads":
        """The q heads of rank ``rank`` of ``size`` (an equal block of the
        padded heads) and the KV heads they read, or ValueError where
        they do not split so (the heads do not divide, or a rank's q
        heads would read their KV heads unevenly)."""
        if self.hp % size:
            raise ValueError(f"{self.hp} q heads do not split over "
                             f"{size} 'model' ranks")
        hq = self.hp // size
        q0 = rank * hq
        if hq % self.gp == 0:          # whole KV groups
            return RankHeads(q0, hq, q0 // self.gp, hq // self.gp, self.gp)
        if self.gp % hq == 0:          # inside one KV group
            return RankHeads(q0, hq, q0 // self.gp, 1, hq)
        raise ValueError(f"{hq} q heads a rank read groups of {self.gp} "
                         f"unevenly")


class RankHeads(NamedTuple):
    """One 'model' rank's heads: q heads [q0, q0 + hq), reading the KV
    heads [kv0, kv0 + hkv), gp q heads to a KV head."""
    q0: int
    hq: int
    kv0: int
    hkv: int
    gp: int


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


def attn_split(p, cfg):
    """(the ambient 'model' axis, this rank's ``RankHeads``) when ``p``'s
    ``wq`` holds a share of the q heads, else (None, None): the block
    runs whole."""
    tp = policy.ctx_tp()
    if tp is None:
        return None, None
    lo = layout_from_cfg(cfg)
    if p["wq"].shape[-1] == lo.hp * cfg.head_dim:
        return None, None
    return tp, lo.rank_heads(tp.size, tp.rank)


def cache_kv_heads(cfg) -> int:
    """KV heads of a decode cache: all of them, or under the ambient
    'model' axis those of this rank (where the policy splits ``wq``)."""
    lo = layout_from_cfg(cfg)
    tp = policy.ctx_tp()
    if tp is None or (lo.hp * cfg.head_dim) % tp.size:
        return lo.khp
    return lo.rank_heads(tp.size, tp.rank).hkv


def _rank_kv(w, lo, rh, cfg, tp):
    """The columns (last dim) of ``wk``/``wv``/``bk``/``bv`` that hold the
    KV heads this rank's q heads read."""
    dh = cfg.head_dim
    if w.shape[-1] == lo.khp * dh:        # replicated by the policy
        w = policy.copy_to_tp(w, tp)
    elif lo.khp % tp.size == 0:           # this rank's KV heads
        return w
    else:                                 # split inside a head
        w = policy.gather_tp(w, -1, tp)
    return w.narrow(-1, rh.kv0 * dh, rh.hkv * dh)


def gqa_qkv(p, x, cfg, rope=None, kv_x=None):
    """Project to q (B,S,hp,dh) and k,v (B,T,khp,dh) (under a 'model'
    split, this rank's q heads and the KV heads they read); apply rope if
    given as (cos_q, sin_q, cos_k, sin_k). kv_x: the source of k/v
    (cross-attention reads the encoder's states); by default x."""
    lo = layout_from_cfg(cfg)
    b, s, _ = x.shape
    src = x if kv_x is None else kv_x
    t = src.shape[1]
    tp, rh = attn_split(p, cfg)
    if tp is None:
        wk, wv = p["wk"], p["wv"]
        nq, nkv = lo.hp, lo.khp
    else:
        x = policy.copy_to_tp(x, tp)
        src = x if kv_x is None else policy.copy_to_tp(src, tp)
        wk, wv = (_rank_kv(p[n], lo, rh, cfg, tp) for n in ("wk", "wv"))
        nq, nkv = rh.hq, rh.hkv
    q, k, v = x @ p["wq"], src @ wk, src @ wv
    if "bq" in p:
        bk, bv = ((p["bk"], p["bv"]) if tp is None else
                  (_rank_kv(p[n], lo, rh, cfg, tp) for n in ("bk", "bv")))
        q, k, v = q + p["bq"], k + bk, v + bv
    q = q.reshape(b, s, nq, cfg.head_dim)
    k = k.reshape(b, t, nkv, cfg.head_dim)
    v = v.reshape(b, t, nkv, cfg.head_dim)
    if rope is not None:
        cos_q, sin_q, cos_k, sin_k = rope
        q = apply_rope(q, cos_q, sin_q)
        k = apply_rope(k, cos_k, sin_k)
    return q, k, v


def gqa_q(p, x, cfg):
    """q alone (B,S,hp,dh), or under a 'model' split this rank's q heads:
    the decode cross-attention's projection, its k/v read from a
    cache."""
    tp, rh = attn_split(p, cfg)
    if tp is not None:
        x = policy.copy_to_tp(x, tp)
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    return q.reshape(*x.shape[:2], -1, cfg.head_dim)


def repeat_kv(k, gp: int):
    """(B,T,khp,dh) -> (B,T,khp*gp,dh), each KV head repeated gp times."""
    if gp == 1:
        return k
    b, t, kh, dh = k.shape
    return k[:, :, :, None, :].expand(b, t, kh, gp, dh).reshape(
        b, t, kh * gp, dh)


def sdpa(q, k, v, *, causal: bool = False, k_valid=None, gp: int = 1):
    """GQA-grouped scaled-dot-product attention, plain.
    q (B,S,H,dh); k (B,T,KH,dh), v (B,T,KH,dv) with H = KH*gp -> (B,S,H,dv)
    (dv differs from dh under MLA). causal: query i sees keys 0..i, both
    counted from 0; k_valid (B,T) bool marks the cache entries that exist.
    q is regrouped to (B,S,KH,gp,dh); k/v are never repeated."""
    b, s, h, dh = q.shape
    kh, t = k.shape[2], k.shape[1]
    if h != kh * gp:
        raise ValueError(f"sdpa: {h} q heads vs {kh} kv heads x {gp}")
    qg = q.reshape(b, s, kh, gp, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32) \
        * dh ** -0.5
    neg = torch.finfo(torch.float32).min
    if causal:
        mask = (torch.arange(s, device=q.device)[:, None]
                < torch.arange(t, device=q.device)[None, :])
        scores = scores.masked_fill(mask[None, None, None], neg)
    if k_valid is not None:
        scores = scores.masked_fill(~k_valid[:, None, None, None, :], neg)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgst,btkd->bskgd", probs.to(q.dtype), v)
    return ctx.reshape(b, s, h, v.shape[-1])


def sdpa_partial(q, k, v, *, k_valid=None, gp: int = 1):
    """``sdpa`` (not causal) over one block of the keys, unnormalised:
    (o, m, l) with m (B,S,H) the max of the block's valid scores (-inf
    where it has none), l (B,S,H) the sum of their exponentials less m,
    and o (B,S,H,dv) f32 the block's softmax output times l (0 where the
    block has no valid key). The block's probabilities meet v in q's
    dtype, as ``sdpa``'s do."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    if h != kh * gp:
        raise ValueError(f"sdpa_partial: {h} q heads vs {kh} kv heads x "
                         f"{gp}")
    qg = q.reshape(b, s, kh, gp, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32) \
        * dh ** -0.5
    if k_valid is not None:
        scores = scores.masked_fill(~k_valid[:, None, None, None, :],
                                    float("-inf"))
    m, p, l = _partial_softmax(scores)
    ctx = torch.einsum("bkgst,btkd->bskgd", p.to(q.dtype), v)
    perm = (0, 3, 1, 2)           # (B,KH,gp,S) -> (B,S,KH,gp)
    m, l = (x.permute(perm).reshape(b, s, h) for x in (m, l))
    return ctx.reshape(b, s, h, v.shape[-1]).to(torch.float32) \
        * l[..., None], m, l


def _partial_softmax(scores):
    """(m, p, l) of f32 scores (..., T) with -inf at invalid keys: their
    max, the block's softmax (0 where no key is valid) and the sum of
    exponentials less m."""
    m = scores.amax(-1)
    e = torch.exp(scores - torch.where(torch.isinf(m), 0.0, m)[..., None])
    l = e.sum(-1)
    return m, e / torch.where(l > 0, l, 1.0)[..., None], l


def combine_partials(o, m, l, dp):
    """The 'data' ranks' partials (``sdpa_partial``'s o, m, l) joined:
    ``sum o_r exp(m_r - m*) / sum l_r exp(m_r - m*)``, m* the max of the
    m_r (``policy.max_dp``); the numerators and denominators go in one
    ``policy.sum_dp``. -> f32 (B,S,H,dv)."""
    w = torch.exp(m - policy.max_dp(m, dp))
    ol = policy.sum_dp(torch.cat([o * w[..., None], (l * w)[..., None]], -1),
                       dp)
    return ol[..., :-1] / ol[..., -1:]


def valid_keys(t: int, pos, start=None):
    """(B, T) bool: the cache positions up to ``pos`` (B,), counted from
    ``start`` (a block's first position; None or 0: the sequence's)."""
    kpos = torch.arange(t, device=pos.device)
    if start:
        kpos = kpos + start
    return kpos[None] <= pos[:, None]


def cache_attention(q, k, v, *, gp: int = 1, pos=None, start=None):
    """Decode attention of q (B,1,H,dh) over a cache's k/v (B,T,KH,dh):
    the keys at positions up to ``pos`` (B,) valid (all with ``pos``
    None: the cross cache). ``start`` None: ``sdpa`` over the whole
    sequence; else the cache is this rank's block from position ``start``
    in a context-parallel decode step, and the ranks' partials are
    combined over ``policy.ctx_dp``."""
    k_valid = None if pos is None else valid_keys(k.shape[1], pos, start)
    if start is None:
        return sdpa(q, k, v, causal=False, k_valid=k_valid, gp=gp)
    o, m, l = sdpa_partial(q, k, v, k_valid=k_valid, gp=gp)
    return combine_partials(o, m, l, policy.ctx_dp()).to(q.dtype)


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
    """Mask padded heads (exact-zero contribution), then w_o (under a
    'model' split, this rank's rows of it and the sum over the ranks)."""
    lo = layout_from_cfg(cfg)
    b, s, h = ctx.shape[:3]
    tp, rh = attn_split(p, cfg)
    if lo.hp != lo.n_q:
        mask = lo.q_mask(ctx.device)
        if tp is not None:
            mask = mask[rh.q0:rh.q0 + rh.hq]
        ctx = ctx * mask[None, None, :, None].to(ctx.dtype)
    out = ctx.reshape(b, s, h * cfg.head_dim) @ p["wo"]
    return out if tp is None else policy.reduce_from_tp(out, tp)


# ------------------------------------------------------------------ MLA ----
def init_mla(gen, cfg, *, device):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    dt = pdtype(cfg)

    def dense(shape):
        return dense_init(gen, shape, 0, dt, device=device)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=device)

    return {"w_dq": dense((d, m.q_lora_rank)),
            "q_norm": ones(m.q_lora_rank),
            "w_uq": dense((m.q_lora_rank, h * qk)),
            "w_dkv": dense((d, m.kv_lora_rank + m.qk_rope_head_dim)),
            "kv_norm": ones(m.kv_lora_rank),
            "w_uk": dense((m.kv_lora_rank, h * m.qk_nope_head_dim)),
            "w_uv": dense((m.kv_lora_rank, h * m.v_head_dim)),
            "wo": dense((h * m.v_head_dim, d))}


def mla_split(p, cfg):
    """(the ambient 'model' axis, this rank's head count) when ``p``'s
    ``w_uq`` holds a share of the heads, else (None, ``cfg.n_heads``):
    the block runs whole. ValueError where the policy splits the columns
    but not at a head's edge."""
    tp = policy.ctx_tp()
    h = cfg.n_heads
    if tp is None or p["w_uq"].shape[-1] == h * (
            cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim):
        return None, h
    if h % tp.size:
        raise ValueError(f"MLA: {h} heads do not split over {tp.size} "
                         f"'model' ranks")
    return tp, h // tp.size


def _to_heads(x, tp):
    """``x``, whole on every rank, entering this rank's heads."""
    return x if tp is None else policy.copy_to_tp(x, tp)


def mla_q(p, x, cfg, cos, sin):
    """-> q_nope (B,S,H,nope), q_rope (B,S,H,rope) (H: this rank's heads
    under a 'model' split)."""
    m = cfg.mla
    tp, h = mla_split(p, cfg)
    b, s, _ = x.shape
    cq = rmsnorm_vec(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = (_to_heads(cq, tp) @ p["w_uq"]).reshape(
        b, s, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    return (q[..., :m.qk_nope_head_dim],
            apply_rope(q[..., m.qk_nope_head_dim:], cos, sin))


def mla_latent_kv(p, x, cfg, cos, sin):
    """-> c_kv (B,S,r) normalized latent, k_rope (B,S,rope) (one shared
    head, rope applied). This pair is the KV cache: r + rope numbers a
    token instead of 2*H*head_dim."""
    m = cfg.mla
    ckr = x @ p["w_dkv"]
    c_kv = rmsnorm_vec(ckr[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(ckr[:, :, None, m.kv_lora_rank:], cos, sin)[:, :, 0]
    return c_kv, k_rope


def _mla_out(p, ctx, tp):
    """``wo`` (this rank's rows of it, and the sum over the ranks)."""
    out = ctx @ p["wo"]
    return out if tp is None else policy.reduce_from_tp(out, tp)


def mla_attention_full(p, x, cfg, cos, sin):
    """Prefill/forward: per-head K,V rebuilt from the latent, then plain
    causal ``sdpa`` (q/k heads of nope + rope, v heads of v_head_dim).
    -> (out (B,S,d), (c_kv, k_rope))."""
    m = cfg.mla
    tp, h = mla_split(p, cfg)
    b, s, _ = x.shape
    q_nope, q_rope = mla_q(p, x, cfg, cos, sin)
    c_kv, k_rope = mla_latent_kv(p, x, cfg, cos, sin)
    c_in, r_in = _to_heads(c_kv, tp), _to_heads(k_rope, tp)
    k_nope = (c_in @ p["w_uk"]).reshape(b, s, h, m.qk_nope_head_dim)
    v = (c_in @ p["w_uv"]).reshape(b, s, h, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, r_in[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim)], -1)
    ctx = sdpa(q, k, v, causal=True)
    out = _mla_out(p, ctx.reshape(b, s, h * m.v_head_dim), tp)
    return out, (c_kv, k_rope)


def mla_attention_decode(p, x, cfg, cos, sin, c_kv_cache, k_rope_cache,
                         k_valid, dp=None):
    """Absorbed decode: scores and aggregation in the latent space, W_UK
    folded into q and W_UV applied after, O(T * (r + rope)) a head instead
    of rebuilding K/V. x (B,1,d); c_kv_cache (B,T,r), k_rope_cache
    (B,T,rope), the current token already written; k_valid (B,T). Under a
    'model' split the rank folds its own heads' ``w_uk``/``w_uv`` over the
    whole latent cache. ``dp`` (``policy.ctx_dp``): the caches are this
    rank's blocks of the sequence (k_valid by global position), and the
    ranks' latent partials are combined over 'data' before ``w_uv``."""
    m = cfg.mla
    tp, h = mla_split(p, cfg)
    b = x.shape[0]
    q_nope, q_rope = mla_q(p, x, cfg, cos, sin)           # (B,1,H,*)
    c_kv_cache, k_rope_cache = (_to_heads(c_kv_cache, tp),
                                _to_heads(k_rope_cache, tp))
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)  # absorb W_UK
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    scores = (torch.einsum("bshr,btr->bhst", q_lat, c_kv_cache)
              + torch.einsum("bshn,btn->bhst", q_rope, k_rope_cache))
    scores = scores.to(torch.float32) * scale
    if dp is None:
        scores = scores.masked_fill(~k_valid[:, None, None, :],
                                    torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx_lat = torch.einsum("bhst,btr->bshr", probs, c_kv_cache)
    else:
        mx, probs, l = _partial_softmax(scores.masked_fill(
            ~k_valid[:, None, None, :], float("-inf")))
        mx, l = mx.transpose(1, 2), l.transpose(1, 2)      # (B,S,H)
        o = torch.einsum("bhst,btr->bshr", probs.to(x.dtype),
                         c_kv_cache).to(torch.float32) * l[..., None]
        ctx_lat = combine_partials(o, mx, l, dp).to(x.dtype)
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    ctx = torch.einsum("bshr,rhv->bshv", ctx_lat, w_uv)   # absorb W_UV
    return _mla_out(p, ctx.reshape(b, 1, h * m.v_head_dim), tp)
