"""Whisper-style encoder-decoder (the audio family), ported from the
reference's ``models/encdec.py``.

The conv/mel frontend is a stub, as in the reference: the caller passes
precomputed frame embeddings ``enc_frames`` (B, n_frames, d_model). The
encoder is bidirectional; the decoder is causal, with per-layer
cross-attention whose K/V come once from the encoder's output and are
cached for decode. Positions: sinusoidal (encoder), learned (decoder); no
RoPE.

On the full-sequence path (``forward``, ``prefill``) the encoder's
self-attention (not causal), the decoder's self-attention (causal) and
the cross-attention (not causal, S queries against the encoder's T
frames) go through the ``flash_attention`` kernel wrapper on the model's
(B,S,H,D).transpose(1, 2) views (``transformer.full_attention``). Decode
keeps the plain ``sdpa`` over the self cache and the cross cache, as the
reference does, and writes the new token's k/v into the self cache in
place. ``forward(remat_policy=)`` checkpoints each encoder and decoder
layer under any policy but "none", as the reference's ``jax.checkpoint``
around both layer scans ("dots" too is a full checkpoint there); its
default is "none", as ``models/transformer``'s says why.

Tensor parallelism, as in ``models/transformer``: under a step's mesh
context on a 'model' axis of more than 1 the encoder's and the decoder's
self- and cross-attention compute the rank's q heads and the KV heads
they read (``attention.gqa_qkv``/``gqa_q``/``gqa_out``; the grouping is
read from the shapes, q heads over KV heads), the MLPs the rank's share
of ``d_ff``, the tied embedding its vocab rows; ``dec_pos`` and the
sinusoidal table are replicated, and the serving logits are made whole
(``common.whole_logits``). The cross cache holds the rank's KV heads,
as the self cache does (``serve/kvcache.init_cache``).

Context-parallel decode, as in ``models/transformer``: in a decode step
whose batch does not split over the data-parallel axes the self cache is
this rank's block of the sequence, and the cross cache this rank's block
of the frames where the 'data' ranks divide them; each attention then
combines the ranks' partial softmaxes (``attention.cache_attention``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ffn
from repro_torch.models.common import (
    DTYPES, apply_norm, embed_init, embed_tokens, init_embedding, init_norm,
    lm_logits, pdtype, sinusoidal_positions, whole_logits)
from repro_torch.models.transformer import (_cache_start, _gathered,
                                           _layers, _remat, _stack,
                                           full_attention, gather_outside,
                                           init_stack)
from repro_torch.serve import kvcache

STACKS = ("enc_layers", "dec_layers")


def _init_enc_layer(gen, cfg, *, device):
    return {"ln1": init_norm(cfg, device=device),
            "attn": attn.init_gqa(gen, cfg, device=device),
            "ln2": init_norm(cfg, device=device),
            "mlp": ffn.init_mlp(gen, cfg, device=device)}


def _init_dec_layer(gen, cfg, *, device):
    return {"ln1": init_norm(cfg, device=device),
            "self_attn": attn.init_gqa(gen, cfg, device=device),
            "ln_x": init_norm(cfg, device=device),
            "cross_attn": attn.init_gqa(gen, cfg, device=device),
            "ln2": init_norm(cfg, device=device),
            "mlp": ffn.init_mlp(gen, cfg, device=device)}


def init_encdec(gen, cfg, *, device=None):
    """Random weights with the reference's tree, shapes and scales, drawn
    from ``gen``. Runs on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    return {
        "embed": init_embedding(gen, cfg, device=dev),
        "dec_pos": embed_init(gen, (cfg.max_seq_len, cfg.d_model),
                              pdtype(cfg), device=dev),
        "enc_layers": init_stack(
            lambda: _init_enc_layer(gen, cfg, device=dev),
            cfg.encoder.n_layers),
        "enc_norm": init_norm(cfg, device=dev),
        "dec_layers": init_stack(
            lambda: _init_dec_layer(gen, cfg, device=dev), cfg.n_layers),
        "final_norm": init_norm(cfg, device=dev),
    }


@functools.lru_cache(maxsize=8)
def _enc_positions(n_pos: int, d_model: int, device, dtype):
    """The encoder's sinusoidal table, built once per (shape, device,
    dtype): a constant, as it is under the reference's jit."""
    return sinusoidal_positions(n_pos, d_model, device=device).to(dtype)


def _enc_layer(lp, h, cfg):
    q, k, v = attn.gqa_qkv(lp["attn"], apply_norm(lp["ln1"], h, cfg), cfg)
    h = h + attn.gqa_out(lp["attn"], full_attention(
        q, k, v, q.shape[2] // k.shape[2], causal=False), cfg)
    return h + ffn.apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg), cfg)


def encode(params, enc_frames, cfg, remat_policy="none"):
    h = enc_frames.to(pdtype(cfg))
    h = h + _enc_positions(h.shape[1], cfg.d_model, h.device, h.dtype)
    layer = _remat(_gathered(_enc_layer, ("enc_layers",)),
                   "none" if remat_policy == "none" else "full")
    for i, lp in enumerate(_layers(params["enc_layers"],
                                   cfg.encoder.n_layers)):
        h = layer(i, lp, h, cfg)
    return apply_norm(params["enc_norm"], h, cfg)


def _dec_block(lp, h, enc_out, cfg, *, self_cache=None, cross_kv=None,
               pos=None, collect=False):
    """One decoder block. self_cache given => decode (S==1), with the
    cross-attention's cached (k, v) in ``cross_kv``. Returns (h, collected
    self k/v, collected cross k/v, updated self cache slice)."""
    ain = apply_norm(lp["ln1"], h, cfg)
    q, k, v = attn.gqa_qkv(lp["self_attn"], ain, cfg)
    gp = q.shape[2] // k.shape[2]     # q heads a KV head (this rank's)
    new_self = collected = None
    if self_cache is not None:
        start = _cache_start(self_cache["k"])
        new_self = kvcache.write_kv_layer(self_cache, k, v, pos, start)
        kf, vf = kvcache.read_kv_layer(new_self, h.dtype)
        ctx = attn.cache_attention(q, kf, vf, gp=gp, pos=pos, start=start)
    else:
        ctx = full_attention(q, k, v, gp, causal=True)
        if collect:
            collected = {"k": k, "v": v}
    h = h + attn.gqa_out(lp["self_attn"], ctx, cfg)

    xin = apply_norm(lp["ln_x"], h, cfg)
    if cross_kv is not None:
        kx, vx = cross_kv
        qx = attn.gqa_q(lp["cross_attn"], xin, cfg)
        ctx_x = attn.cache_attention(
            qx, kx, vx, gp=qx.shape[2] // kx.shape[2],
            start=_cache_start(kx, cfg.encoder.n_frames))
    else:
        qx, kx, vx = attn.gqa_qkv(lp["cross_attn"], xin, cfg, kv_x=enc_out)
        ctx_x = full_attention(qx, kx, vx, qx.shape[2] // kx.shape[2],
                               causal=False)
    h = h + attn.gqa_out(lp["cross_attn"], ctx_x, cfg)

    h = h + ffn.apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg), cfg)
    cross_coll = ({"k": kx, "v": vx} if collect and cross_kv is None
                  else None)
    return h, collected, cross_coll, new_self


def forward(params, batch, cfg, *, remat_policy="none", collect_cache=False,
            logits_last_only=False, **_):
    """batch: "tokens" (B,S), "enc_frames" (B,T,d). Returns (logits, aux
    (0), {"self": k/v, "cross": k/v} stacked over layers | None). In a
    ZeRO step the layers gather their shards as ``transformer.forward``'s
    do, and the leaves outside both stacks are gathered first."""
    params = gather_outside(params, STACKS)
    enc_out = encode(params, batch["enc_frames"], cfg, remat_policy)
    tokens = batch["tokens"]
    h = embed_tokens(params["embed"], tokens, cfg).to(pdtype(cfg))
    h = h + params["dec_pos"][None, :tokens.shape[1]]
    block = _remat(_gathered(_dec_block, ("dec_layers",)),
                   "none" if remat_policy == "none" else "full")
    selfs, crosses = [], []
    for i, lp in enumerate(_layers(params["dec_layers"], cfg.n_layers)):
        h, coll, cross, _ = block(i, lp, h, enc_out, cfg,
                                  collect=collect_cache)
        selfs.append(coll)
        crosses.append(cross)
    if logits_last_only:
        h = h[:, -1:]
    h = apply_norm(params["final_norm"], h, cfg)
    logits = lm_logits(params, params["embed"], h, cfg)
    pieces = ({"self": _stack(selfs), "cross": _stack(crosses)}
              if collect_cache else None)
    return logits, torch.zeros((), device=h.device), pieces


def prefill(params, batch, cfg, *, kv_dtype="bfloat16", last_only=False,
            **_):
    """Returns (last-token logits (B,Vp), decode-ready cache): the self
    and cross k/v in ``kv_dtype`` (bf16 when it is int8, as in the
    reference)."""
    logits, _, pieces = forward(params, batch, cfg, collect_cache=True,
                                logits_last_only=last_only)
    b, s = batch["tokens"].shape
    cache_dt = torch.bfloat16 if kv_dtype == "int8" else DTYPES[kv_dtype]
    cache = {"pos": torch.full((b,), s, dtype=torch.int32,
                               device=logits.device)}
    for name in ("self", "cross"):
        cache[name] = {k: v.to(cache_dt) for k, v in pieces[name].items()}
    return whole_logits(logits[:, -1], cfg), cache


def decode_step(params, cache, batch, cfg, **_):
    """One token: batch["tokens"] (B,1). Returns (logits (B,Vp), cache);
    the self cache is updated in place."""
    params = gather_outside(params, STACKS)
    tokens = batch["tokens"]
    pos = cache["pos"]
    h = embed_tokens(params["embed"], tokens, cfg).to(pdtype(cfg))
    h = h + params["dec_pos"][pos.long()][:, None]
    block = _gathered(_dec_block, ("dec_layers",))
    for i, (lp, sc, cc) in enumerate(zip(*(_layers(t, cfg.n_layers) for t in (
            params["dec_layers"], cache["self"], cache["cross"])))):
        cross = kvcache.read_kv_layer(cc, h.dtype)
        h, _, _, _ = block(i, lp, h, None, cfg, self_cache=sc,
                           cross_kv=cross, pos=pos)
    h = apply_norm(params["final_norm"], h, cfg)
    logits = lm_logits(params, params["embed"], h, cfg)
    cache["pos"] = pos + 1
    return whole_logits(logits[:, -1], cfg), cache
