"""Decoder-only model assembly for the ``dense`` (GQA/MQA attention +
MLP), ``moe`` (attention or MLA + Mixture-of-Experts), ``vlm`` (qwen2-vl's
backbone: GQA with M-RoPE, patch embeddings replacing the prompt's
prefix), ``ssm`` and ``hybrid`` (zamba2) families, ported from the
reference's ``models/transformer.py``. The audio family (whisper) is
``models/encdec``.

Parameters are plain dicts of tensors with the reference's tree and leaf
names, the per-layer leaves stacked on a leading ``(L, ...)`` axis; the
layer loop is a Python loop over that axis. The hybrid family runs
[k SSM layers -> the ONE shared attention+MLP block] segments.

Three entry points, shared by serving and the tests:
  forward(params, batch)          -> (logits (B,S,Vp), aux, cache pieces)
  prefill(params, batch)          -> (last logits (B,Vp), cache)
  decode_step(params, cache, tok) -> (logits (B,Vp), cache)
``batch`` holds "tokens" (B,S), and for the vlm family optionally
"vision_embeds" (B,P,d) and "mrope_positions" (3,B,S) (at decode (3,B,1)).
``aux`` is the MoE layers' summed load-balance loss (0 without MoE).

On the full-sequence path the SSD runs through the ``ssd_scan`` kernel
wrapper and every GQA attention block's causal attention (the dense, moe
and vlm families' layers, the hybrid's shared block) through the
``flash_attention`` kernel wrapper; decode keeps the plain recurrences
(``ssd_decode``, ``sdpa`` over the cache), as the reference does. MLA's
attention stays plain on both paths (``attention.mla_attention_full``
says why). ``decode_step`` writes the new token's state into ``cache`` in
place.

Training options, as the reference's ``forward`` takes them:
``remat_policy`` ("none", "full" or "dots"; ``_remat``) checkpoints each
layer's body, as the reference's ``jax.checkpoint`` around its layer scan
(the hybrid's shared block is not checkpointed, there as here), and
``moe_groups`` reaches ``ffn.apply_moe(n_groups=)`` (the reference's step
builders set it to the data-parallel size; the port's give each
data-parallel rank its one group of those). The port's default is
"none", where the reference's is "full": serving and the tests call
``forward`` with no option, and a checkpoint there would only cost time
(under autograd, each kernel of a checkpointed layer launches twice: once
in the forward and once when the backward recomputes it).

Tensor parallelism: under a step's mesh context on a 'model' axis of
more than 1 (``sharding.policy.use_ctx_mesh``; ``launch/steps`` enters
it), each leaf of ``params`` is this rank's 'model' shard and the blocks
compute their share: the vocab rows of the embedding and the head
(vocab-parallel logits, made whole for serving by
``common.whole_logits``), the q heads and the KV heads they read, or
MLA's heads over the whole latent (``attention``), ``d_ff``
(``ffn.apply_mlp``), the experts (``ffn.apply_moe``: every rank routes
all tokens, runs its own experts, and the ranks' outputs are summed)
and the SSM heads (``ssm.apply_ssm``); zamba2's shared block and the
vlm's M-RoPE path ride on the same dense block, and ``init_cache`` holds
the rank's heads. Without the context the code dispatches no collective
and no extra op: the reference's sharding hints (``ctx_constrain``)
steer XLA's SPMD partitioner; here model code calls the collectives.

Context parallelism: in a decode step whose batch does not split over
the data-parallel axes (``policy.ctx_dp``), each cache leaf with a
sequence axis is this rank's block of it (``_cache_start``): the new
token is written only in the block that holds its position
(``kvcache.write_rows``), and GQA's and MLA's decode attention (the
hybrid's shared block too) combine the 'data' ranks' partial softmaxes
(``attention.cache_attention``, ``attention.mla_attention_decode``).

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
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as attn
from repro_torch.models import ffn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    DTYPES, apply_norm, embed_tokens, init_embedding, init_lm_head,
    init_norm, lm_logits, mrope_for_heads, pdtype, rope_for_heads,
    whole_logits)
from repro_torch.serve import kvcache
from repro_torch.sharding import policy

ATTN_FAMILIES = ("dense", "moe", "vlm")
FAMILIES = ATTN_FAMILIES + ("ssm", "hybrid")


def check_family(cfg) -> None:
    """A decoder family, or ValueError (as the reference's
    ``init_decoder`` raises for a family it does not know)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                         f"decoder family {FAMILIES}")


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


def _layers(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, each a tree of views (writes
    reach the stacked tensors), from one ``torch.unbind`` a leaf. Under
    autograd the stacked leaf's gradient is then one stack of the layers'
    gradients, where ``x[i]`` a layer would add each layer's into a zero
    tensor of the whole stack (n stack-sized fills and adds a
    backward)."""
    per_leaf = _tree_map(lambda x: torch.unbind(x, 0), tree)
    return [_tree_map(lambda xs: xs[i], per_leaf) for i in range(n)]


def _put(stack, i, tree):
    """Leaf-wise ``stack[i] = tree``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put(stack[k], i, v)
    else:
        stack[i].copy_(tree)


def init_stack(init_one, n: int):
    """``n`` layers from ``init_one()``, drawn one after another (the draw
    order of a list of layers) into preallocated (n, ...) leaves: the peak
    holds the stack and one layer, where stacking a list of layers would
    hold every layer twice (phi3.5-moe's 16 layers are 42 GB in bf16)."""
    out = None
    for i in range(n):
        layer = init_one()
        if out is None:
            out = _tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)),
                            layer)
        _put(out, i, layer)
        del layer          # freed before the next layer's draw
    return out


# ------------------------------------------------------------------- init --
def _init_dense_layer(gen, cfg, *, device):
    p = {"ln1": init_norm(cfg, device=device),
         "ln2": init_norm(cfg, device=device)}
    p["attn"] = (attn.init_mla(gen, cfg, device=device) if cfg.mla is not None
                 else attn.init_gqa(gen, cfg, device=device))
    if cfg.moe is not None:
        p["moe"] = ffn.init_moe(gen, cfg, device=device)
    else:
        p["mlp"] = ffn.init_mlp(gen, cfg, device=device)
    return p


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
    init_layer = (_init_dense_layer if cfg.family in ATTN_FAMILIES
                  else _init_ssm_layer)
    p["layers"] = init_stack(lambda: init_layer(gen, cfg, device=dev),
                             cfg.n_layers)
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
def _make_rope(cfg, positions, mrope_positions=None):
    """-> (cos, sin) shaped (B, S, 1, rot/2), or None (no attention, or
    absolute positions). rot is MLA's rope width or the head width; the
    vlm family takes M-RoPE angles when ``mrope_positions`` is given."""
    if not cfg.uses_attention or cfg.rope_theta == 0.0:
        return None
    rot = (cfg.mla.qk_rope_head_dim if cfg.mla is not None
           else cfg.head_dim)
    if cfg.vision is not None and mrope_positions is not None:
        return mrope_for_heads(mrope_positions, rot, cfg.rope_theta,
                               cfg.vision.mrope_sections)
    return rope_for_heads(positions, rot, cfg.rope_theta)


def full_attention(q, k, v, gp: int, *, causal: bool):
    """GQA attention over a full sequence through the ``flash_attention``
    kernel wrapper. q (B,S,H,D), k/v (B,T,KH,D), H = KH*gp -> (B,S,H,D).
    The kernel takes (B,H,S,D) with the KV heads repeated, at any strides
    with a contiguous last dimension: the transposed views of the model's
    (B,S,H,D) tensors go in as they are, and the output comes back in q's
    layout, so transposing it back is a contiguous (B,S,H,D) tensor. No
    copy either way."""
    return flash_attention(
        q.transpose(1, 2), attn.repeat_kv(k, gp).transpose(1, 2),
        attn.repeat_kv(v, gp).transpose(1, 2), causal=causal
    ).transpose(1, 2)


def _dense_block(lp, h, cfg, rope, *, moe_groups=1, dp_mean=None,
                 cache_slice=None, pos=None):
    """One attention (GQA or MLA) + MLP (dense or MoE) block.
    cache_slice given => decode (S==1). Returns (h, aux, collected cache
    pieces of a full pass, updated cache slice); aux is the MoE's
    load-balance loss, None for a dense MLP (so a dense block launches
    nothing for it).

    GQA's full-sequence attention goes through the flash kernel
    (``full_attention``), its decode through ``sdpa`` over the cache. MLA
    runs plain on both paths, on the card too: its q/k heads are 192 wide
    at deepseek-v2 (128 nope + 64 rope) and its v heads 128, and the
    kernel, as the reference's Pallas kernel, takes one head width for q,
    k and v; the reference computes MLA's attention with plain ``sdpa``
    as well. Decode is the absorbed form over the latent cache."""
    cos, sin = rope if rope is not None else (None, None)
    ain = apply_norm(lp["ln1"], h, cfg)
    collected = new_cache = None
    if cfg.mla is not None:
        if cache_slice is not None:
            c_kv_new, k_rope_new = attn.mla_latent_kv(lp["attn"], ain, cfg,
                                                      cos, sin)
            c_kv, k_rope = cache_slice["c_kv"], cache_slice["k_rope"]
            start = _cache_start(c_kv)
            kvcache.write_rows([(c_kv, c_kv_new[:, 0].to(c_kv.dtype)),
                                (k_rope, k_rope_new[:, 0].to(k_rope.dtype))],
                               pos, start)
            aout = attn.mla_attention_decode(
                lp["attn"], ain, cfg, cos, sin, c_kv.to(h.dtype),
                k_rope.to(h.dtype), attn.valid_keys(c_kv.shape[1], pos, start),
                dp=None if start is None else policy.ctx_dp())
            new_cache = cache_slice
        else:
            aout, (c_kv, k_rope) = attn.mla_attention_full(
                lp["attn"], ain, cfg, cos, sin)
            collected = {"c_kv": c_kv, "k_rope": k_rope}
    else:
        rope4 = None if cos is None else (cos, sin, cos, sin)
        q, k, v = attn.gqa_qkv(lp["attn"], ain, cfg, rope=rope4)
        gp = q.shape[2] // k.shape[2]     # q heads a KV head (this rank's)
        if cache_slice is not None:
            start = _cache_start(cache_slice["k"])
            new_cache = kvcache.write_kv_layer(cache_slice, k, v, pos, start)
            kf, vf = kvcache.read_kv_layer(new_cache, h.dtype)
            ctx = attn.cache_attention(q, kf, vf, gp=gp, pos=pos,
                                       start=start)
        else:
            ctx = full_attention(q, k, v, gp, causal=True)
            collected = {"k": k, "v": v}
        aout = attn.gqa_out(lp["attn"], ctx, cfg)
    h = h + aout
    fin = apply_norm(lp["ln2"], h, cfg)
    if cfg.moe is not None:
        mout, aux = ffn.apply_moe(lp["moe"], fin, cfg, moe_groups, dp_mean)
    else:
        mout, aux = ffn.apply_mlp(lp["mlp"], fin, cfg), None
    return h + mout, aux, collected, new_cache


def _cache_start(leaf, seq=None):
    """The first position of a decode cache leaf's (one layer's: B, T,
    ...) block in a context-parallel decode step, or None: the leaf holds
    the whole sequence. ``seq``: the leaf's whole length (default: the
    step's cache length). ValueError where the leaf is not the block the
    step gives this rank."""
    dp = policy.ctx_dp()
    if dp is None:
        return None
    seq = dp.seq_len if seq is None else seq
    start, t = kvcache.seq_block(seq)
    if leaf.shape[1] != t:
        raise ValueError(f"a decode cache of {leaf.shape[1]} positions on "
                         f"'data' rank {dp.rank} of {dp.size}, where "
                         f"{seq} give it {t}")
    return start


def _ssm_layer(lp, h, cfg, **kw):
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


# ------------------------------------------------------------------ remat --
_SAVED_BY_DOTS = tuple(
    op for op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                  torch.ops.aten.addmm.default,
                  *(getattr(torch.ops.aten, name).default for name in (
                      "_scaled_dot_product_flash_attention",
                      "_scaled_dot_product_efficient_attention",
                      "_scaled_dot_product_cudnn_attention",
                      "_scaled_dot_product_flash_attention_for_cpu")
                    if hasattr(torch.ops.aten, name))))


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the matrix products' outputs, recompute the rest: the
    counterpart of ``jax.checkpoint_policies.dots_with_no_batch_dims_
    saveable``."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(fn, policy: str):
    """``fn`` checkpointed as ``policy`` says: "none" as it is, "full"
    recomputed whole in the backward, "dots" recomputed but for its
    matrix products' outputs."""
    if policy == "none":
        return fn
    if policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {policy!r} is not none, full or "
                         f"dots")
    extra = {"context_fn": _dots_context} if policy == "dots" else {}
    return lambda *a, **kw: checkpoint(fn, *a, use_reentrant=False,
                                       **extra, **kw)


def _gathered(fn, path: tuple):
    """``fn`` on layer ``i`` of the stacks at ``path``: called as
    ``(i, the layer's shards, ...)``, it gathers the shards over the
    data-parallel axes first (``policy.zero_gather``; nothing outside a
    ZeRO step). Wrapped by ``_remat``, the gather is part of the
    checkpointed body: the backward's recompute gathers the layer again
    instead of keeping its weights."""
    def run(i, lp, *a, **kw):
        return fn(policy.zero_gather(lp, path, i), *a, **kw)
    return run


def gather_outside(params, stacks=("layers",)):
    """``params`` with every leaf outside the layer stacks ``stacks``
    gathered over the data-parallel axes (``policy.zero_gather``), once a
    call: the embedding, the head, the final norm, the hybrid's shared
    block. Autograd sums a leaf's uses (the shared block's passes, a
    tied head) before its one reduce-scatter."""
    return {k: v if k in stacks else policy.zero_gather(v, (k,))
            for k, v in params.items()}


# ---------------------------------------------------------------- forward --
def _embed_input(params, batch, cfg):
    h = embed_tokens(params["embed"], batch["tokens"], cfg).to(pdtype(cfg))
    ve = batch.get("vision_embeds")
    if ve is not None:   # the VLM stub: patch embeddings replace the prefix
        h = torch.cat([ve.to(h.dtype), h[:, ve.shape[1]:]], dim=1)
    return h


def forward(params, batch, cfg, *, remat_policy="none", moe_groups=1,
            dp_mean=None, collect_cache=False, logits_last_only=False):
    """Full-sequence pass. Returns (logits, aux, cache_pieces|None).
    remat_policy / moe_groups: the training options (module docstring);
    dp_mean: ``ffn.apply_moe``'s, for a data-parallel step.
    logits_last_only: the LM head on the final position only.

    In a ZeRO step (``policy.use_ctx_mesh(zero=)``) ``params`` are the
    rank's shards: each layer gathers its own inside its checkpointed
    body, and the leaves outside the stacks are gathered first
    (``gather_outside``). Under "none", autograd keeps every layer's
    gathered weights for the backward, so the rank holds them all, as it
    would hold them whole."""
    check_family(cfg)
    params = gather_outside(params)
    h = _embed_input(params, batch, cfg)
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    rope = _make_rope(cfg, positions, batch.get("mrope_positions"))
    aux = torch.zeros((), device=h.device)
    if cfg.family in ATTN_FAMILIES:
        pieces = []
        block = _remat(_gathered(_dense_block, ("layers",)), remat_policy)
        for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
            h, a, coll, _ = block(i, lp, h, cfg, rope, moe_groups=moe_groups,
                                  dp_mean=dp_mean)
            if a is not None:
                aux = aux + a
            if collect_cache:
                pieces.append(coll)
        cache_pieces = _stack(pieces) if collect_cache else None
    elif cfg.family == "ssm":
        states = []
        layer = _remat(_gathered(_ssm_layer, ("layers",)), remat_policy)
        for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
            h, st = layer(i, lp, h, cfg, collect_state=collect_cache)
            states.append(st)
        cache_pieces = _stack(states) if collect_cache else None
    else:
        h, cache_pieces = _hybrid_forward(params, h, cfg, rope,
                                          remat_policy=remat_policy,
                                          collect_cache=collect_cache)
    if logits_last_only:
        h = h[:, -1:]
    h = apply_norm(params["final_norm"], h, cfg)
    logits = lm_logits(params, params["embed"], h, cfg)
    return logits, aux, cache_pieces


def _hybrid_forward(params, h, cfg, rope, *, remat_policy, collect_cache):
    ssm_states, shared_kv = [], []
    layer = _remat(_gathered(_ssm_layer, ("layers",)), remat_policy)
    layers = _layers(params["layers"], cfg.n_layers)
    lo_i = 0
    for n, has_attn in hybrid_segments(cfg):
        for i in range(lo_i, lo_i + n):
            h, st = layer(i, layers[i], h, cfg, collect_state=collect_cache)
            ssm_states.append(st)
        lo_i += n
        if has_attn:
            h, _, coll, _ = _dense_block(params["shared"], h, cfg, rope)
            shared_kv.append(coll)
    if not collect_cache:
        return h, None
    return h, {"ssm": _stack(ssm_states),
               "shared": _stack(shared_kv) if shared_kv else None}


# ---------------------------------------------------------------- prefill --
def prefill(params, batch, cfg, *, kv_dtype="bfloat16", moe_groups=1,
            last_only=False):
    """Returns (last-token logits (B,Vp), decode-ready cache). The dense,
    moe and vlm families' k/v go to the cache in ``kv_dtype`` (int8 with
    per-(token, head) scales); as in the reference, MLA's latent cache and
    the hybrid's shared-attention k/v go in bf16 when ``kv_dtype`` is int8
    (int8 caches come from ``init_cache``). moe_groups: ``forward``'s.
    last_only: the LM head on the final position only."""
    logits, _, pieces = forward(params, batch, cfg, moe_groups=moe_groups,
                                collect_cache=True,
                                logits_last_only=last_only)
    b, s = batch["tokens"].shape
    cache: dict = {"pos": torch.full((b,), s, dtype=torch.int32,
                                     device=logits.device)}
    cache_dt = torch.bfloat16 if kv_dtype == "int8" else DTYPES[kv_dtype]
    if cfg.family in ATTN_FAMILIES:
        if cfg.mla is not None:
            cache["mla"] = {"c_kv": pieces["c_kv"].to(cache_dt),
                            "k_rope": pieces["k_rope"].to(cache_dt)}
        elif kv_dtype == "int8":
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
    return whole_logits(logits[:, -1], cfg), cache


# ----------------------------------------------------------------- decode --
def decode_step(params, cache, batch, cfg):
    """One token: batch["tokens"] (B,1) (and the vlm family's
    "mrope_positions" (3,B,1)). Returns (logits (B,Vp), cache); the cache
    is updated in place. In a ZeRO step each layer's shards are gathered
    as the layer runs (``forward`` says how)."""
    check_family(cfg)
    params = gather_outside(params)
    h = _embed_input(params, batch, cfg)
    pos = cache["pos"]                                  # (B,) write index
    rope = _make_rope(cfg, pos[:, None], batch.get("mrope_positions"))
    if cfg.family in ATTN_FAMILIES:
        name = "mla" if cfg.mla is not None else "kv"
        block = _gathered(_dense_block, ("layers",))
        for i, (lp, lc) in enumerate(zip(_layers(params["layers"],
                                                 cfg.n_layers),
                                         _layers(cache[name], cfg.n_layers))):
            h, _, _, _ = block(i, lp, h, cfg, rope, cache_slice=lc, pos=pos)
    else:
        h = _ssm_decode(params, h, cache, cfg, rope, pos)
    h = apply_norm(params["final_norm"], h, cfg)
    logits = lm_logits(params, params["embed"], h, cfg)
    cache["pos"] = pos + 1
    return whole_logits(logits[:, -1], cfg), cache


def _ssm_decode(params, h, cache, cfg, rope, pos):
    """The SSM stack's step (and the hybrid's shared block between its
    segments), writing each layer's state into ``cache`` in place."""
    lo_i = 0
    segs = (hybrid_segments(cfg) if cfg.family == "hybrid"
            else [(cfg.n_layers, False)])
    layers = _layers(params["layers"], cfg.n_layers)
    layer = _gathered(_ssm_layer, ("layers",))
    states = _layers(cache["ssm"], cfg.n_layers)
    passes = iter(_layers(cache["shared_attn"], sum(a for _, a in segs))
                  if cfg.family == "hybrid" else [])
    for n, has_attn in segs:
        for i in range(lo_i, lo_i + n):
            h, nc = layer(i, layers[i], h, cfg, cache=states[i])
            for name, val in nc.items():
                cache["ssm"][name][i] = val
        lo_i += n
        if has_attn:
            h, _, _, _ = _dense_block(params["shared"], h, cfg, rope,
                                      cache_slice=next(passes), pos=pos)
    return h
