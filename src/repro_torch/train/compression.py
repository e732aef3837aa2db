"""Gradient compression for the data-parallel reduction (DESIGN.md §6),
the port of the reference's ``train/compression.py``.

Two error-feedback compressors, composable in front of the optimizer, on
the port's dict/list trees (``train/optimizer.tree_map``):

* top-k sparsification with error feedback (Stich et al.): only the k
  largest-magnitude entries of (grad + residual) are transmitted; the
  untransmitted remainder becomes the next step's residual, so the scheme
  is contractive and unbiased-in-the-limit.
* int8 quantization with per-tensor scale + error feedback
  (``torch.round`` rounds half to even, as ``jnp.round``).

As in the reference, the compress->decompress round trip is applied in
the step, in front of the optimizer, so training quality effects and
compression ratios are measurable. ``torch.topk`` and ``jax.lax.top_k``
may keep different entries among equal magnitudes; elsewhere the two
agree.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.train.optimizer import (tree_leaves, tree_map,
                                         tree_unflatten)


class Compressor(NamedTuple):
    init: Callable      # params -> residual state
    apply: Callable     # (grads, state) -> (decompressed, state, stats)


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _apply_each(one, grads, state):
    out = [one(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(state))]
    return (tree_unflatten(grads, [d for d, _ in out]),
            tree_unflatten(grads, [r for _, r in out]))


def topk_compressor(k_frac: float = 0.01) -> Compressor:
    def one(g, r):
        gf = g.to(torch.float32) + r
        flat = gf.reshape(-1)
        k = max(1, int(flat.numel() * k_frac))
        idx = torch.topk(flat.abs(), k).indices
        sent = torch.zeros_like(flat).index_copy_(0, idx, flat[idx])
        return sent.reshape(gf.shape), (flat - sent).reshape(gf.shape)

    @torch.no_grad()
    def apply(grads, state):
        dec, res = _apply_each(one, grads, state)
        return dec, res, {"ratio": k_frac}

    return Compressor(_zeros_f32, apply)


def int8_compressor() -> Compressor:
    def one(g, r):
        gf = g.to(torch.float32) + r
        scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        dec = q.to(torch.float32) * scale
        return dec, gf - dec

    @torch.no_grad()
    def apply(grads, state):
        dec, res = _apply_each(one, grads, state)
        return dec, res, {"ratio": 0.25}

    return Compressor(_zeros_f32, apply)
