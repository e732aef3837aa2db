"""Optimizers + LR schedules on nested dict/list trees of tensors (the
parameter trees of ``models/cnn``), a port of the reference's own
implementation.

State trees mirror the params tree leaf for leaf; m, v and momentum stay
float32. ``update`` is functional: it returns new tensors and leaves its
arguments as they were. The step counter is an int32 scalar on the host,
so the f32 bias corrections (``bias_correction``) and a schedule's
learning rate are computed there and reach the ``torch._foreach_*``
passes (one multi-tensor launch per pass on a card) as f32 scalars.
``adamw_step_`` is AdamW's arithmetic in place on lists of tensors; it
also takes its bias corrections as 0-d device tensors, so that a
training step can be captured in a CUDA graph (core/pipeline.fit_cnn).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (new_params, new_state, info)


def tree_leaves_with_path(tree, is_leaf=None, path=()) -> list:
    """[(path, leaf)] of a nested dict/list/tuple tree in the reference's
    order: dict keys sorted, as JAX flattens them, then sequence indices
    (``path`` holds the keys and indices). None is an empty subtree, as in
    JAX; ``is_leaf(x)`` true makes ``x`` a leaf whatever its type."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_leaves_with_path(tree[k], is_leaf, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in tree_leaves_with_path(v, is_leaf, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree, is_leaf=None) -> list:
    """``tree_leaves_with_path``'s leaves."""
    return [x for _, x in tree_leaves_with_path(tree, is_leaf)]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (tree_leaves order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def tree_map(fn, tree):
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def _f32(xs):
    return [x.to(torch.float32) for x in xs]


def _f32_scalar(x) -> float:
    """A host f32 value as a Python float (exact: a float holds every
    f32)."""
    return float(torch.as_tensor(x, dtype=torch.float32))


def global_norm(tree) -> torch.Tensor:
    leaves = _f32(tree_leaves(tree))
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    leaves = tree_leaves(grads)
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    clipped = torch._foreach_mul(_f32(leaves), scale)
    return tree_unflatten(grads, [c.to(g.dtype) for c, g in
                                  zip(clipped, leaves)]), norm


def bias_correction(b: float, count) -> float:
    """1 - b ** count, in f32 from the step count (as the reference)."""
    return _f32_scalar(1.0 - torch.tensor(b, dtype=torch.float32)
                       ** torch.as_tensor(count).to(torch.float32))


def adamw_step_(params, grads, m, v, *, c1, c2, lr, b1=0.9, b2=0.95,
                eps=1e-8, weight_decay=0.0) -> None:
    """One AdamW step on lists of f32 tensors, updating ``params``, ``m``
    and ``v`` in place. ``c1``/``c2`` (the bias corrections) and ``lr``
    are floats or 0-d tensors on the params' device. Weight decay joins
    the step before lr scales it, as in the reference."""
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
    gg = torch._foreach_mul(grads, 1 - b2)
    torch._foreach_mul_(gg, grads)
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, gg)
    den = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    step = torch._foreach_div(m, c1)
    torch._foreach_div_(step, den)
    if weight_decay:
        torch._foreach_add_(step, torch._foreach_mul(params, weight_decay))
    torch._foreach_mul_(step, lr)
    torch._foreach_sub_(params, step)


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
          grad_clip: float | None = 1.0) -> Optimizer:
    """lr: float or schedule fn(step)->float. m/v kept in float32."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        return {"m": zeros, "v": tree_map(torch.clone, zeros),
                "count": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params):
        gnorm = None
        if grad_clip is not None:
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
        count = state["count"] + 1
        step_lr = _f32_scalar(lr_fn(count))
        p_leaves = tree_leaves(params)
        new_p = [p.to(torch.float32, copy=True) for p in p_leaves]
        m = [t.clone() for t in tree_leaves(state["m"])]
        v = [t.clone() for t in tree_leaves(state["v"])]
        adamw_step_(new_p, _f32(tree_leaves(grads)), m, v,
                    c1=bias_correction(b1, count),
                    c2=bias_correction(b2, count), lr=step_lr, b1=b1, b2=b2,
                    eps=eps, weight_decay=weight_decay)
        new_params = tree_unflatten(params, [n.to(p.dtype) for n, p in
                                             zip(new_p, p_leaves)])
        new_state = {"m": tree_unflatten(params, m),
                     "v": tree_unflatten(params, v), "count": count}
        return new_params, new_state, {"grad_norm": gnorm, "lr": step_lr}

    return Optimizer(init, update)


def sgd(lr, momentum=0.9) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"mu": tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params),
            "count": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        step_lr = _f32_scalar(lr_fn(count))
        p_leaves = tree_leaves(params)
        mu = torch._foreach_mul(tree_leaves(state["mu"]), momentum)
        torch._foreach_add_(mu, _f32(tree_leaves(grads)))
        new_p = torch._foreach_sub(_f32(p_leaves),
                                   torch._foreach_mul(mu, step_lr))
        return (tree_unflatten(params, [n.to(p.dtype) for n, p in
                                        zip(new_p, p_leaves)]),
                {"mu": tree_unflatten(params, mu), "count": count}, {})

    return Optimizer(init, update)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine
    decay to ``floor_frac * peak`` at ``total``; f32 like the reference."""
    def fn(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = peak * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac)
                      * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return fn
