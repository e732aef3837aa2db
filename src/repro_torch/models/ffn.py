"""MLPs and Mixture-of-Experts, ported from the reference's
``models/ffn.py``.

Dense MLPs are gated (silu: w_gate, w_up, w_down) or not (w_in + b_in,
w_out + b_out). The MoE is the reference's GShard-style grouped capacity
routing: tokens are reshaped to (G, Tg, d) routing groups, each token goes
to its top-k experts, each expert takes its top-C tokens per group, C =
ceil(Tg*k/E * capacity_factor) (assignments over capacity are dropped),
and the expert weights are stacked (E, ...). ``apply_moe`` returns the
Switch-style load-balance aux loss beside the output.

What differs from the reference, and why:

* Ties. ``jax.lax.top_k`` puts the lower index first among equal values;
  the routing here sorts with a stable descending sort, so a tie (at the
  capacity edge above all, where every routed token of a top-1 router has
  gate 1.0) keeps the same token as the reference does.
* The combine. The reference scatter-adds the (G,E,C,d) expert outputs
  back to their tokens. ``index_add_`` on CUDA adds with atomics, in
  another order each run. Here each token gathers its own kept (expert,
  slot) outputs and sums them in the order of its top-k choices, in f32,
  then casts to the activations' dtype once: one prefill gives the same
  bits on every run.
* Expert parallelism. The reference keeps the stacked experts sharded
  over 'model' and constrains the routing tensors to its mesh
  (``policy.ctx_constrain``), so that each shard gathers and computes its
  own experts' tokens. Here, under a step's mesh context on a 'model'
  axis of more than 1 (``policy.ctx_tp``) where the policy splits the
  stack (``w_gate_e`` holds E / n experts), the rank holds experts
  [rank E/n, (rank+1) E/n). The tokens are the same on every rank (the
  attention before sums its heads over the ranks), so every rank routes
  them whole, as one card does, and drops the same ones; it then runs
  its own experts' tokens, sums each token's kept choices that fall on
  them, and the ranks' f32 partial sums are all-reduced
  (``policy.reduce_from_tp``): an all-reduce of activation size, no
  all-to-all. The router is replicated; its out-path gradient comes
  through this rank's experts only, so the gate tensor and the tokens
  enter them through ``policy.copy_to_tp`` (the backward sums them over
  the ranks), while the aux loss, computed whole on every rank, takes
  none. The dense MLP and the shared experts split ``d_ff`` over
  'model' (``apply_mlp``).

The expert products are batched matmuls (``torch.einsum``), as they are
plain einsums in the reference: no Pallas kernel computes them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.common import activation, dense_init, pdtype
from repro_torch.sharding import policy


# ------------------------------------------------------------- dense MLP ---
def init_mlp(gen, cfg, d_ff: int | None = None, gated: bool | None = None,
             *, device):
    """Gated (w_gate, w_up, w_down) when ``gated``, by default when
    ``cfg.act`` is silu."""
    d_ff = d_ff or cfg.d_ff
    gated = (cfg.act == "silu") if gated is None else gated
    dt = pdtype(cfg)

    def dense(shape):
        return dense_init(gen, shape, 0, dt, device=device)

    if gated:
        return {"w_gate": dense((cfg.d_model, d_ff)),
                "w_up": dense((cfg.d_model, d_ff)),
                "w_down": dense((d_ff, cfg.d_model))}
    return {"w_in": dense((cfg.d_model, d_ff)),
            "b_in": torch.zeros((d_ff,), dtype=dt, device=device),
            "w_out": dense((d_ff, cfg.d_model)),
            "b_out": torch.zeros((cfg.d_model,), dtype=dt, device=device)}


def apply_mlp(p, x, cfg, d_ff: int | None = None):
    """Under a 'model' split of the hidden width (``policy.ctx_tp``, the
    hidden width of ``p`` a share of ``d_ff``, by default ``cfg.d_ff``):
    ``w_gate``/``w_up``/``w_in``/``b_in`` column-parallel,
    ``w_down``/``w_out`` row-parallel and summed over the ranks, ``b_out``
    added once after the sum."""
    act = activation(cfg.act)
    tp = policy.ctx_tp()
    if tp is not None and p["w_down" if "w_gate" in p else "w_out"
                           ].shape[0] == (d_ff or cfg.d_ff):
        tp = None
    if tp is not None:
        x = policy.copy_to_tp(x, tp)
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
        out = h @ p["w_down"]
        return out if tp is None else policy.reduce_from_tp(out, tp)
    h = act(x @ p["w_in"] + p["b_in"])
    if tp is None:
        return h @ p["w_out"] + p["b_out"]
    return policy.reduce_from_tp(h @ p["w_out"], tp) + p["b_out"]


# ------------------------------------------------------------------- MoE ---
def init_moe(gen, cfg, *, device):
    moe = cfg.moe
    dt = pdtype(cfg)
    d, f, e = cfg.d_model, moe.d_ff_expert, moe.num_experts

    def stacked(shape):
        # each expert's std from its own fan-in (the reference draws every
        # expert by itself and stacks them)
        return dense_init(gen, (e,) + shape, 1, dt, device=device)

    p = {"w_router": dense_init(gen, (d, e), 0, torch.float32,
                                device=device),
         "w_gate_e": stacked((d, f)),
         "w_up_e": stacked((d, f)),
         "w_down_e": stacked((f, d))}
    if moe.num_shared_experts:
        # n shared silu-gated experts of width w are algebraically one
        # gated MLP of width n*w (outputs sum)
        p["shared"] = init_mlp(gen, cfg,
                               d_ff=moe.num_shared_experts * moe.d_ff_shared,
                               gated=True, device=device)
    return p


def moe_capacity(tokens_per_group: int, cfg) -> int:
    moe = cfg.moe
    c = math.ceil(tokens_per_group * moe.top_k / moe.num_experts
                  * moe.capacity_factor)
    return max(1, min(c, tokens_per_group))


def moe_groups(n_tokens: int, n_groups: int) -> int:
    """The routing groups ``apply_moe`` uses: ``n_groups`` at most, one
    per token at most, and a divisor of the token count."""
    g = max(1, min(n_groups, n_tokens))
    while n_tokens % g:
        g -= 1
    return g


class Routing(NamedTuple):
    probs: torch.Tensor      # (G,Tg,E) f32 router softmax
    topi: torch.Tensor       # (G,Tg,k) each token's experts, best first
    sel_gate: torch.Tensor   # (G,E,C) f32 routing weight of each slot (0:
    #                          a token the expert was not routed)
    sel_idx: torch.Tensor    # (G,E,C) token of each slot
    slot: torch.Tensor       # (G,Tg,k) the slot of each choice, -1: dropped


def _sort_desc(x):
    """Descending, ties in index order (``jax.lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def route(p, xg, cfg, cap: int, tp=None) -> Routing:
    """Router softmax, each token's top-k experts (renormalized weights),
    and each expert's top-``cap`` tokens of a (G,Tg,d) group tensor, for
    all E experts. tp: the 'model' axis whose ranks each run a share of
    the experts (``apply_moe``); the gate tensor then enters the experts'
    selection through ``policy.copy_to_tp``."""
    moe = cfg.moe
    g, tg, _ = xg.shape
    # bf16 inputs, f32 products and sums (the reference's
    # preferred_element_type=f32): the bf16 values widen exactly
    logits = xg.to(torch.float32) @ p["w_router"].to(xg.dtype).to(
        torch.float32)
    probs = torch.softmax(logits, dim=-1)                      # (G,Tg,E)
    vals, idx = _sort_desc(probs)
    topv, topi = vals[..., :moe.top_k], idx[..., :moe.top_k]
    topv = topv / topv.sum(-1, keepdim=True)                   # renorm
    gate = torch.zeros_like(probs).scatter_(-1, topi, topv)    # (G,Tg,E)
    if tp is not None:
        gate = policy.copy_to_tp(gate, tp)
    sel_gate, sel_idx = (t[..., :cap] for t in
                         _sort_desc(gate.transpose(1, 2)))     # (G,E,C)
    # slot_of[g, e, t]: where expert e keeps token t (-1: not kept); then
    # each token's choices read their slots from it
    slot_of = torch.full((g, moe.num_experts, tg), -1, dtype=torch.long,
                         device=xg.device)
    slot_of.scatter_(2, sel_idx, torch.arange(cap, device=xg.device)
                     .expand_as(sel_idx).contiguous())
    # (a slot an expert fills with a token it was not routed, gate 0, when
    # it has fewer than C, is never read: no choice points at it)
    slot = slot_of.gather(1, topi.transpose(1, 2)).transpose(1, 2)
    return Routing(probs, topi, sel_gate, sel_idx, slot)


def _expert_split(p, cfg):
    """The ambient 'model' axis when ``p``'s expert stack is split over it
    (``w_gate_e`` holds E / n experts), else None: the experts run
    whole."""
    tp = policy.ctx_tp()
    if tp is None or p["w_gate_e"].shape[0] == cfg.moe.num_experts:
        return None
    return tp


def apply_moe(p, x, cfg, n_groups: int = 1, dp_mean=None):
    """x (B, S, d) -> (out (B,S,d), aux_loss scalar f32).

    dp_mean: None, or a function that averages a tensor over the
    data-parallel ranks of a step (``launch/steps.make_train_step``),
    where each rank holds one routing group of the reference's batch:
    the aux loss's token fractions are then the whole batch's, so the
    ranks' aux losses average to the reference's (its gradient flows
    through the router probabilities only). Under a 'model' split of the
    experts (``_expert_split``) each rank computes its experts' share of
    the output (the module docstring)."""
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    g = moe_groups(t, n_groups)
    tg = t // g
    cap = moe_capacity(tg, cfg)
    xg = x.reshape(g, tg, d)
    tp = _expert_split(p, cfg)
    r = route(p, xg, cfg, cap, tp)
    n_e = p["w_gate_e"].shape[0]              # this rank's experts
    e0 = 0 if tp is None else tp.rank * n_e
    sel_gate = r.sel_gate[:, e0:e0 + n_e]
    sel_idx = r.sel_idx[:, e0:e0 + n_e]
    src = xg if tp is None else policy.copy_to_tp(xg, tp)

    xe = src.gather(1, sel_idx.reshape(g, -1, 1).expand(-1, -1, d)
                    ).reshape(g, n_e, cap, d)
    act = activation(cfg.act)
    h = act(torch.einsum("gecd,edf->gecf", xe, p["w_gate_e"]))
    h = h * torch.einsum("gecd,edf->gecf", xe, p["w_up_e"])
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down_e"])
    ye = ye * sel_gate[..., None].to(ye.dtype)                 # weight

    # the combine: each token sums its kept choices' outputs on this
    # rank's experts, best first, in f32; the ranks' sums are added in f32
    # and cast once
    flat = ye.reshape(g, n_e * cap, d)
    out = torch.zeros((g, tg, d), dtype=torch.float32, device=x.device)
    for j in range(moe.top_k):
        e, kept = r.topi[..., j], r.slot[..., j] >= 0
        if tp is not None:                    # this rank's experts' choices
            e = e - e0
            kept = kept & (e >= 0) & (e < n_e)
            e = e.clamp(0, n_e - 1)
        at = e * cap + r.slot[..., j].clamp(min=0)
        yj = flat.gather(1, at[..., None].expand(-1, -1, d))
        out += torch.where(kept[..., None], yj.to(torch.float32), 0.0)
    if tp is not None:
        out = policy.reduce_from_tp(out, tp)
    out = out.to(x.dtype)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], xg, cfg, d_ff=(
            moe.num_shared_experts * moe.d_ff_shared))

    # Switch-style load-balance aux loss
    counts = torch.zeros_like(r.probs).scatter_(-1, r.topi, 1.0)
    token_frac = counts.mean(dim=(0, 1))                       # (E,)
    if dp_mean is not None:
        token_frac = dp_mean(token_frac)
    prob_frac = r.probs.mean(dim=(0, 1))
    aux = moe.num_experts * torch.sum(token_frac * prob_frac) / moe.top_k
    return out.reshape(b, s, d), aux
