"""Roofline cost extraction (DESIGN.md §7), the port of the reference's
``launch/costing.py``.

The reference derives its three roofline terms from the step's jaxpr and
its compiled HLO. The port's step is eager PyTorch, with no jaxpr and no
HLO, so it counts what one run of the step dispatches instead:

  * FLOPs: ``OpCounter``, a ``TorchDispatchMode``, sees every ATen op the
    run dispatches, after autograd, so the backward is counted, and
    under ``torch.utils.checkpoint(use_reentrant=False)`` the recompute
    runs in the backward and is counted, as the reference counts remat.
    Matmul-class ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    convolutions, ``_scaled_dot_product_*``, and ``dot``/``mv``/``addmv``)
    take the formulas of ``torch.utils.flop_counter``; every other op that
    computes something counts one FLOP per output element, as the
    reference counts every other equation. Views, allocations and
    detaches compute nothing. A Python loop runs every iteration, so no
    trip count is needed. An op on DTensors is let through to DTensor,
    which runs it as ops on this rank's local tensors: those are counted,
    so the count is this rank's work.
  * Counting runs on CPU tensors, real or fake (``FakeTensorMode``).
    There the kernel wrappers run their plain versions, so the count is
    the plain versions' work (the reference's model runs ``sdpa`` and
    ``ssd_chunked`` too). A CUDA tensor raises: it would reach
    ``kernels/bindings`` and launch.
  * Collective bytes: the ``_c10d_functional`` collectives the run
    dispatches (DTensor's redistributions, ``CommDebugMode``'s ops) and
    the process group's own ops, by the reference's kinds: output bytes
    a device and the count of each. A P2P receive (the pipeline's) is a
    ``collective-permute``, counted once, at the receiving rank; a send
    is its peer's receive. ``OpCounter.collectives()`` returns the
    reference's ``parse_collectives`` dict.
  * HBM bytes: the reference's analytic obligatory-traffic model
    (``analytic_bytes``), copied as it is.
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# ------------------------------------------------------------ op counts ---
_aten = torch.ops.aten
_funcol = torch.ops._c10d_functional
_c10d = torch.ops.c10d
COLLECTIVE_KINDS = {
    _funcol.all_gather_into_tensor: "all-gather",
    _funcol.all_gather_into_tensor_coalesced: "all-gather",
    _c10d._allgather_base_: "all-gather",
    _c10d.allgather_: "all-gather",
    _funcol.all_reduce: "all-reduce",
    _funcol.all_reduce_: "all-reduce",
    _funcol.all_reduce_coalesced: "all-reduce",
    _c10d.allreduce_: "all-reduce",
    _funcol.reduce_scatter_tensor: "reduce-scatter",
    _funcol.reduce_scatter_tensor_coalesced: "reduce-scatter",
    _c10d._reduce_scatter_base_: "reduce-scatter",
    _c10d.reduce_scatter_: "reduce-scatter",
    _funcol.all_to_all_single: "all-to-all",
    _c10d.alltoall_base_: "all-to-all",
    _c10d.recv_: "collective-permute",
}
# ops that alias, allocate or read to the host: no FLOP (views too)
_NO_COMPUTE = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "lift_fresh_copy", "_local_scalar_dense", "resize_", "set_"}
# the process group's namespaces: what is no collective kind above (a
# send, counted at its receiver; a wait; a barrier) computes nothing
_COMM_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def _dot_flop(a, b, *args, out_val=None, **kwargs) -> int:
    return 2 * a.shape[0]


def _mv_flop(a, b, *args, out_val=None, **kwargs) -> int:
    return 2 * a.shape[0] * a.shape[1]


def _addmv_flop(bias, a, b, *args, out_val=None, **kwargs) -> int:
    return _mv_flop(a, b)


def _matmul_registry() -> dict:
    from torch.utils.flop_counter import flop_registry
    reg = dict(flop_registry)
    reg.update({_aten.dot: _dot_flop, _aten.vdot: _dot_flop,
                _aten.mv: _mv_flop, _aten.addmv: _addmv_flop})
    return reg


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _refuse_cuda(tree, what) -> None:
    if any(t.device.type == "cuda" for t in _tensors(tree)):
        raise ValueError(f"{what}: costing counts CPU tensors (real or "
                         f"fake); a CUDA tensor would launch a kernel")


class OpCounter(TorchDispatchMode):
    """FLOPs and collectives of the ops dispatched while it is active
    (``with OpCounter() as c: fn(...)``): ``c.flops`` (all of them),
    ``c.matmul_flops`` (the matmul-class part), ``c.by_op`` (FLOPs by
    op name), ``c.collectives()`` and ``c.coll_largest`` (the largest
    output bytes of one collective, by kind)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.matmul_flops = 0
        self.by_op: dict[str, int] = defaultdict(int)
        self.coll_bytes: dict[str, float] = defaultdict(float)
        self.coll_count: dict[str, int] = defaultdict(int)
        self.coll_largest: dict[str, float] = defaultdict(float)
        self._matmul = _matmul_registry()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        # let DTensor run the op as local ops, which come back here
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        _refuse_cuda((args, kwargs), func)
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        pkt = func._overloadpacket
        kind = COLLECTIVE_KINDS.get(pkt)
        if kind is not None:
            outs = (_tensors(args[0]) if pkt is _c10d.recv_
                    else _tensors(out))
            nbytes = float(sum(t.numel() * t.element_size() for t in outs))
            self.coll_bytes[kind] += nbytes
            self.coll_count[kind] += 1
            self.coll_largest[kind] = max(self.coll_largest[kind], nbytes)
            return
        name = pkt.__name__
        if pkt in self._matmul:
            n = int(self._matmul[pkt](*args, **kwargs, out_val=out))
            self.matmul_flops += n
        else:
            if func.is_view or name in _NO_COMPUTE \
                    or func.namespace in _COMM_NAMESPACES:
                return
            outs = _tensors(out)
            if not outs and name.endswith("_"):    # in place, no return
                outs = _tensors(args[0])
            n = sum(t.numel() for t in outs)
        self.flops += n
        self.by_op[name] += n

    def collectives(self) -> dict:
        """The reference's ``parse_collectives`` dict: collective output
        bytes a device and counts, by kind."""
        return {"bytes_by_type": dict(self.coll_bytes),
                "count_by_type": dict(self.coll_count),
                "total_bytes": sum(self.coll_bytes.values())}


def count_ops(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, its ``OpCounter``): one run, counted.
    The arguments are CPU tensors, real or fake; a CUDA tensor raises."""
    _refuse_cuda((args, kwargs), getattr(fn, "__name__", fn))
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter


# ------------------------------------------------------- analytic memory ---
@dataclass
class MemModel:
    total: float
    breakdown: dict


def _layer_act_bytes(arch, tokens: int, seq: int, chunked_attn: bool) -> float:
    """Forward HBM traffic per layer for activations (bf16), one pass."""
    d = arch.d_model
    by = 2.0
    t = float(tokens)
    total = 4 * t * d * by  # block in/out + two norms
    if arch.family == "ssm" or (arch.family == "hybrid"):
        di = arch.d_inner_padded
        total += t * (2 * di + 2 * arch.conv_dim_padded) * by
    if arch.uses_attention and arch.family != "ssm":
        if arch.mla is not None:
            m = arch.mla
            hdim = arch.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            total += t * (hdim + 2 * arch.n_heads * m.v_head_dim
                          + m.kv_lora_rank * 3) * by
        else:
            from repro_torch.models.attention import layout_from_cfg
            lo = layout_from_cfg(arch)
            total += t * (2 * lo.hp + 2 * lo.khp) * arch.head_dim * by
        if not chunked_attn and seq > 1:
            from repro_torch.models.attention import layout_from_cfg
            hp = (arch.n_heads if arch.mla is not None
                  else layout_from_cfg(arch).hp)
            batch = tokens // seq
            total += batch * hp * float(seq) ** 2 * 4.0  # fp32 scores
    if arch.moe is not None:
        cap_tokens = t * arch.moe.top_k * arch.moe.capacity_factor
        total += 3 * cap_tokens * arch.moe.d_ff_expert * by
        if arch.moe.num_shared_experts:
            total += 3 * t * arch.moe.num_shared_experts \
                * arch.moe.d_ff_shared * by
    elif arch.d_ff:
        total += 3 * t * arch.d_ff * by
    return total


def analytic_bytes(kind: str, arch, shape, n_params: int, n_micro: int,
                   cache_bytes: float, chips: int,
                   weight_read_factor: float = 1.0) -> MemModel:
    """Global HBM traffic per step (per-device = /chips; all large tensors
    are sharded). Documented model — see module docstring."""
    b, s = shape.global_batch, shape.seq_len
    tokens = b * (1 if kind == "decode" else s)
    vp = arch.padded_vocab()
    chunked = (kind == "prefill" and s > 8192) or (
        kind == "train" and getattr(shape, "train_attn_chunk", 0) > 0)
    layers = arch.n_layers + (arch.encoder.n_layers
                              if arch.encoder else 0)
    br: dict[str, float] = {}
    if kind == "train":
        recompute_reads = 1 if shape.remat_policy != "none" else 0
        br["weights"] = n_params * 2.0 * (2 + recompute_reads) * n_micro
        br["grad_accum"] = n_params * 4.0 * 2 * n_micro
        br["optimizer"] = n_params * (4 * 2 * 2 + 2 + 2)
        per_layer = _layer_act_bytes(arch, tokens // n_micro, s, chunked)
        # fwd (1x) + recompute (1x) + bwd reads/writes (~2x)
        br["activations"] = per_layer * layers * n_micro \
            * (2 + 2 * recompute_reads)
        br["boundaries"] = tokens * arch.d_model * 2.0 * layers * 2
        br["logits"] = tokens * vp * 2.0 * 3  # write, read in loss, bwd
    elif kind == "prefill":
        # params_tp_only: weights replicated across the dp axes -> each
        # device streams its full TP shard (global-equivalent x dp).
        br["weights"] = n_params * 2.0 * weight_read_factor
        br["activations"] = _layer_act_bytes(arch, tokens, s, chunked) \
            * layers
        logit_positions = b if getattr(shape, "prefill_last_only", False) \
            else tokens
        br["logits"] = logit_positions * vp * 2.0
        br["cache_write"] = cache_bytes
    else:  # decode
        br["weights"] = n_params * 2.0 * weight_read_factor
        br["cache_read"] = cache_bytes
        br["cache_write"] = cache_bytes / max(float(s), 1.0)
        br["activations"] = _layer_act_bytes(arch, tokens, 1, False) * layers
        br["logits"] = tokens * vp * 2.0
    return MemModel(total=sum(br.values()), breakdown=br)


def tree_bytes(shapes_tree) -> float:
    """Bytes of a tree (dicts, lists, tuples) of tensors, meta tensors or
    ``steps.TensorSpec`` (their meta tensor)."""
    from repro_torch.launch.steps import TensorSpec

    def leaves(t):
        if isinstance(t, TensorSpec):
            yield t.meta
        elif isinstance(t, torch.Tensor):
            yield t
        elif isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                yield from leaves(v)
    return float(sum(math.prod(x.shape) * x.element_size()
                     for x in leaves(shapes_tree)))
