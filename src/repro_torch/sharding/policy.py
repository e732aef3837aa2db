"""Sharding policy: how this system's state is split across devices, the
port of the reference's ``sharding/policy.py``. Two independent layers:

1. **Param sharding** (train/serve): every param leaf name maps to
   logical axes, logical axes map to mesh axes with divisibility checks
   (indivisible dims replicate). Logical axes:

     tp    -> 'model'         (heads / d_ff / experts / vocab columns)
     fsdp  -> ('pod','data')  (ZeRO-style param+grad+opt-state sharding)
     None  -> replicated

   ``spec_for`` / ``param_pspecs`` / ``batch_spec`` return the
   reference's per-dimension specs: a tuple with, for each tensor
   dimension, None, one mesh axis name or a tuple of them. They read a
   mesh's axis names and sizes only (``mesh_axes``), so a
   ``MeshShape`` computes the production meshes' specs without 256
   ranks. ``placements`` turns a spec into DTensor placements on a
   ``torch.distributed.device_mesh.DeviceMesh`` (``Shard(d)`` on each
   mesh dimension whose axis shards tensor dimension d, in mesh order,
   the reference's major-to-minor order; ``Replicate()`` elsewhere), and
   ``place`` puts a tree of tensors on the mesh under them.

   The reference's mesh context (``use_ctx_mesh``) is here too: a step
   that computes each rank's 'model' shard (``launch/steps``) enters it,
   and model code reads the 'model' group and its rank from it
   (``ctx_tp``) without the mesh threaded through every signature. A
   decode step whose batch does not split over the data-parallel axes
   enters it with the cache's sequence length: the decode cache's
   sequence is then split over 'data' in blocks, as the reference's
   ``cache_pspecs`` splits it, and model code reads the 'data' group
   (``ctx_dp``) and combines the ranks' partial softmaxes over it
   (``max_dp``, ``sum_dp``). A step whose parameters are the rank's
   shards enters it with their ZeRO gathers (``Zero``, ``zero_gathers``:
   each leaf's gather dims over the data-parallel axes, read from its
   placements), and model code gathers a layer's leaves where the layer
   runs (``zero_gather``, ``_GatherDP``: an all-gather whose backward
   reduce-scatters the gradient, in the step's accumulator dtype, into
   the rank's accumulator), as XLA gathers one layer's slice inside the
   reference's scan body.
   Where the reference's ``ctx_constrain`` hints XLA's SPMD partitioner,
   the port's model code calls Megatron's pair of collectives over the
   'model' group itself (``copy_to_tp``: the identity, whose backward
   all-reduces the gradient, before a column-parallel product;
   ``reduce_from_tp``: an all-reduce, whose backward is the identity,
   after a row-parallel product), ``gather_tp`` (an all-gather whose
   backward reduce-scatters) and ``max_tp``. Without a context, or on a
   'model' axis of 1, ``ctx_tp`` is None and model code dispatches none
   of them. ``constrain_batch`` places a batch under ``batch_spec``.

2. **Corpus row sharding** (scan engine, DESIGN.md §9), numpy only:
   ``ShardPlan`` / ``plan_shards`` partition a scan's metadata-survivor
   row set across shard executors. Range partitioning splits the
   (sorted) id list into contiguous runs balanced by a per-row weight —
   skew-aware when the caller supplies the planner's expected per-row
   evaluation cost — and hash partitioning assigns each row id a stable
   pseudo-random shard so a row keeps its shard (and its shard-side
   caches) across queries. Both are exact partitions: every row lands in
   exactly one shard. ``shard_route`` routes single rows the way a hash
   plan does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

# leaf name -> logical axes per dim (suffix match on the param path).
RULES: dict[str, tuple] = {
    # embeddings / heads
    "embedding": ("tp", "fsdp"),
    "lm_head": ("fsdp", "tp"),
    "dec_pos": ("fsdp", None),
    # attention (column-parallel in, row-parallel out)
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "bq": ("tp",), "bk": (None,), "bv": (None,),
    # MLA
    "w_dq": ("fsdp", None), "w_uq": (None, "tp"),
    "w_dkv": ("fsdp", None), "w_uk": (None, "tp"), "w_uv": (None, "tp"),
    "q_norm": (None,), "kv_norm": (None,),
    # MLP
    "w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"), "w_down": ("tp", "fsdp"),
    "w_in": ("fsdp", "tp"), "b_in": ("tp",),
    "w_out": ("tp", "fsdp"), "b_out": (None,),
    # MoE (stacked experts: EP over 'model', expert-width over fsdp)
    "w_router": (None, None),
    "w_gate_e": ("tp", None, "fsdp"), "w_up_e": ("tp", None, "fsdp"),
    "w_down_e": ("tp", "fsdp", None),
    # SSM
    "w_z": ("fsdp", "tp"), "w_x": ("fsdp", "tp"), "w_dt": ("fsdp", "tp"),
    "w_b": ("fsdp", None), "w_c": ("fsdp", None),
    "conv_x": ("tp", None), "conv_b": (None, None), "conv_c": (None, None),
    "conv_x_b": ("tp",), "conv_b_b": (None,), "conv_c_b": (None,),
    "a_log": ("tp",), "dt_bias": ("tp",), "d_skip": ("tp",),
    "norm_scale": ("tp",),
    # norms
    "scale": (None,), "bias": (None,),
}

LOGICAL = {"tp": ("model",), "fsdp": ("pod", "data")}


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes without its ranks: what the policy
    reads (the production meshes' specs, computed on one process)."""
    axis_names: tuple
    shape: tuple


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``, in mesh
    order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))


def _resolve_dim(logical, dim_size: int, sizes: dict):
    """logical axis name -> concrete mesh axes (or None), honoring
    divisibility. fsdp degrades ('pod','data') -> ('data',) -> ('pod',)."""
    if logical is None:
        return None
    # candidates: the full combo first, then single axes largest-first
    singles = sorted(LOGICAL[logical], key=lambda a: -sizes.get(a, 0))
    for axes in (LOGICAL[logical],) + tuple((a,) for a in singles):
        axes = tuple(a for a in axes if a in sizes)
        if not axes:
            continue
        prod = 1
        for a in axes:
            prod *= sizes[a]
        if prod > 1 and dim_size % prod == 0:
            return axes if len(axes) > 1 else axes[0]
    return None


def leaf_name(path) -> str:
    """The last dict key of a tree path (a tuple of dict keys and list
    indices)."""
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def spec_for(name: str, shape, mesh) -> PSpec:
    """The per-dimension spec of one param leaf. Stacked leaves (layer or
    expert stacks) have one more leading dim than the rule — leading dims
    are replicated (layer axis)."""
    rule = RULES.get(name)
    if rule is None or not shape:
        return PSpec()
    sizes = mesh_axes(mesh)
    extra = len(shape) - len(rule)
    if extra < 0:
        return PSpec()
    # 'layers' stacking: the leading scan dim stays replicated, but the
    # expert rules already include their stack dim so only true layer
    # stacking lands in `extra`.
    return PSpec([None] * extra + [
        _resolve_dim(lg, shape[extra + i], sizes)
        for i, lg in enumerate(rule)])


class PSpec(tuple):
    """A per-dimension spec (the reference's ``PartitionSpec``): a tuple,
    and a leaf of the trees it fills."""


class Placements(tuple):
    """DTensor placements, one per mesh dimension: a tuple, and a leaf of
    the trees it fills."""


def _is_leaf(x) -> bool:
    return isinstance(x, (PSpec, Placements)) or not isinstance(
        x, (dict, list, tuple))


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict/list/tuple tree (dict keys and
    sequence indices in ``path``), keeping the tree's structure; None
    stays None."""
    if _is_leaf(tree):
        return None if tree is None else fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return type(tree)(tree_map_with_path(fn, v, path + (i,))
                      for i, v in enumerate(tree))


def param_pspecs(params_or_shapes, mesh):
    """Tree of specs matching the params tree (tensors, meta tensors or
    anything with a ``shape``)."""
    return tree_map_with_path(
        lambda path, x: spec_for(leaf_name(path), tuple(x.shape), mesh),
        params_or_shapes)


def placements(spec: tuple, mesh) -> Placements:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension,
    ``Shard(d)`` where its axis shards tensor dimension d, else
    ``Replicate()``. A dimension sharded over ('pod', 'data') is
    ``Shard(d)`` on both, in mesh order (pod major, as the reference)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh_axes(mesh):
        dims = [d for d, part in enumerate(spec) if part is not None
                and axis in ((part,) if isinstance(part, str) else part)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return Placements(out)


def param_shardings(params_or_shapes, mesh):
    """Tree of DTensor placements (``placements``) matching the params
    tree."""
    return tree_map_with_path(lambda _, s: placements(s, mesh),
                              param_pspecs(params_or_shapes, mesh))


def place(tree, mesh, shardings=None):
    """Each leaf of ``tree`` as a DTensor on ``mesh`` under ``shardings``
    (default: ``param_shardings``), cut from the whole tensor that every
    rank holds (no communication). A 0-d leaf (an optimizer's step count)
    stays where it is: the optimizer reads it on the host."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    shardings = shardings or param_shardings(tree, mesh)

    def put(path, x):
        if isinstance(x, DTensor) or x.dim() == 0:
            return x
        pl = at_path(shardings, path)
        return distribute_tensor(x.to(mesh.device_type), mesh, pl,
                                 src_data_rank=None)
    return tree_map_with_path(put, tree)


def at_path(tree, path):
    """The subtree of ``tree`` at ``path`` (``tree_map_with_path``'s)."""
    for k in path:
        tree = tree[k]
    return tree


# ---- mesh context: model code reads the 'model' group from it, as the
# reference's reads its ambient mesh (``use_ctx_mesh``) ----
class TPGroup(NamedTuple):
    """The 'model' axis of the ambient mesh as this rank sees it."""
    size: int
    rank: int
    group: object      # the 'model' ProcessGroup


class DPGroup(NamedTuple):
    """The 'data' axis of the ambient mesh in a context-parallel decode
    step, as this rank sees it: the decode cache's sequence axis split
    over it in blocks, in rank order (the reference's ``cache_pspecs``
    puts the sequence over 'data' when the batch does not split over the
    data-parallel axes; on a mesh with 'pod' the pods hold the same
    blocks)."""
    size: int
    rank: int
    group: object      # the 'data' ProcessGroup
    seq_len: int       # the decode cache's sequence length, whole

    def block(self, t: int) -> int | None:
        """The first position of this rank's block of a sequence axis of
        ``t`` positions (``t / size`` long), or None where ``size`` does
        not divide ``t``: the axis is then whole on every rank."""
        return None if t % self.size else self.rank * (t // self.size)


class Zero(NamedTuple):
    """The ZeRO gathers of a step's parameter tree (``zero``): for each
    leaf the policy shards over data-parallel axes of more than 1, by its
    path, (the placed leaf's ndim, its gathers in order: (tensor dim,
    process group), the minor mesh axis first). In a train step also
    ``sinks``, by the same paths, the rank's f32 gradient accumulators
    (its shards) that the gathers' backward adds into, and ``token``, the
    0-d tensor through which autograd reaches each gather (the shards
    themselves take no gradient)."""
    gathers: dict
    sinks: dict | None = None
    token: torch.Tensor | None = None


_CTX_TP: TPGroup | None = None
_CTX_DP: DPGroup | None = None
_CTX_ZERO: Zero | None = None


class use_ctx_mesh:
    """``with use_ctx_mesh(mesh):`` model code under it computes this
    rank's 'model' shard (``ctx_tp``); with ``seq_len`` (a decode step
    whose batch does not split over the data-parallel axes) it also holds
    and reads this rank's blocks of the decode cache's sequence
    (``ctx_dp``); with ``zero`` (a ``Zero``: the parameters are the
    rank's shards) each layer's leaves are gathered over the
    data-parallel axes where the layer runs (``zero_gather``). The
    previous context comes back on exit."""

    def __init__(self, mesh, seq_len: int | None = None,
                 zero: Zero | None = None):
        self.mesh, self.seq_len, self.zero = mesh, seq_len, zero

    def __enter__(self):
        global _CTX_TP, _CTX_DP, _CTX_ZERO
        self._prev = _CTX_TP, _CTX_DP, _CTX_ZERO
        _CTX_TP = _tp_group(self.mesh)
        _CTX_DP = _dp_group(self.mesh, self.seq_len)
        _CTX_ZERO = self.zero if self.zero and self.zero.gathers else None
        return self.mesh

    def __exit__(self, *exc):
        global _CTX_TP, _CTX_DP, _CTX_ZERO
        _CTX_TP, _CTX_DP, _CTX_ZERO = self._prev


def _tp_group(mesh):
    if mesh is None or mesh_axes(mesh).get("model", 1) == 1:
        return None
    return TPGroup(mesh.size(mesh.mesh_dim_names.index("model")),
                   mesh.get_local_rank("model"), mesh.get_group("model"))


def _dp_group(mesh, seq_len):
    if mesh is None or seq_len is None or \
            mesh_axes(mesh).get("data", 1) == 1:
        return None
    return DPGroup(mesh.size(mesh.mesh_dim_names.index("data")),
                   mesh.get_local_rank("data"), mesh.get_group("data"),
                   seq_len)


def ctx_tp() -> TPGroup | None:
    """The ambient mesh's 'model' axis, or None: no context, or an axis
    of 1 (model code then runs as on one card)."""
    return _CTX_TP


def ctx_dp() -> DPGroup | None:
    """The ambient mesh's 'data' axis in a context-parallel decode step,
    or None: no such step, or an axis of 1 (the decode cache is then
    whole on every rank)."""
    return _CTX_DP


def zero_gathers(params, mesh) -> dict:
    """``Zero.gathers`` of a tree of DTensors on ``mesh``, read from each
    leaf's placements: its gathers over the data-parallel axes of more
    than 1 that shard it, the minor axis first (a dim split over ('pod',
    'data') comes back pod-major)."""
    from torch.distributed.tensor import DTensor
    axes = mesh_axes(mesh)
    dp = [i for i, (a, n) in enumerate(axes.items())
          if a in ("pod", "data") and n > 1]
    out = {}

    def visit(path, x):
        if not isinstance(x, DTensor):
            return
        steps = tuple((x.placements[i].dim, mesh.get_group(i))
                      for i in reversed(dp) if x.placements[i].is_shard())
        if steps:
            out[path] = (x.dim(), steps)
    tree_map_with_path(visit, params)
    return out


class _GatherDP(torch.autograd.Function):
    """A leaf's shard gathered over the data-parallel axes (``steps``: (dim,
    group), minor axis first). The gradient reaches it through ``token``;
    the backward reduce-scatters the gathered leaf's gradient in the
    reverse order, in ``sink``'s dtype (the step's ``grad_accum_dtype``,
    so that the ranks' gradients are summed in it and not in the leaf's
    own), and adds it into ``sink``, the rank's accumulator of the
    leaf."""

    @staticmethod
    def forward(ctx, x, token, steps, sink):
        ctx.steps, ctx.sink = steps, sink
        return _gather_dp(x, steps)

    @staticmethod
    def backward(ctx, g):
        g = g.to(ctx.sink.dtype)
        for dim, group in reversed(ctx.steps):
            g = _reduce_scatter0(g.movedim(dim, 0), group).movedim(0, dim)
        ctx.sink.add_(g)
        return None, None, None, None


def _gather_dp(x, steps):
    """``x`` gathered over ``steps`` ((dim, group), in order)."""
    for dim, group in steps:
        x = _all_gather0(x.movedim(dim, 0), group).movedim(0, dim)
    return x


def zero_gather(tree, path: tuple, layer: int | None = None):
    """``tree``, the rank's shards at ``path`` of the parameter tree (with
    ``layer``: that layer of the stacks at ``path``, as ``transformer.
    _layers`` gives it), with each leaf that the ambient step shards over
    the data-parallel axes gathered whole over them, the others as they
    are. Under autograd each gather's backward reduce-scatters the
    leaf's gradient into the rank's accumulator (``_GatherDP``). Without
    a ZeRO context, ``tree`` itself."""
    zero = _CTX_ZERO
    if zero is None:
        return tree
    grad = torch.is_grad_enabled() and zero.sinks is not None

    def gather(sub, x):
        entry = zero.gathers.get(path + sub)
        if entry is None:
            return x
        ndim, steps = entry
        shift = ndim - x.dim()           # 1 for a layer of a stack
        steps = tuple((d - shift, g) for d, g in steps)
        if not grad:
            return _gather_dp(x, steps)
        sink = zero.sinks[path + sub]
        return _GatherDP.apply(x, zero.token, steps,
                               sink if layer is None else sink[layer])
    return tree_map_with_path(gather, tree)


def _all_reduce(x, op, group):
    out = torch.ops._c10d_functional.all_reduce(x.contiguous(), op,
                                               group.group_name)
    return torch.ops._c10d_functional.wait_tensor(out)


# The gather and the reduce-scatter take the process group's own ops: the
# functional all-gather of CUDA tensors crashes gloo (torch 2.11; gloo
# ranks share one card where NCCL refuses), its own op does not.
def _all_gather0(x, group):
    """The ranks' ``x`` concatenated along dim 0, in rank order."""
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _reduce_scatter0(x, group):
    """The ranks' ``x`` summed, and this rank's block of dim 0 of it."""
    n = dist.get_world_size(group)
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


class _CopyToTP(torch.autograd.Function):
    """Identity; the backward sums the gradient over the 'model' ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """The sum over the 'model' ranks; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTP(torch.autograd.Function):
    """The 'model' ranks' blocks of ``dim`` gathered; the backward sums
    the gradient over the ranks and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather0(x.movedim(dim, 0), group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter0(g.movedim(ctx.dim, 0), ctx.group)
                .movedim(0, ctx.dim), None, None)


def copy_to_tp(x, tp: TPGroup):
    """``x``, replicated over the 'model' ranks, entering computation that
    each rank does for its own shard (a column-parallel product): the
    identity; under autograd the backward all-reduces the gradient."""
    if not torch.is_grad_enabled():
        return x
    return _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x, tp: TPGroup):
    """The 'model' ranks' partial ``x`` summed (after a row-parallel
    product): an all-reduce whose backward is the identity."""
    return _ReduceFromTP.apply(x, tp.group)


def gather_tp(x, dim: int, tp: TPGroup):
    """A leaf split over 'model' along ``dim``, whole on every rank for
    computation that each rank does for its own shard: an all-gather
    whose backward reduce-scatters the gradient."""
    return _GatherTP.apply(x, dim, tp.group)


def max_tp(x, tp: TPGroup):
    """The elementwise max over the 'model' ranks (no gradient)."""
    return _all_reduce(x.detach(), "max", tp.group)


def max_dp(x, dp: DPGroup):
    """The elementwise max over the 'data' ranks (decode: no gradient)."""
    return _all_reduce(x, "max", dp.group)


def sum_dp(x, dp: DPGroup):
    """The elementwise sum over the 'data' ranks (decode: no gradient)."""
    return _all_reduce(x, "sum", dp.group)


def batch_spec(mesh, ndim: int, batch_axis: int = 0) -> PSpec:
    """Shard the batch dim over all data-parallel axes."""
    dp = dp_axes(mesh)
    parts = [None] * ndim
    parts[batch_axis] = dp if len(dp) > 1 else (dp[0] if dp else None)
    return PSpec(parts)


def constrain_batch(x, mesh):
    """``x`` (every rank's copy of the whole batch) as a DTensor on
    ``mesh`` under ``batch_spec``: each rank keeps its rows."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements(batch_spec(mesh, x.dim()),
                                                 mesh), src_data_rank=None)


# ======================================================================
# Corpus row sharding (scan engine, DESIGN.md §9)
# ======================================================================
SHARD_STRATEGIES = ("range", "hash")


@dataclass(frozen=True)
class ShardPlan:
    """An exact partition of a scan's surviving row ids across shards.

    ``shards[i]`` is the i-th shard's row-id array (sorted ascending,
    possibly empty); the arrays are disjoint and their union is exactly
    the planned id set. ``weights[i]`` is the shard's total estimated
    evaluation cost under the weighting used to build the plan (row
    counts when the caller gave no weights)."""
    n_shards: int
    strategy: str
    shards: tuple
    weights: tuple

    @property
    def sizes(self) -> list[int]:
        return [len(s) for s in self.shards]

    @property
    def n_rows(self) -> int:
        return sum(self.sizes)

    @property
    def balance(self) -> float:
        """max/mean shard weight over non-degenerate plans; 1.0 is a
        perfectly even split, higher means skew."""
        mean = sum(self.weights) / max(self.n_shards, 1)
        return max(self.weights) / mean if mean > 0 else 1.0

    def all_rows(self) -> np.ndarray:
        """The planned id set, sorted (partition invariant: equals the
        ids the plan was built from)."""
        parts = [s for s in self.shards if len(s)]
        if not parts:
            return np.empty(0, np.int64)
        return np.sort(np.concatenate(parts))

    def validate(self, ids=None) -> None:
        """Check the partition invariants (cheap; guards caller-supplied
        plans in ShardedScanEngine.execute). Raises ValueError — not
        assert, which python -O strips — because a bad plan silently
        returns a wrong row set otherwise."""
        cat = self.all_rows()
        if len(np.unique(cat)) != len(cat):
            raise ValueError("invalid ShardPlan: a row is assigned to "
                             "more than one shard")
        if ids is not None and not np.array_equal(
                cat, np.sort(np.asarray(ids))):
            raise ValueError("invalid ShardPlan: partition does not "
                             "cover the id set (stale plan?)")

    def describe(self) -> str:
        sz = self.sizes
        lo, hi = (min(sz), max(sz)) if sz else (0, 0)
        return (f"{self.n_shards} shards ({self.strategy})  rows "
                f"min/max={lo}/{hi}  balance={self.balance:.2f}")


def _hash_ids(ids: np.ndarray) -> np.ndarray:
    """Stable 64-bit mix (splitmix64 finalizer) so hash shards spread
    contiguous id runs without Python-hash salt dependence."""
    h = ids.astype(np.uint64, copy=True)
    h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return h ^ (h >> np.uint64(31))


def shard_route(ids, n_shards: int) -> np.ndarray:
    """Stationary hash routing of individual row ids: the shard that
    owns each row under ``strategy='hash'`` partitioning, WITHOUT
    building a plan. ``plan_shards(ids, n, 'hash').shards[s]`` contains
    exactly the ids with ``shard_route(ids, n) == s`` — the serving
    path (serve/service.py) routes single-row requests with this and
    lands on the same shard (hence the same shard-local virtual
    columns) every scan-time hash plan used."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    ids = np.atleast_1d(np.asarray(ids, np.int64))
    return (_hash_ids(ids) % np.uint64(n_shards)).astype(np.int64)


def plan_shards(ids, n_shards: int, *, strategy: str = "range",
                weights=None) -> ShardPlan:
    """Partition row ids into ``n_shards`` disjoint shards.

    ``strategy='range'``: contiguous runs of the sorted id list, with
    boundaries placed on the cumulative ``weights`` curve (uniform when
    None) — the skew-aware split: a run of expensive rows ends up in a
    smaller shard. ``strategy='hash'``: stable per-id hash mod
    ``n_shards`` — balanced in expectation and stationary across
    queries. Empty shards are legal (n_shards may exceed len(ids))."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if strategy not in SHARD_STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"expected one of {SHARD_STRATEGIES}")
    ids = np.asarray(ids, np.int64)
    if weights is None:
        order = np.argsort(ids)
        ids = ids[order]
        w = np.ones(len(ids))
    else:
        w = np.asarray(weights, np.float64)
        assert w.shape == ids.shape, "weights must align with ids"
        # keep each weight paired with its row while sorting
        order = np.argsort(ids)
        ids, w = ids[order], w[order]
        # degenerate/negative weights would break the cumulative split
        w = np.clip(w, 0.0, None) + 1e-12

    if strategy == "hash":
        shard_of = shard_route(ids, n_shards)
        parts = [ids[shard_of == s] for s in range(n_shards)]
        wsums = [float(w[shard_of == s].sum()) for s in range(n_shards)]
        return ShardPlan(n_shards, strategy, tuple(parts), tuple(wsums))

    cum = np.cumsum(w)
    total = cum[-1] if len(cum) else 0.0
    targets = total * np.arange(1, n_shards) / n_shards
    # boundary b_j = first index whose cumulative weight exceeds target j
    # (side='right': a row exactly on the target closes the shard)
    bounds = np.searchsorted(cum, targets, side="right")
    parts = np.split(ids, bounds)
    wparts = np.split(w, bounds)
    return ShardPlan(n_shards, strategy, tuple(parts),
                     tuple(float(p.sum()) for p in wparts))
