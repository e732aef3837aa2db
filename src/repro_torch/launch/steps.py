"""Step builders: train_step / prefill_step / decode_step over a device
mesh, microbatched gradient accumulation, and meta-tensor input specs for
the dry-run (no allocation); the port of the reference's
``launch/steps.py``.

The reference's train step is one SPMD program: XLA shards it over the
mesh. The port runs one process a rank:

* parameters and optimizer state live as DTensors under the sharding
  policy's placements (``sharding.policy.place``). On one card the mesh
  is (1, 1), every placement is ``Replicate()`` and nothing is
  communicated.
* each step hands the model this rank's shard of every parameter
  (``_shard``) and enters the mesh context (``policy.use_ctx_mesh``) with
  the leaves' ZeRO gathers (``policy.zero_gathers``, read from their
  placements): a leaf the policy shards over the data-parallel axes is
  gathered over them where its layer runs (``policy.zero_gather``:
  inside the layer's checkpointed body, so the backward's recompute
  gathers it again; the leaves outside the layer stacks once a call),
  and its gradient is reduce-scattered, in ``grad_accum_dtype``, into
  the rank's accumulator, which is the size of its shard. A rank holds
  its shard, one layer's gathered leaves and those outside the stacks.
  Nothing is gathered on a data-parallel size of 1 or for weights placed
  tp-only. ``_local`` (a leaf gathered over the data-parallel axes, its
  'model' shard kept) is the yardstick of a rank's 'model' shard; no
  step calls it.
* on a 'model' axis of more than 1 every family runs tensor-parallel
  (``tensor_parallel``): the model code computes the rank's share
  of the vocab, heads (GQA and MLA), ``d_ff``, experts and SSM heads,
  with Megatron's pair of collectives over the 'model' group
  (``models/transformer`` and ``models/encdec`` say where). Gradients
  stay local to the rank's shard; a leaf the policy replicates over the
  data-parallel axes has its gradient all-reduced over them once a step
  (``_shard_sum``); the loss is taken over the
  vocab shards (``lm_loss_parts``); serving logits are made whole on
  every rank. A leaf the policy replicates (its dim does not divide) is
  computed whole, and so is each block whose projections it replicates.
  The step's ``info["tensor_parallel"]`` (the serving steps' attribute
  ``tensor_parallel``) says whether the 'model' axis splits the work.
* a serving batch that does not split over the data-parallel axes
  (long_500k's one sequence: ``context_parallel``) is served whole on
  every rank, as the reference's ``input_specs`` replicate it, and the
  decode cache's sequence is split over 'data' as the reference's
  ``cache_pspecs`` splits it: each 'data' rank holds its block
  (``decode_cache``, ``place_cache``), and the decode step's attention
  combines the ranks' partial softmaxes (``policy.ctx_dp``,
  ``models/attention``). Greedy decoding then runs without
  ``launch/serve.grow_cache``, which cannot grow a block.
* the global batch (``global_batch`` rows, the whole of it on every
  rank, as a host batch) is cut into ``n_micro`` contiguous
  micro-batches, and each micro-batch into the data-parallel ranks'
  slices (``data.pipeline.rank_rows``): rank r in micro-step i computes
  the reference's routing group r of micro-batch i, so ``apply_moe``
  with one group a rank drops the tokens the reference drops.
* each micro-batch's loss is the masked mean over its tokens on all
  ranks: every rank divides its sum by the whole micro-batch's valid
  label count (read from the host batch), and the ranks' gradients add
  up. The MoE aux term's token fractions are averaged over the
  data-parallel ranks in the forward (``ffn.apply_moe(dp_mean=)``). Its
  value is the same on every 'model' rank, and so is its gradient, which
  reaches the replicated router and the activations by no collective
  (the expert path's gradient is summed over 'model' where it enters the
  rank's experts): it counts once, not once a 'model' rank.

``train_attn_chunk`` (and the reference's ``attn_chunk`` fallback for
long sequences) has no counterpart: the flash kernel tiles the queries
itself on the card, and its plain version computes the same attention
unchunked (``models/transformer`` says so for ``attn_chunk``).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.pipeline import shard_batch
from repro_torch.device import resolve_device
from repro_torch.models.common import DTYPES
from repro_torch.models.factory import Model
from repro_torch.sharding import policy
from repro_torch.train.optimizer import (adamw, tree_leaves,
                                         tree_leaves_with_path, tree_map,
                                         tree_unflatten)

MOE_AUX_COEF = 0.01
_BATCH_AXES = {"mrope_positions": 1}


# ------------------------------------------------------------------ loss ---
def lm_loss_parts(logits, labels, vocab_size: int):
    """(sum of the masked next-token CE, count of valid labels), f32.
    Labels already aligned (labels[t] = target at t); label < 0 masks.
    Handles vocab padding by masking padded columns. Under a step's mesh
    context the logits are this rank's vocab columns (``lm_logits``):
    ``_vocab_parallel_parts``."""
    tp = policy.ctx_tp()
    if tp is not None:
        return _vocab_parallel_parts(logits, labels, vocab_size, tp)
    vp = logits.shape[-1]
    lg = logits.to(torch.float32)
    if vp > vocab_size:
        col = torch.arange(vp, device=lg.device)
        lg = lg + torch.where(col < vocab_size, 0.0, -1e9)[None, None, :]
    logz = torch.logsumexp(lg, dim=-1)
    lab = labels.long().clamp(0, vocab_size - 1)
    gold = lg.gather(-1, lab[..., None])[..., 0]
    valid = (labels >= 0).to(torch.float32)
    return torch.sum((logz - gold) * valid), torch.sum(valid)


def _vocab_parallel_parts(logits, labels, vocab_size: int, tp):
    """``lm_loss_parts`` over the 'model' ranks' vocab columns: the max,
    the sum of exponentials and the gold logit each all-reduced; padded
    columns masked by their global index."""
    vp = logits.shape[-1]
    c0 = tp.rank * vp
    lg = logits.to(torch.float32)
    if vp * tp.size > vocab_size:
        col = c0 + torch.arange(vp, device=lg.device)
        lg = lg + torch.where(col < vocab_size, 0.0, -1e9)[None, None, :]
    m = policy.max_tp(lg.amax(dim=-1), tp)
    se = policy.reduce_from_tp(torch.exp(lg - m[..., None]).sum(-1), tp)
    logz = m + torch.log(se)
    lab = labels.long().clamp(0, vocab_size - 1) - c0
    mine = (lab >= 0) & (lab < vp)
    gold = lg.gather(-1, lab.clamp(0, vp - 1)[..., None])[..., 0]
    gold = policy.reduce_from_tp(torch.where(mine, gold, 0.0), tp)
    valid = (labels >= 0).to(torch.float32)
    return torch.sum((logz - gold) * valid), torch.sum(valid)


def lm_loss(logits, labels, vocab_size: int):
    """The reference's ``lm_loss``: the masked mean of ``lm_loss_parts``."""
    total, count = lm_loss_parts(logits, labels, vocab_size)
    return total / torch.clamp(count, min=1.0)


# ------------------------------------------------------------ input specs --
class TensorSpec(NamedTuple):
    """A meta tensor (shape and dtype, no storage) and its spec."""
    meta: torch.Tensor
    spec: policy.PSpec


def _meta(shape, dtype, spec) -> TensorSpec:
    return TensorSpec(torch.empty(shape, dtype=dtype, device="meta"),
                      policy.PSpec(spec))


def _abstract(fn):
    """The tree ``fn()`` builds, as meta tensors: run under
    ``FakeTensorMode``, so nothing is allocated or drawn."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = fn()
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), tree)


def _dp(mesh):
    dp = policy.dp_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def dp_size(mesh) -> int:
    sizes = policy.mesh_axes(mesh)
    return math.prod(sizes[a] for a in policy.dp_axes(mesh))


def batch_shardable(shape_cfg: ShapeConfig, mesh) -> bool:
    return shape_cfg.global_batch % dp_size(mesh) == 0


def input_specs(arch: ArchConfig, shape_cfg: ShapeConfig, mesh) -> dict:
    """Meta-tensor stand-ins, with their specs, for every model input of
    this cell (no allocation)."""
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    dp = _dp(mesh) if batch_shardable(shape_cfg, mesh) else None
    dt = DTYPES[arch.dtype]
    batch: dict[str, Any] = {}
    if shape_cfg.kind == "decode":
        batch["tokens"] = _meta((b, 1), torch.int32, (dp, None))
    else:
        batch["tokens"] = _meta((b, s), torch.int32, (dp, None))
        if shape_cfg.kind == "train":
            batch["labels"] = _meta((b, s), torch.int32, (dp, None))
    if arch.family == "audio":
        batch["enc_frames"] = _meta((b, arch.encoder.n_frames, arch.d_model),
                                    dt, (dp, None, None))
    if arch.family == "vlm":
        sl = 1 if shape_cfg.kind == "decode" else s
        batch["mrope_positions"] = _meta((3, b, sl), torch.int32,
                                         (None, dp, None))
        if shape_cfg.kind != "decode":
            batch["vision_embeds"] = _meta(
                (b, arch.vision.n_patches, arch.d_model), dt,
                (dp, None, None))
    return batch


# ------------------------------------------------------------ cache specs --
def cache_pspecs(cache_shapes, shape_cfg: ShapeConfig, mesh):
    """Decode-cache specs. batch-shardable cells: batch over dp, cache
    sequence over 'model'. long-context (batch=1): sequence over 'data',
    heads/channels over 'model'."""
    P = policy.PSpec
    shardable = batch_shardable(shape_cfg, mesh)
    sizes = policy.mesh_axes(mesh)
    dp = _dp(mesh)

    def div(axis, dim: int):
        """axis (or axis tuple) only if it divides dim, else None."""
        if axis is None:
            return None
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        prod = 1
        for a in axes:
            prod *= sizes.get(a, 1)
        return axis if prod > 1 and dim % prod == 0 else None

    def leaf_spec(path, x):
        name = policy.leaf_name(path)
        shape = tuple(x.shape)
        nd = len(shape)
        if name == "pos":
            return P((div(dp, shape[0]),) if shardable else ())
        b_ax = div(dp, shape[1]) if (shardable and nd > 1) else None
        if name in ("k", "v"):            # (L,B,T,KH,Dh)
            seq_ax = div("model" if shardable else "data", shape[2])
            kh_ax = None
            if not shardable:
                kh_ax = div("model", shape[3])
            return P((None, b_ax, seq_ax, kh_ax, None))
        if name in ("k_scale", "v_scale"):
            seq_ax = div("model" if shardable else "data", shape[2])
            return P((None, b_ax, seq_ax, None))
        if name in ("c_kv", "k_rope"):    # (L,B,T,r)
            seq_ax = div("model" if shardable else "data", shape[2])
            return P((None, b_ax, seq_ax, None))
        if name in ("conv_x", "conv_b", "conv_c"):  # (L,B,ch,K-1)
            return P((None, b_ax, div("model", shape[2]), None))
        if name == "state":               # (L,B,H,P,N)
            return P((None, b_ax, div("model", shape[2]), None, None))
        return P((None,) * nd)

    return policy.tree_map_with_path(leaf_spec, cache_shapes)


def cache_specs_sds(model: Model, shape_cfg: ShapeConfig, mesh):
    shapes = _abstract(lambda: model.init_cache(
        shape_cfg.global_batch, shape_cfg.seq_len, shape_cfg.kv_dtype,
        device="cpu"))
    specs = cache_pspecs(shapes, shape_cfg, mesh)
    return _paired(shapes, specs)


# ------------------------------------------------------------ train step ---
def tensor_parallel(cfg: ArchConfig, mesh) -> bool:
    """Whether the steps compute each rank's 'model' shard: a 'model'
    axis of more than 1 (which must divide the padded vocab: the loss
    reads vocab-parallel logits)."""
    n = policy.mesh_axes(mesh).get("model", 1)
    if n == 1:
        return False
    if cfg.padded_vocab() % n:
        raise ValueError(f"{cfg.name}: a 'model' axis of {n} does not "
                         f"divide the padded vocab {cfg.padded_vocab()}")
    return True


def _whole(x):
    """A tensor whole on this rank (a DTensor gathered)."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _local(x, mesh):
    """This rank's 'model' shard of a parameter leaf: gathered over the
    data-parallel axes, its placement on 'model' kept. The gathers are
    the process groups' own all-gathers (``policy._all_gather0``), the
    minor mesh axis first: DTensor's redistribute takes the functional
    all-gather, which crashes gloo ranks on CUDA tensors. No step calls
    it (the layers gather their own leaves): it is the yardstick of the
    leaf a rank computes with."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    dp = policy.dp_axes(mesh)
    out = x.to_local()
    for axis, p in reversed(list(zip(policy.mesh_axes(mesh),
                                     x.placements))):
        if axis in dp and p.is_shard():
            out = policy._all_gather0(out.movedim(p.dim, 0),
                                      mesh.get_group(axis)).movedim(0, p.dim)
    return out


def _locals(params, mesh):
    """``_local`` of every parameter leaf."""
    return tree_map(lambda x: _local(x, mesh), params)


def _shard(x):
    """This rank's shard of a parameter leaf (``to_local``), which the
    steps hand to the model: the layers gather it over the data-parallel
    axes where they run (``policy.zero_gather``)."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _zero(params, mesh) -> policy.Zero:
    """The serving steps' ZeRO gathers of ``params`` (no gradient)."""
    return policy.Zero(policy.zero_gathers(params, mesh))


def _dp_placements(mesh):
    """Placements of a tensor each rank computed from its own rows:
    partial sums over the data-parallel axes (those of size > 1), the
    same value along the others."""
    from torch.distributed.tensor import Partial, Replicate
    dp = policy.dp_axes(mesh)
    return [Partial() if a in dp and n > 1 else Replicate()
            for a, n in policy.mesh_axes(mesh).items()]


def _dp_sum(x, mesh):
    """``x`` summed over the data-parallel ranks (every rank gets it)."""
    if dp_size(mesh) == 1:
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, mesh, _dp_placements(mesh),
                              run_check=False).full_tensor()


def make_train_step(model: Model, mesh, shape_cfg: ShapeConfig,
                    optimizer=None, aux_coef: float = MOE_AUX_COEF,
                    compressor=None, *, device=None):
    """compressor: optional train.compression.Compressor — when given, the
    opt_state becomes {"opt": ..., "residual": ...} and the reduced
    gradients go through an error-feedback compress->decompress round
    trip ahead of the optimizer. ``mesh`` None: ``make_host_mesh`` on
    ``device`` (default: the card).

    Returns (train_step, info): train_step(params, opt_state, batch) ->
    (params, opt_state, metrics) with params and opt_state as placed by
    ``sharding.policy.place`` and batch a host batch; it writes none of
    its inputs. info holds ``n_micro``, ``moe_groups`` (the reference's:
    the data-parallel size) and ``grads``, the function the step takes
    its (loss, gradients) from, and ``tensor_parallel`` (whether the
    'model' axis splits the work)."""
    from torch.distributed.tensor import distribute_tensor
    if mesh is None:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(device=device)
    resolve_device(mesh.device_type)
    cfg = model.cfg
    optimizer = optimizer or adamw(1e-4)
    dpn = dp_size(mesh)
    gb = shape_cfg.global_batch
    per_shard = max(1, gb // dpn)
    n_micro = max(1, per_shard // max(shape_cfg.microbatch_seqs_per_shard, 1))
    while gb % n_micro:
        n_micro -= 1
    moe_groups = dpn if gb % dpn == 0 else 1
    local_groups = max(1, moe_groups // dpn)
    acc_dtype = DTYPES[shape_cfg.grad_accum_dtype]
    mb = gb // n_micro
    dp_mean = None if dpn == 1 else (lambda x: _dp_sum(x, mesh) / dpn)
    tp = tensor_parallel(cfg, mesh)

    def grads(params, batch):
        """(mean LM loss of the global batch, gradients as DTensors under
        the parameters' placements, averaged over the micro-batches). The
        model runs on the rank's shards: each leaf that the policy shards
        over the data-parallel axes is gathered where its layer runs and
        its gradient reduce-scattered into the rank's accumulator each
        micro-batch (``policy.zero_gather``); the others take their
        gradients here and are summed over the data-parallel ranks once
        a step."""
        local = shard_batch(batch, mesh, n_micro=n_micro,
                            batch_axes=_BATCH_AXES)
        labels = np.asarray(batch["labels"])
        counts = [max(float((labels[i * mb:(i + 1) * mb] >= 0).sum()), 1.0)
                  for i in range(n_micro)]
        flat = tree_leaves_with_path(params)
        gathers = policy.zero_gathers(params, mesh)
        shards = [_shard(x).detach() for _, x in flat]
        acc = [torch.zeros(x.shape, dtype=acc_dtype, device=x.device)
               for x in shards]
        own = [i for i, (path, _) in enumerate(flat) if path not in gathers]
        for i in own:
            shards[i].requires_grad_()
        token = torch.zeros((), device=shards[0].device, requires_grad=True)
        zero = policy.Zero(gathers, {path: a for (path, _), a in zip(
            flat, acc) if path in gathers}, token)
        p = tree_unflatten(params, shards)
        wrt = [shards[i] for i in own] + [token]
        loss_sum = torch.zeros((), device=token.device)
        rows = local["tokens"].shape[0] // n_micro
        with policy.use_ctx_mesh(mesh, zero=zero):
            for i in range(n_micro):
                micro = {k: v.narrow(_BATCH_AXES.get(k, 0), i * rows, rows)
                         for k, v in local.items()}
                logits, aux, _ = model.forward(
                    p, micro, remat_policy=shape_cfg.remat_policy,
                    moe_groups=local_groups, dp_mean=dp_mean)
                ce, _ = lm_loss_parts(logits, micro["labels"],
                                      cfg.vocab_size)
                loss = ce / counts[i]
                g = torch.autograd.grad(loss + aux_coef * aux / dpn, wrt,
                                        allow_unused=True,
                                        materialize_grads=True)
                torch._foreach_add_([acc[j] for j in own],
                                    [x.to(acc_dtype) for x in g[:-1]])
                loss_sum = loss_sum + loss.detach()
        torch._foreach_div_(acc, n_micro)
        out = [_shard_sum(a, x, mesh) for a, (_, x) in zip(acc, flat)]
        return _dp_sum(loss_sum, mesh) / n_micro, tree_unflatten(params, out)

    @torch.no_grad()
    def compress(g, residual):
        """The compressor on the reduced gradients, whole on every rank
        (top-k and the int8 scale are over the whole tensor), put back
        under their placements."""
        dec, res, _ = compressor.apply(tree_map(_whole, g),
                                       tree_map(_whole, residual))

        def back(new, like):
            return distribute_tensor(new, mesh, like.placements,
                                     src_data_rank=None)
        return (tree_unflatten(g, [back(n, x) for n, x in zip(
                    tree_leaves(dec), tree_leaves(g))]),
                tree_unflatten(residual, [back(n, x) for n, x in zip(
                    tree_leaves(res), tree_leaves(residual))]))

    def train_step(params, opt_state, batch):
        loss, g = grads(params, batch)
        if compressor is not None:
            g, resid = compress(g, opt_state["residual"])
            params2, opt2, om = optimizer.update(g, opt_state["opt"], params)
            opt2 = {"opt": opt2, "residual": resid}
        else:
            params2, opt2, om = optimizer.update(g, opt_state, params)
        om = {k: _whole(v) for k, v in om.items()}
        return params2, opt2, {"loss": loss, **om}

    return train_step, {"n_micro": n_micro, "moe_groups": moe_groups,
                        "grads": grads, "tensor_parallel": tp}


def _shard_sum(acc, like, mesh):
    """This rank's gradient shard ``acc`` (of the parameter ``like``)
    summed over the data-parallel ranks, as a DTensor under ``like``'s
    placements: all-reduced over each data-parallel axis of more than 1
    that replicates the leaf (the process group's own op); along an axis
    that shards it, the gathers' reduce-scatters summed it already."""
    from torch.distributed.tensor import DTensor
    for i, (axis, n) in enumerate(policy.mesh_axes(mesh).items()):
        if axis in policy.dp_axes(mesh) and n > 1 \
                and not like.placements[i].is_shard():
            dist.all_reduce(acc, group=mesh.get_group(i))
    return DTensor.from_local(acc, mesh, like.placements, run_check=False)


# ------------------------------------------------------ serve step fns -----
def context_parallel(shape_cfg: ShapeConfig, mesh) -> bool:
    """Whether a decode step of this cell splits the cache's sequence over
    'data' (``cache_pspecs``): the batch does not split over the
    data-parallel axes and the 'data' axis is more than 1."""
    return (not batch_shardable(shape_cfg, mesh)
            and policy.mesh_axes(mesh).get("data", 1) > 1)


def _decode_ctx(mesh, shape_cfg: ShapeConfig, zero=None):
    """The mesh context of a decode step: with the cache's sequence length
    where it is split over 'data' (``policy.ctx_dp``), and the weights'
    ZeRO gathers (``zero``)."""
    return policy.use_ctx_mesh(mesh, shape_cfg.seq_len if context_parallel(
        shape_cfg, mesh) else None, zero)


def _serve_rows(batch, mesh, shape_cfg: ShapeConfig) -> dict:
    """This rank's rows of a host batch: its block under
    ``policy.batch_spec`` when the batch splits over the data-parallel
    ranks, else the whole batch on every rank (the reference's
    ``input_specs`` replicate it: long_500k's one sequence)."""
    if batch_shardable(shape_cfg, mesh):
        return shard_batch(batch, mesh, batch_axes=_BATCH_AXES)
    return {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)))
            .to(mesh.device_type) for k, v in batch.items()}


def make_prefill_step(model: Model, mesh, shape_cfg: ShapeConfig):
    """prefill_step(params, batch) -> (logits, cache) of this rank's rows
    (``_serve_rows``), each rank's rows one of the reference's
    ``moe_groups`` routing groups; the logits whole, the cache this
    rank's heads under a 'model' split (the function's attribute
    ``tensor_parallel``). Where the batch does not split over the
    data-parallel axes (``context_parallel``), every rank prefills it
    whole, as the reference does, and the cache comes back as this rank's
    blocks of a ``shape_cfg.seq_len`` cache (``place_cache``; the step's
    attribute ``context_parallel``)."""
    dpn = dp_size(mesh)
    moe_groups = dpn if shape_cfg.global_batch % dpn == 0 else 1
    cp = context_parallel(shape_cfg, mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        local = _serve_rows(batch, mesh, shape_cfg)
        with policy.use_ctx_mesh(mesh, zero=_zero(params, mesh)):
            logits, cache = model.prefill(
                tree_map(_shard, params), local, kv_dtype=shape_cfg.kv_dtype,
                moe_groups=max(1, moe_groups // dpn),
                last_only=shape_cfg.prefill_last_only)
        if cp:
            cache = place_cache(cache, model, mesh, shape_cfg)
        return logits, cache
    prefill_step.tensor_parallel = tensor_parallel(model.cfg, mesh)
    prefill_step.context_parallel = cp
    return prefill_step


def make_decode_step(model: Model, mesh, shape_cfg: ShapeConfig):
    """decode_step(params, cache, batch) -> (logits, cache) of this rank's
    rows; ``cache`` is this rank's (``make_prefill_step``'s, or
    ``decode_cache``'s), updated in place. Where the batch does not split
    over the data-parallel axes (the step's attribute
    ``context_parallel``), the cache holds this rank's blocks of the
    sequence, and the attention combines the 'data' ranks' partials."""
    @torch.no_grad()
    def decode_step(params, cache, batch):
        local = _serve_rows(batch, mesh, shape_cfg)
        with _decode_ctx(mesh, shape_cfg, _zero(params, mesh)):
            return model.decode(tree_map(_shard, params), cache, local)
    decode_step.tensor_parallel = tensor_parallel(model.cfg, mesh)
    decode_step.context_parallel = context_parallel(shape_cfg, mesh)
    return decode_step


def decode_cache(model: Model, mesh, shape_cfg: ShapeConfig, device=None):
    """An empty decode cache of this rank: its rows (``_serve_rows``),
    under a 'model' split its heads, and where the batch does not split
    over the data-parallel axes its blocks of the sequence."""
    rows = shape_cfg.global_batch // (dp_size(mesh) if batch_shardable(
        shape_cfg, mesh) else 1)
    with _decode_ctx(mesh, shape_cfg):
        return model.init_cache(rows, shape_cfg.seq_len, shape_cfg.kv_dtype,
                                device=device)


def place_cache(cache, model: Model, mesh, shape_cfg: ShapeConfig):
    """A prompt's decode cache (a prefill's, whole on this rank: its
    sequence axes the prompt's, the audio family's cross cache the
    encoder's frames) placed into this rank's blocks of a
    ``shape_cfg.seq_len`` cache (``decode_cache``'s layout: each sequence
    axis split over 'data' where the ranks divide it, the positions
    outside the prompt zero). The leaves keep the prefill's dtypes; the
    others (``pos``, the SSM state) are kept as they are."""
    from repro_torch.serve.kvcache import SEQ_LEAVES, seq_block
    frames = (model.cfg.encoder.n_frames if model.cfg.encoder is not None
              else None)

    def put(path, x):
        if policy.leaf_name(path) not in SEQ_LEAVES:
            return x
        start, t = seq_block(frames if path[0] == "cross"
                             else shape_cfg.seq_len)
        start = start or 0
        out = x.new_zeros(x.shape[:2] + (t,) + x.shape[3:])
        n = max(0, min(t, x.shape[2] - start))
        out[:, :, :n] = x[:, :, start:start + n]
        return out
    with _decode_ctx(mesh, shape_cfg):
        return policy.tree_map_with_path(put, cache)


# --------------------------------------------------------- param helpers ---
def abstract_params(model: Model):
    """The model's parameter tree as meta tensors (a meta-device init: no
    allocation, no random draw)."""
    return _abstract(lambda: model.init(torch.Generator(), device="cpu"))


def _drop_fsdp(spec: tuple) -> policy.PSpec:
    """Serving-mode param sharding: keep TP ('model'), drop ZeRO axes —
    weights stay resident instead of being all-gathered every step."""
    def clean(part):
        if part is None:
            return None
        axes = (part,) if isinstance(part, str) else tuple(part)
        keep = tuple(a for a in axes if a == "model")
        return keep[0] if len(keep) == 1 else (keep if keep else None)
    return policy.PSpec(clean(p) for p in spec)


def _paired(shapes, specs):
    """Each meta tensor of ``shapes`` beside its spec in ``specs``."""
    return policy.tree_map_with_path(
        lambda path, x: TensorSpec(x, policy.at_path(specs, path)), shapes)


def params_sds(model: Model, mesh, tp_only: bool = False):
    """(tree of ``TensorSpec``, tree of specs) of the model's parameters
    on ``mesh`` (a ``DeviceMesh`` or a ``policy.MeshShape``)."""
    shapes = abstract_params(model)
    specs = policy.param_pspecs(shapes, mesh)
    if tp_only:
        specs = policy.tree_map_with_path(lambda _, s: _drop_fsdp(s), specs)
    return _paired(shapes, specs), specs


def opt_state_sds(optimizer, params_shapes, mesh):
    shapes = _abstract(lambda: optimizer.init(params_shapes))
    specs = policy.param_pspecs(shapes, mesh)
    return _paired(shapes, specs), specs


def count_params_from_shapes(shapes) -> int:
    return sum(math.prod(x.shape) if x.shape else 1
               for x in tree_leaves(shapes))


def count_active_params(shapes, arch: ArchConfig) -> int:
    """MoE: non-routed params + top_k/E of routed expert params."""
    if arch.moe is None:
        return count_params_from_shapes(shapes)
    total = routed = 0

    def visit(path, x):
        nonlocal total, routed
        n = math.prod(x.shape) if x.shape else 1
        total += n
        if policy.leaf_name(path) in ("w_gate_e", "w_up_e", "w_down_e"):
            routed += n
    policy.tree_map_with_path(visit, shapes)
    frac = arch.moe.top_k / arch.moe.num_experts
    return int(total - routed + routed * frac)
