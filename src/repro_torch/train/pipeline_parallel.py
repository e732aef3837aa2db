"""Pipeline parallelism over the 'pod' axis (DESIGN.md §6), the port of the
reference's ``train/pipeline_parallel.py``.

A GPipe fill/drain schedule over the ranks of one mesh axis, one stage a
rank: micro-batch activations flow stage to stage by point-to-point
sends while every stage stays busy in the steady state. Forward only,
for serving or evaluation or as a building block (training composes it
with autograd per micro-batch chunk), as the reference's.

The reference's ``ppermute`` is a ring inside one SPMD program. Here each
rank runs its own stage, and a stage sends only at the ticks it computed
a micro-batch, which its successor receives at the same tick. Sends and
receives of one tick go out together through
``torch.distributed.batch_isend_irecv``: a middle stage both sends and
receives, and blocking sends in a chain can deadlock. On the CPU the
ranks are gloo processes; on cards, NCCL ranks, one card a rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.train.optimizer import tree_map


def pipeline_forward(stage_fn, params_by_stage, x_micro, *, mesh,
                     axis: str = "pod"):
    """stage_fn(stage_params, h) -> h (same shape and dtype);
    params_by_stage: tree whose tensors have a leading [n_stages] dim,
    whole on every rank (each rank takes its stage's slice); x_micro:
    (n_micro, mb, ...) micro-batched inputs, the same on every rank.

    The reference's contract: ``n_micro + n_stages - 1`` ticks; stage 0
    takes micro-batch t at tick t, stage s works on micro-batch t - s,
    the last stage emits micro-batch t - (n_stages - 1). Returns the
    (n_micro, mb, ...) outputs of the last stage on every rank of the
    axis (an all-reduce of them, zeros elsewhere: the reference's
    ``psum``)."""
    names = list(mesh.mesh_dim_names)
    dim = names.index(axis)
    n_stages = mesh.size(dim)
    stage = mesh.get_local_rank(dim)
    group = mesh.get_group(dim)
    ranks = dist.get_process_group_ranks(group)
    sp = tree_map(lambda a: a[stage], params_by_stage)
    n_micro = x_micro.shape[0]
    outs = torch.zeros_like(x_micro)
    h = None
    for t in range(n_micro + n_stages - 1):
        m = t - stage                      # this stage's micro-batch
        works = 0 <= m < n_micro
        ops = []
        if works:
            h_out = stage_fn(sp, x_micro[m] if stage == 0 else h)
            if stage == n_stages - 1:
                outs[m] = h_out.to(outs.dtype)
            else:
                ops.append(dist.P2POp(dist.isend, h_out.contiguous(),
                                      ranks[stage + 1], group))
        # the predecessor worked on micro-batch m + 1 at this tick
        if stage > 0 and 0 <= m + 1 < n_micro:
            h = torch.empty_like(x_micro[0])
            ops.append(dist.P2POp(dist.irecv, h, ranks[stage - 1], group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    dist.all_reduce(outs, group=group)   # zeros but on the last stage
    return outs
