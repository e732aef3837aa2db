"""Production-mesh dry-run: every (architecture x input shape) cell of the
port's steps on a fake process group of 256 or 512 ranks, counted on
fake tensors, with the roofline terms on H100 figures (``launch/hw``);
one JSON artifact a cell. The port of the reference's
``launch/dryrun.py``.

Usage:
  python -m repro_torch.launch.dryrun --arch mamba2-130m --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --sweep [--mesh both] [--variant v --set k=v]

No card and no compiler are involved. A cell runs in a process of its
own (the default process group is the process's): ``torch.distributed``
with the ``fake`` backend (``FakeStore``) as rank 0 of 256 (or 512)
ranks, ``launch/mesh.make_production_mesh`` on it, the parameters as
fake tensors placed by ``sharding.policy.place``, and the step of
``launch/steps`` run once under ``FakeTensorMode`` and
``costing.OpCounter``. The artifact keeps the reference's keys:

* ``per_device.hlo_flops`` is what rank 0 computed (no HLO is involved:
  the name is kept so the two packages' artifacts read alike), the
  backward and the remat recompute included; ``global.hlo_flops`` is
  that times the ranks. ``useful_flops_ratio`` = model FLOPs (6 N D or
  2 N D) / (rank 0's FLOPs x ranks). Every family's step is
  tensor-parallel over 'model' (``launch/steps``): rank 0 computes its
  data-parallel rows on its 'model' shard (heads, ``d_ff``, experts,
  vocab, SSM heads), and only the leaves the policy replicates (norms,
  the SSM's B and C projections, MLA's latent projections, the MoE
  router and its routing) are computed on every 'model' rank, as are
  the q heads that pad a head count up to the axis (whisper-tiny's 6 to
  16). ``step_info["tensor_parallel"]`` says whether the 'model' axis
  split the work. A decode cell whose batch does not split over the
  data-parallel axes (long_500k) is context-parallel
  (``step_info["context_parallel"]``): rank 0 holds and reads its block
  of the cache's sequence, ``step_info["cache_bytes_rank"]`` bytes.
  ``step_info["state_bytes_rank"]`` and ``["gathered_bytes_rank"]``
  (``zero_bytes``) are what rank 0 holds of the parameters' state (its
  shards, with the AdamW m and v and the gradient accumulator in a train
  cell) and the most it holds gathered at once: each layer gathers its
  ZeRO-sharded leaves as it runs (``policy.zero_gather``), so rank 0's
  all-gathers and reduce-scatters come a layer's at a time.
* ``collectives`` are rank 0's (``OpCounter.collectives``), and
  ``per_device.hbm_bytes`` is ``costing.analytic_bytes`` over the ranks.
* ``roofline_terms_s``: ``compute_s`` = rank 0's FLOPs over the bf16
  tensor-core peak, ``memory_s`` = its HBM bytes over HBM bandwidth,
  ``collective_s`` = its collective bytes over ``hw.NVLINK_BW``. A
  roofline on data-sheet figures, not a measurement.
* ``seconds`` holds this process's set-up and counted-run seconds;
  ``xla_cost_analysis_raw`` and ``memory_analysis_per_device`` are null
  (there is no compiler).

The optimizer state's step count is a real 0-d CPU tensor (AdamW reads it
on the host), and the host batch's integer leaves are real numpy zeros
(the train step counts valid labels with numpy); float inputs are fake.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
ART_DIR = ROOT / "artifacts" / "dryrun_torch"


def model_flops(kind: str, n_active: int, global_batch: int,
                seq_len: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (forward-only); D = tokens."""
    tokens = global_batch * (1 if kind == "decode" else seq_len)
    return (6.0 if kind == "train" else 2.0) * n_active * tokens


def fake_world(world: int) -> None:
    """This process as rank 0 of a fake process group of ``world``
    ranks (collectives run nowhere and return their outputs' shapes)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"the process group has "
                               f"{dist.get_world_size()} ranks, the cell "
                               f"needs {world}: one cell a process")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _cell_config(arch_name, shape_name, overrides):
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.shapes import SHAPES
    arch = get_arch(arch_name).replace(head_pad_to=16)
    shape = SHAPES[shape_name]
    shape_kw = {k: v for k, v in overrides.items()
                if k in type(shape).__dataclass_fields__}
    arch_kw = {k: v for k, v in overrides.items()
               if k in type(arch).__dataclass_fields__}
    if shape_kw:
        shape = dataclasses.replace(shape, **shape_kw)
    if arch_kw:
        arch = arch.replace(**arch_kw)
    if overrides.get("tuned"):
        from repro_torch.configs.deployment import tuned_shape
        shape = tuned_shape(arch, shape)
    return arch, shape


STACKS = ("layers", "enc_layers", "dec_layers")


def zero_bytes(shapes, specs, mesh, shape) -> tuple[float, float]:
    """(``state_bytes_rank``, ``gathered_bytes_rank``) of a cell, counted
    from the parameters' specs on ``mesh`` (a ``DeviceMesh`` or a
    ``policy.MeshShape``): the rank's shards of the parameters and, in a
    train cell, of the AdamW m and v (f32) and of the gradient
    accumulator (``grad_accum_dtype``); and the most a rank holds
    gathered at once, the leaves the policy shards over data-parallel
    axes of more than 1, whole over them (the rank's 'model' shard), of
    the largest layer of a stack plus those outside the stacks."""
    import math

    from repro_torch.models.common import DTYPES
    from repro_torch.sharding import policy
    from repro_torch.train.optimizer import tree_leaves_with_path
    sizes = policy.mesh_axes(mesh)
    extra = (2 * 4 + DTYPES[shape.grad_accum_dtype].itemsize
             if shape.kind == "train" else 0)
    state = outside = 0.0
    layer: dict[str, float] = {}
    for path, x in tree_leaves_with_path(shapes):
        spec = policy.at_path(specs, path)
        axes = [a for part in spec if part is not None
                for a in ((part,) if isinstance(part, str) else part)]
        n = math.prod(x.shape)
        state += n / math.prod(sizes[a] for a in axes) * (
            x.element_size() + extra)
        if not any(a in ("pod", "data") and sizes[a] > 1 for a in axes):
            continue
        whole = n / math.prod(sizes[a] for a in axes if a == "model") \
            * x.element_size()
        if path[0] in STACKS:
            layer[path[0]] = layer.get(path[0], 0.0) + whole / x.shape[0]
        else:
            outside += whole
    return state, max(layer.values(), default=0.0) + outside


def _host_batch(arch, shape, mesh):
    """Zeros of every model input of the cell: integer leaves as numpy
    arrays, float leaves as tensors (fake under ``FakeTensorMode``)."""
    import numpy as np
    import torch

    from repro_torch.launch import steps
    out = {}
    for k, ts in steps.input_specs(arch, shape, mesh).items():
        m = ts.meta
        out[k] = (torch.zeros(m.shape, dtype=m.dtype)
                  if m.dtype.is_floating_point
                  else np.zeros(m.shape, dtype=np.int32))
    return out


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             overrides: dict, variant: str = "") -> dict:
    import torch
    from torch._subclasses.fake_tensor import (FakeTensorMode,
                                               unset_fake_temporarily)

    from repro_torch.configs.shapes import shape_applicable
    from repro_torch.launch import costing, hw, steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.factory import build_model
    from repro_torch.sharding import policy
    from repro_torch.train.optimizer import adamw, tree_map

    t0 = time.time()
    arch, shape = _cell_config(arch_name, shape_name, overrides)
    ok, reason = shape_applicable(arch, shape)
    mesh_name = "multi" if multi_pod else "single"
    meta = dict(arch=arch_name, shape=shape_name, mesh=mesh_name,
                variant=variant, overrides=overrides)
    if not ok:
        return {**meta, "status": "skipped", "reason": reason}

    fake_world(hw.CHIPS_MULTI_POD if multi_pod else hw.CHIPS_SINGLE_POD)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    chips = mesh.size()
    model = build_model(arch)
    shapes = steps.abstract_params(model)
    _, specs = steps.params_sds(model, mesh, tp_only=shape.params_tp_only)
    shardings = policy.tree_map_with_path(
        lambda _, s: policy.placements(s, mesh), specs)
    n_total = steps.count_params_from_shapes(shapes)
    n_active = steps.count_active_params(shapes, arch)
    cache_bytes = (0.0 if shape.kind == "train" else costing.tree_bytes(
        steps.cache_specs_sds(model, shape, mesh)))

    def fake_zeros(tree):
        return tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype), tree)

    state_bytes, gathered_bytes = zero_bytes(shapes, specs, mesh, shape)
    info = {"n_micro": 1,
            "tensor_parallel": steps.tensor_parallel(arch, mesh)}
    with FakeTensorMode(allow_non_fake_inputs=True):
        plain = fake_zeros(shapes)
        params = policy.place(plain, mesh, shardings)
        batch = _host_batch(arch, shape, mesh)
        if shape.kind == "train":
            opt = adamw(1e-4)
            step_fn, info = steps.make_train_step(model, mesh, shape, opt)
            info = {k: v for k, v in info.items() if k != "grads"}
            state = opt.init(plain)
            with unset_fake_temporarily():
                count = torch.zeros((), dtype=torch.int32)
            args = (params, {"m": policy.place(state["m"], mesh, shardings),
                             "v": policy.place(state["v"], mesh, shardings),
                             "count": count}, batch)
        elif shape.kind == "prefill":
            step_fn = steps.make_prefill_step(model, mesh, shape)
            args = (params, batch)
        else:
            step_fn = steps.make_decode_step(model, mesh, shape)
            cache = steps.decode_cache(model, mesh, shape, device="cpu")
            info["context_parallel"] = steps.context_parallel(shape, mesh)
            info["cache_bytes_rank"] = costing.tree_bytes(cache)
            args = (params, cache, batch)
        info.update(state_bytes_rank=state_bytes,
                    gathered_bytes_rank=gathered_bytes)
        t_setup = time.time() - t0
        _, counter = costing.count_ops(step_fn, *args)
    t_count = time.time() - t0 - t_setup

    wf = (steps.dp_size(mesh)
          if shape.params_tp_only and shape.kind != "train" else 1.0)
    mem = costing.analytic_bytes(shape.kind, arch, shape, n_total,
                                 info.get("n_micro", 1), cache_bytes,
                                 chips, weight_read_factor=wf)
    mf = model_flops(shape.kind, n_active, shape.global_batch,
                     shape.seq_len)
    coll = counter.collectives()
    flops_dev = float(counter.flops)
    bytes_dev = mem.total / chips
    coll_dev = float(coll["total_bytes"])
    terms = {
        "compute_s": flops_dev / hw.PEAK_FLOPS_BF16,
        "memory_s": bytes_dev / hw.HBM_BW,
        "collective_s": coll_dev / hw.NVLINK_BW,
    }
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())
    return {
        **meta, "status": "ok", "chips": chips, "step_info": info,
        "seconds": {"setup": round(t_setup, 1), "count": round(t_count, 1)},
        "per_device": {"hlo_flops": flops_dev,
                       "matmul_flops": float(counter.matmul_flops),
                       "hbm_bytes": bytes_dev, "collective_bytes": coll_dev},
        "global": {"hlo_flops": flops_dev * chips, "hbm_bytes": mem.total,
                   "collective_bytes": coll_dev * chips},
        "mem_breakdown_global": mem.breakdown,
        "collectives": coll,
        "xla_cost_analysis_raw": None,
        "memory_analysis_per_device": None,
        "cache_bytes_global": cache_bytes,
        "params": {"total": n_total, "active": n_active},
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / (flops_dev * chips) if flops_dev
                               else None),
        "roofline_terms_s": terms, "dominant": dominant,
        "step_time_bound_s": bound_s,
        "roofline_fraction": (terms["compute_s"] / bound_s
                              if bound_s else None),
        "hardware": {"bf16_flops": hw.PEAK_FLOPS_BF16, "hbm_bw": hw.HBM_BW,
                     "nvlink_bw": hw.NVLINK_BW, "part": hw.SXM.part},
    }


def cell_path(arch: str, shape: str, mesh: str, variant: str = "",
              out: Path = ART_DIR) -> Path:
    v = f"__{variant}" if variant else ""
    safe = arch.replace("/", "_").replace(".", "_")
    return Path(out) / f"{safe}__{shape}__{mesh}{v}.json"


def all_cells():
    from repro_torch.configs.registry import ARCHS
    from repro_torch.configs.shapes import SHAPES
    for a in ARCHS:
        for s in SHAPES:
            yield a, s


def _run_child(args, arch, shape, mesh) -> None:
    """One cell in a process of its own; an error or a timeout is
    written to the cell's artifact."""
    path = cell_path(arch, shape, mesh, args.variant, args.out)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--mesh", mesh, "--out", str(args.out)]
    if args.variant:
        cmd += ["--variant", args.variant]
    if args.tuned:
        cmd += ["--tuned"]
    for kv in args.set:
        cmd += ["--set", kv]
    src = str(ROOT / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    print(f"=== {arch} x {shape} x {mesh}", flush=True)
    try:
        r = subprocess.run(cmd, timeout=args.timeout, capture_output=True,
                           text=True, env=env)
    except subprocess.TimeoutExpired:
        path.write_text(json.dumps(
            dict(arch=arch, shape=shape, mesh=mesh, variant=args.variant,
                 status="timeout"), indent=1))
        print("TIMEOUT", flush=True)
        return
    if r.returncode != 0:
        err = (r.stderr or "")[-2000:]
        path.write_text(json.dumps(
            dict(arch=arch, shape=shape, mesh=mesh, variant=args.variant,
                 status="error", error=err), indent=1))
        print(f"ERROR: {err[-400:]}", flush=True)
    else:
        print(r.stdout[-400:], flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="")
    ap.add_argument("--set", action="append", default=[],
                    help="override: key=value (shape or arch field)")
    ap.add_argument("--tuned", action="store_true",
                    help="apply configs/deployment.py tuned settings")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--out", type=Path, default=ART_DIR,
                    help="artifact directory")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    if args.tuned:
        overrides["tuned"] = True

    args.out.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.sweep:
        for arch, shape in all_cells():
            for mesh in meshes:
                path = cell_path(arch, shape, mesh, args.variant, args.out)
                if path.exists() and not args.force:
                    print(f"skip (exists): {path.name}")
                    continue
                _run_child(args, arch, shape, mesh)
        return 0

    if not (args.arch and args.shape):
        ap.error("--arch/--shape required (or --sweep)")
    if len(meshes) > 1:            # one process group a process
        for mesh in meshes:
            _run_child(args, args.arch, args.shape, mesh)
        return 0
    res = run_cell(args.arch, args.shape, meshes[0] == "multi", overrides,
                   args.variant)
    path = cell_path(args.arch, args.shape, meshes[0], args.variant,
                     args.out)
    path.write_text(json.dumps(res, indent=1, default=str))
    print(json.dumps({k: res.get(k) for k in (
        "arch", "shape", "mesh", "status", "roofline_terms_s",
        "dominant", "useful_flops_ratio", "roofline_fraction",
        "seconds", "reason")}, indent=1, default=str))
    print(f"artifact: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
