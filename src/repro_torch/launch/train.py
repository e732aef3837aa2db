"""Training launcher: fault-tolerant LM training on any --arch, the port
of the reference's ``launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --steps 50 --batch 8 --seq 128 [--full] [--compress topk] \\
      [--inject-failure 7] [--ckpt-dir DIR] [--device cuda]

The mesh is (data, model) = (ranks present, 1): one card, or the
processes of a ``torchrun`` job (``launch/mesh.make_host_mesh``); with
``--full`` on a job of the production mesh's ranks (``launch/hw.
CHIPS_SINGLE_POD``), the production mesh (data 16, model 16), as the
reference's ``--full`` takes, where the dense, vlm, ssm and hybrid
families' steps are tensor-parallel over 'model' (``launch/steps``). Without
``--full`` the arch's smoke config trains; with it, the full config
(``--arch zamba2-1.2b --full`` trains its 1.2 B parameters at full width
and depth on one card). Weights are random, drawn from a generator seeded
with 0 on the device; the data is ``lm_token_batches`` (seed 0), whose
even positions repeat the previous token, so the loss can fall.
``--device`` defaults to ``cuda``: without a card that raises, and
``--device cpu`` runs the plain versions of the kernels on a gloo world.
"""
from __future__ import annotations

import argparse
import tempfile
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="the arch's full config vs its smoke config")
    ap.add_argument("--compress", choices=["none", "topk", "int8"],
                    default="none")
    ap.add_argument("--inject-failure", type=int, default=-1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


@dataclass
class TrainSetup:
    """Everything ``main`` builds before it runs the loop."""
    cfg: Any
    model: Any
    mesh: Any
    shape: Any
    info: dict
    params: Any
    opt_state: Any
    batches: Callable[[int], dict]
    runtime: Any
    ckpt_dir: str


def setup(args, *, cfg=None, log: Callable[[str], None] = print
          ) -> TrainSetup:
    """What ``main`` runs, built from its parsed ``args``. ``cfg`` is a
    hook for a caller that trains another config than ``--arch`` names
    (``chip_smoke.py``'s recovery drill: zamba2-1.2b at full width, its
    depth cut); the command line has no flag for it, as the reference's
    has none."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch, smoke_config
    from repro_torch.data.synthetic import lm_token_batches
    from repro_torch.device import resolve_device
    from repro_torch.launch import hw
    from repro_torch.launch.mesh import (init_world, make_host_mesh,
                                         make_production_mesh)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.factory import build_model, count_params
    from repro_torch.sharding.policy import mesh_axes, place
    from repro_torch.train.compression import (int8_compressor,
                                               topk_compressor)
    from repro_torch.train.optimizer import adamw, cosine_schedule
    from repro_torch.train.runtime import RuntimeConfig, TrainRuntime

    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_arch(args.arch) if args.full else smoke_config(args.arch)
    full_mesh = args.full and init_world(dev) == hw.CHIPS_SINGLE_POD
    mesh = (make_production_mesh(device=dev) if full_mesh
            else make_host_mesh(device=dev))
    model = build_model(cfg)
    shape = ShapeConfig(name="cli", kind="train", seq_len=args.seq,
                        global_batch=args.batch)
    opt = adamw(cosine_schedule(args.lr, warmup=max(2, args.steps // 10),
                                total=args.steps))
    comp = {"none": None, "topk": topk_compressor(0.05),
            "int8": int8_compressor()}[args.compress]
    step_fn, info = make_train_step(model, mesh, shape, opt,
                                    compressor=comp)

    gdev = torch.device(mesh.device_type)
    params = model.init(torch.Generator(device=gdev).manual_seed(0),
                        device=gdev)
    log(f"arch={cfg.name} params={count_params(params):,} "
        f"mesh={mesh_axes(mesh)} n_micro={info['n_micro']} "
        f"moe_groups={info['moe_groups']} "
        f"tensor_parallel={info['tensor_parallel']} device={gdev}")
    opt_state = opt.init(params)
    if comp is not None:
        opt_state = {"opt": opt_state, "residual": comp.init(params)}
    params, opt_state = place(params, mesh), place(opt_state, mesh)

    data = list(lm_token_batches(cfg.vocab_size, args.batch, args.seq,
                                 args.steps + 1, seed=0))
    extras = {}
    if cfg.family == "audio":
        extras["enc_frames"] = np.random.default_rng(0).standard_normal(
            (args.batch, cfg.encoder.n_frames, cfg.d_model)).astype(
                np.float32) * 0.1
    if cfg.family == "vlm":
        extras["mrope_positions"] = np.broadcast_to(
            np.arange(args.seq, dtype=np.int32)[None, None],
            (3, args.batch, args.seq)).copy()

    def batches(step):
        return {**data[step % len(data)], **extras}

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    rt = TrainRuntime(step_fn, RuntimeConfig(ckpt_dir,
                                             ckpt_every=args.ckpt_every),
                      mesh=mesh, log=log)
    if args.inject_failure >= 0:
        rt.inject_failure_at = {args.inject_failure}
    return TrainSetup(cfg, model, mesh, shape, info, params, opt_state,
                      batches, rt, ckpt_dir)


def main(argv=None):
    """Returns (params, opt_state, history, setup)."""
    args = parse_args(argv)
    st = setup(args)
    params, opt_state, hist = st.runtime.run(st.params, st.opt_state,
                                             st.batches,
                                             num_steps=args.steps)
    losses = [h["loss"] for h in hist]
    print(f"first loss {losses[0]:.4f} -> last {losses[-1]:.4f} | "
          f"recoveries={st.runtime.recoveries} "
          f"stragglers={len(st.runtime.straggler.flagged)}")
    print(f"checkpoints in {st.ckpt_dir}")
    return params, opt_state, hist, st


if __name__ == "__main__":
    main()
