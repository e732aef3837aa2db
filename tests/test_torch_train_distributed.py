"""The port's data-parallel train step and elastic checkpoints across
ranks: four gloo processes on the CPU (one ``torch.multiprocessing``
spawn), against the reference on two of the suite's forced host devices.

* A (data 2, model 2) mesh runs a phi3.5-moe smoke step (f32, capacity
  factor 0.5 so that the routing groups drop tokens) with ``n_micro`` 2:
  its loss and gradients equal the reference's step at dp = 2 on a
  (2, 1) mesh (``moe_groups`` 2), which pins the rows each rank computes
  in each micro-step and the MoE groups (tolerances as
  tests/test_torch_train_step.py: loss 1e-6 relative, gradients atol
  1e-6 + rtol 1e-4; the ranks' sums add in another order).
* A tree saved on a (4, 1) mesh restores on (2, 2) under the policy's
  placements, each rank holding the slice the reference's sharding gives
  it; on (pod 2, data 2, model 1), a dim sharded over ('pod', 'data') is
  split pod-major (tests/test_distributed.py's elastic check, mirrored).
"""
import os
import pickle
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as j_base  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models.factory import build_model as j_build  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"
B, S, WORLD = 4, 32, 4


def _cfg(registry):
    cfg = registry.smoke_config(ARCH).replace(dtype="float32")
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))


def _batch(vocab):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][1, :7] = -1          # masked labels in rank 1's rows
    return batch


def _worker(rank, port, tmp):
    """One rank: the train step on (2, 2), then the elastic checkpoint."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs import registry as t_registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.factory import build_model
    from repro_torch.models.transformer import params_from_jax
    from repro_torch.sharding.policy import place
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.optimizer import Optimizer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_mesh_compat((2, 2), ("data", "model"), device="cpu")
        with open(os.path.join(tmp, "params.pkl"), "rb") as f:
            params = params_from_jax(pickle.load(f), device="cpu")
        cfg = _cfg(t_registry)
        ident = Optimizer(init=lambda p: {}, update=lambda g, s, p: (g, s, {}))
        fn, info = make_train_step(build_model(cfg), mesh, ShapeConfig(
            "t", "train", S, B, microbatch_seqs_per_shard=1), ident)
        g, _, m = fn(place(params, mesh), {}, _batch(cfg.vocab_size))
        whole = {k: v.full_tensor().numpy() for k, v in _flat(g).items()}
        if rank == 0:
            with open(os.path.join(tmp, "port.pkl"), "wb") as f:
                pickle.dump((float(m["loss"]), whole, info["n_micro"],
                             info["moe_groups"]), f)

        # elastic checkpoint: saved on (4, 1), restored on (2, 2)
        tree = {"wq": torch.arange(128, dtype=torch.bfloat16).reshape(16, 8),
                "scale": torch.ones(5)}
        mesh41 = make_mesh_compat((4, 1), ("data", "model"), device="cpu")
        ck.save(os.path.join(tmp, "ckpt"), 1, place(tree, mesh41),
                mesh=mesh41)
        back = ck.restore(os.path.join(tmp, "ckpt"), 1, tree, mesh=mesh)
        assert back["wq"].placements == (Shard(0), Shard(1))
        assert back["scale"].placements == (Replicate(), Replicate())
        d, mo = mesh.get_coordinate()
        assert torch.equal(back["wq"].to_local(),
                           tree["wq"][8 * d:8 * d + 8, 4 * mo:4 * mo + 4])
        assert torch.equal(back["wq"].full_tensor(), tree["wq"])
        # pod-major: ('pod', 'data') shards rows over 4 ranks, pod first
        mesh3 = make_mesh_compat((2, 2, 1), ("pod", "data", "model"),
                                 device="cpu")
        placed = place(tree, mesh3)["wq"]
        assert placed.placements == (Shard(0), Shard(0), Replicate())
        p, dd, _ = mesh3.get_coordinate()
        r = 2 * p + dd
        assert torch.equal(placed.to_local(), tree["wq"][4 * r:4 * r + 4])
        with open(os.path.join(tmp, f"ok{rank}"), "w") as f:
            f.write("ok")
    finally:
        dist.destroy_process_group()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_dp2_moe_step_and_elastic_checkpoint_on_four_ranks(tmp_path):
    import torch.multiprocessing as mp

    cfg = _cfg(j_registry)
    p = j_build(cfg).init(jax.random.PRNGKey(0))
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, p), f)
    ctx = mp.start_processes(_worker, args=(_free_port(), str(tmp_path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    for _ in range(240):                    # at most 240 s
        if ctx.join(timeout=1):
            break
    else:
        for proc in ctx.processes:
            proc.kill()
        pytest.fail("the four ranks did not finish in 240 s")
    assert all((tmp_path / f"ok{r}").exists() for r in range(WORLD))

    # the reference's step at dp = 2
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(2, 1),
                             ("data", "model"))
    ident = j_opt.Optimizer(init=lambda p: {},
                            update=lambda g, s, p: (g, s, {}))
    fn, info = j_steps.make_train_step(
        j_build(cfg), mesh, j_base.ShapeConfig(
            "t", "train", S, B, microbatch_seqs_per_shard=1), ident)
    with mesh:
        jg, _, jm = jax.jit(fn)(p, {}, {k: jnp.asarray(v) for k, v in
                                        _batch(cfg.vocab_size).items()})
    assert (info["n_micro"], info["moe_groups"]) == (2, 2)
    with open(tmp_path / "port.pkl", "rb") as f:
        loss, grads, n_micro, moe_groups = pickle.load(f)
    assert (n_micro, moe_groups) == (2, 2)
    assert loss == pytest.approx(float(jm["loss"]), rel=1e-6)
    want = _flat(jax.tree.map(np.asarray, jg))
    assert sorted(grads) == sorted(want)
    for k in want:
        np.testing.assert_allclose(grads[k], want[k], atol=1e-6, rtol=1e-4,
                                   err_msg=k)
