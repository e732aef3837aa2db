"""The port's ZeRO steps (``launch/steps`` on data-parallel axes of more
than 1: each layer's weights gathered over them as the layer runs, inside
its checkpointed body, and its gradient reduce-scattered into the rank's
shard) against the reference and the one-rank port path: four gloo
processes on the CPU (one ``torch.multiprocessing`` spawn), f32 smoke
configs of zamba2-1.2b (the shared block outside the stack), deepseek-7b,
phi3.5-moe (experts whose ``fsdp`` dim is not the first), deepseek-v2
(MLA, and leaves replicated over 'data'), qwen2-vl-72b (QKV biases and
M-RoPE), whisper-tiny (two stacks and ``dec_pos``) and mamba2-130m (tied
embeddings), on (data 2, model 1), (4, 1), (2, 2) and (pod 2, data 2,
model 1), under remat "full" and "dots", and "none" on mamba2-130m.

* One AdamW step (lr 1e-3, eps 1e-3: the first step moves a parameter by
  lr g / (|g| + eps), smooth in g, so gradients within their tolerance
  give parameters within it): the loss within 1e-6 relative, and the
  gradients (gathered whole), the new parameters and the AdamW m and v
  within atol 1e-6 + rtol 1e-4 (tests/test_torch_train_distributed.py's)
  of the reference's step at the same data-parallel size and of the
  one-rank port path. Each rank's shards of the new parameters, m and v
  are the slices the reference's ``NamedSharding`` gives that device.
* ``costing.OpCounter`` on the meshes whose 'model' axis is 1, per
  micro-batch: the all-gathers are the leaves the policy shards over the
  data-parallel axes (one an axis), a layer's times the layers (twice
  under "full" and "dots": the backward's recompute gathers the layer
  again), plus the leaves outside the stacks once; no all-gather's output
  is larger than the largest such leaf; the reduce-scatters are one a
  gather of the forward.
* Under "full" and "dots" no tensor that autograd saves outside a
  checkpointed body (``torch.autograd.graph.saved_tensors_hooks``) shares
  storage with a layer's gathered weight; under "none" some do, the
  documented cost of that policy.
* A bf16 step on (2, 1) sums the ranks' gradients in f32: within f32
  rounding of the f32 sum of the same rows' per-micro-batch bf16
  gradients, computed in one process, where their bf16 sum is not.
* Prefill and decode on ZeRO-placed weights equal the tp-only
  placement's; the tp-only placement, and a (1, 1) mesh, dispatch no
  collective.
"""
import os
import pickle
import socket
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as j_base  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models.factory import build_model as j_build  # noqa: E402
from repro.sharding import policy as j_policy  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402

B, S, GEN, WORLD, N_MICRO = 8, 16, 2, 4, 2
LR, EPS, B1 = 1e-3, 1e-3, 0.9
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
STACKS = ("layers", "enc_layers", "dec_layers")
# each arch at one data-parallel size: one reference step an arch
CASES = (("zamba2-1.2b", (2, 1), "full"),
         ("deepseek-7b", (4, 1), "dots"),
         ("phi3.5-moe-42b-a6.6b", (2, 2), "full"),
         ("deepseek-v2-236b", (4, 1), "full"),
         ("qwen2-vl-72b", (2, 2), "dots"),
         ("whisper-tiny", (2, 1), "full"),
         ("mamba2-130m", (2, 2, 1), "full"),
         ("mamba2-130m", (4, 1), "none"))
IDS = [f"{a}-{'x'.join(map(str, m))}-{r}" for a, m, r in CASES]
ARCHS = sorted({a for a, _, _ in CASES})
DP = {a: int(np.prod(m[:-1])) for a, m, _ in CASES}   # data-parallel size
BF16_ARCH = "deepseek-7b"


def _dp(shape) -> int:
    return int(np.prod(shape[:-1]))


def _cfg(registry, arch, dtype="float32"):
    return registry.smoke_config(arch).replace(dtype=dtype)


def _shape_cfg(base, shape, remat="full"):
    """n_micro 2 at every data-parallel size (B / (2 dp) rows a rank)."""
    return base.ShapeConfig("t", "train", S, B, remat_policy=remat,
                            microbatch_seqs_per_shard=B // (N_MICRO
                                                            * _dp(shape)))


def _inputs(cfg):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S + GEN + 1)).astype(np.int32)
    out = {"tokens": toks[:, :S + GEN], "labels": toks[:, 1:S + 1].copy()}
    out["labels"][1, :5] = -1
    if cfg.family == "audio":
        out["enc_frames"] = (rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        n = cfg.vision.n_patches
        out["vision_embeds"] = (rng.standard_normal((B, n, cfg.d_model))
                                * 0.1).astype(np.float32)
        pos = np.broadcast_to(np.arange(S + GEN), (3, B, S + GEN)).copy()
        pos[0, :, :n] = 0
        pos[1, :, :n] = np.arange(n) // (n // 2)
        pos[2, :, :n] = np.arange(n) % (n // 2)
        out["mrope_positions"] = pos.astype(np.int32)
    return out


def _extras(inp, lo, hi):
    out = {k: inp[k] for k in ("enc_frames", "vision_embeds") if k in inp}
    if "mrope_positions" in inp:
        out["mrope_positions"] = inp["mrope_positions"][:, :, lo:hi]
    return out


def _train_batch(inp):
    return {"tokens": inp["tokens"][:, :S], "labels": inp["labels"],
            **_extras(inp, 0, S)}


def _prefill_batch(inp):
    return {"tokens": inp["tokens"][:, :S], **_extras(inp, 0, S)}


def _decode_batch(inp, i):
    out = {"tokens": inp["tokens"][:, S + i:S + i + 1]}
    if "mrope_positions" in inp:
        out["mrope_positions"] = inp["mrope_positions"][:, :, S + i:S + i + 1]
    return out


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------- ranks ---
def _mesh(shape):
    """A mesh of ``shape`` over this rank's share of the four: the whole
    world, or for (2, 1) one of two replicas."""
    from repro_torch.launch.mesh import make_mesh_compat
    axes = AXES[len(shape)]
    rep = WORLD // int(np.prod(shape))
    if rep == 1:
        return make_mesh_compat(shape, axes, device="cpu")
    return make_mesh_compat((rep,) + tuple(shape), ("rep",) + axes,
                            device="cpu")[axes]


def _train_case(arch, shape, remat, params, inp):
    """The ZeRO train step on this rank: its loss, gradients, new
    parameters, m and v (whole and this rank's shards), its collectives,
    and the storages of what autograd saved outside the checkpointed
    bodies against those of the layers' gathered weights."""
    from repro_torch.configs import base, registry
    from repro_torch.launch import costing, steps
    from repro_torch.models.factory import build_model
    from repro_torch.sharding import policy
    from repro_torch.train.optimizer import adamw, tree_leaves

    model = build_model(_cfg(registry, arch))
    mesh = _mesh(shape)
    placed = policy.place(params, mesh)
    opt = adamw(LR, eps=EPS)
    state = opt.init(params)
    state = {"m": policy.place(state["m"], mesh),
             "v": policy.place(state["v"], mesh), "count": state["count"]}
    _, info = steps.make_train_step(model, mesh, _shape_cfg(base, shape,
                                                            remat), opt)
    kept, held = [], []     # both kept alive: no storage is reused
    orig = policy.zero_gather

    def recording(tree, path, layer=None):
        out = orig(tree, path, layer)
        if layer is not None:
            kept.extend(y for x, y in zip(tree_leaves(tree),
                                          tree_leaves(out)) if y is not x)
        return out

    def pack(t):
        held.append(t)
        return t
    policy.zero_gather = recording
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            (loss, g), counter = costing.count_ops(info["grads"], placed,
                                                   _train_batch(inp))
    finally:
        policy.zero_gather = orig
    gathered = {y.untyped_storage().data_ptr() for y in kept}
    saved = {t.untyped_storage().data_ptr() for t in held}
    p2, s2, _ = opt.update(g, state, placed)
    trees = {"grads": g, "params": p2, "m": s2["m"], "v": s2["v"]}
    return {"loss": float(loss), "n_micro": info["n_micro"],
            "coord": tuple(mesh.get_coordinate()),
            "whole": {n: {k: v.full_tensor().numpy()
                          for k, v in _flat(t).items()}
                      for n, t in trees.items()},
            "shards": {n: {k: v.to_local().numpy()
                           for k, v in _flat(t).items()}
                       for n, t in trees.items() if n != "grads"},
            "collectives": counter.collectives()["count_by_type"],
            "largest_gather": counter.coll_largest.get("all-gather", 0.0),
            "layer_gathers": len(kept),
            "saved_gathered": len(saved & gathered)}


def _serve_case(arch, shape, params, inp):
    """Prefill + GEN decode steps on ZeRO-placed and on tp-only-placed
    weights: their logits, and each call's collectives."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import costing, steps
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models.factory import build_model
    from repro_torch.sharding import policy

    model = build_model(_cfg(registry, arch))
    mesh = _mesh(shape)
    pre = steps.make_prefill_step(model, mesh, ShapeConfig(
        "p", "prefill", S, B, kv_dtype="float32"))
    dec = steps.make_decode_step(model, mesh, ShapeConfig(
        "d", "decode", S + GEN, B, kv_dtype="float32"))
    out = {}
    for name in ("zero", "tp_only"):
        specs = steps.params_sds(model, mesh, tp_only=name == "tp_only")[1]
        placed = policy.place(params, mesh, policy.tree_map_with_path(
            lambda _, s: policy.placements(s, mesh), specs))
        (logits, cache), c = costing.count_ops(pre, placed,
                                               _prefill_batch(inp))
        cache = grow_cache(cache, GEN)
        got = {"logits": [logits.numpy()],
               "collectives": [c.collectives()["count_by_type"]]}
        for i in range(GEN):
            (logits, cache), c = costing.count_ops(dec, placed, cache,
                                                   _decode_batch(inp, i))
            got["logits"].append(logits.numpy())
            got["collectives"].append(c.collectives()["count_by_type"])
        out[name] = got
    return out


def _bf16_case(params, inp):
    """A bf16 train step of BF16_ARCH on (2, 1), an identity optimizer:
    its loss and gradients, whole."""
    from repro_torch.configs import base, registry
    from repro_torch.launch import steps
    from repro_torch.models.factory import build_model
    from repro_torch.sharding import policy
    from repro_torch.train.optimizer import Optimizer, tree_map

    model = build_model(_cfg(registry, BF16_ARCH, "bfloat16"))
    mesh = _mesh((2, 1))
    placed = policy.place(tree_map(lambda x: x.to(torch.bfloat16), params),
                          mesh)
    ident = Optimizer(init=lambda p: {}, update=lambda g, s, p: (g, s, {}))
    _, info = steps.make_train_step(model, mesh, _shape_cfg(base, (2, 1)),
                                    ident)
    loss, g = info["grads"](placed, _train_batch(inp))
    return {"loss": float(loss),
            "grads": {k: v.full_tensor().numpy() for k, v in _flat(g).items()}}


def _worker(rank, port, tmp):
    import torch.distributed as dist

    from repro_torch.models.transformer import params_from_jax
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        loaded = {}
        for arch in ARCHS:
            with open(os.path.join(tmp, f"{arch}.pkl"), "rb") as f:
                pnp, inp = pickle.load(f)
            loaded[arch] = params_from_jax(pnp, device="cpu"), inp
        res = {}
        for arch, shape, remat in CASES:
            params, inp = loaded[arch]
            res[arch, shape, remat] = _train_case(arch, shape, remat,
                                                  params, inp)
            res[arch, shape, "serve"] = _serve_case(arch, shape, params, inp)
        res["bf16"] = _bf16_case(*loaded[BF16_ARCH])
        # the one-rank path, each arch on one rank, on whole weights
        res["one"] = {arch: _one_rank(arch, *loaded[arch], DP[arch])
                      for arch in ARCHS[rank::WORLD]}
        if rank == WORLD - 1:
            res["one"]["bf16"] = {
                dt: _one_rank(BF16_ARCH, *loaded[BF16_ARCH], 2, "bfloat16",
                              dt) for dt in (torch.float32, torch.bfloat16)}
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ------------------------------------------------------ one process ---
def _jmesh(shape):
    return jax.sharding.Mesh(np.array(jax.devices()[:int(np.prod(shape))])
                             .reshape(shape), AXES[len(shape)])


def _reference(arch, jp, inp, dp):
    """The reference's AdamW step at data-parallel size ``dp``: loss,
    gradients (from m: the step clips them by their global norm, which
    it reports), new parameters, m and v, flat."""
    cfg = _cfg(j_registry, arch)
    fn, info = j_steps.make_train_step(
        j_build(cfg), _jmesh((dp, 1)), _shape_cfg(j_base, (dp, 1)),
        j_opt.adamw(LR, eps=EPS))
    assert info["n_micro"] == N_MICRO
    with _jmesh((dp, 1)):
        p2, s2, m = jax.jit(fn)(jp, j_opt.adamw(LR).init(jp), {
            k: jnp.asarray(v) for k, v in _train_batch(inp).items()})
    scale = min(1.0, 1.0 / (float(m["grad_norm"]) + 1e-9))
    flat = {n: _flat(jax.tree.map(np.asarray, t)) for n, t in (
        ("params", p2), ("m", s2["m"]), ("v", s2["v"]))}
    flat["grads"] = {k: x / np.float32(1 - B1) / scale
                     for k, x in flat["m"].items()}
    return float(m["loss"]), flat


def _one_rank(arch, params, inp, dp, dtype="float32", sum_dtype=None):
    """The one-rank port path: the model on its whole weights, the same
    micro-batches, normalization and MoE groups as the step at ``dp``;
    AdamW on the mean gradient. With ``sum_dtype``: only the gradients,
    each micro-batch's ``dp`` ranks' rows taken apart and their
    gradients summed in that dtype (then in f32 over the
    micro-batches)."""
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.models.factory import build_model
    from repro_torch.train.optimizer import (adamw, tree_leaves, tree_map,
                                             tree_unflatten)
    cfg = _cfg(registry, arch, dtype)
    model = build_model(cfg)
    params = tree_map(lambda x: x.to(getattr(torch, dtype)), params)
    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    batch = {k: torch.as_tensor(v) for k, v in _train_batch(inp).items()}
    mb = B // N_MICRO
    acc = [torch.zeros(x.shape) for x in leaves]
    loss_sum = 0.0
    for i in range(N_MICRO):
        count = max(float((batch["labels"][i * mb:(i + 1) * mb] >= 0)
                          .sum()), 1.0)
        parts = ([(i * mb, (i + 1) * mb, dp)] if sum_dtype is None else
                 [(i * mb + r * mb // dp, i * mb + (r + 1) * mb // dp, 1)
                  for r in range(dp)])
        gs = []
        for lo, hi, groups in parts:
            micro = {k: (v[:, lo:hi] if k == "mrope_positions" else
                         v[lo:hi]) for k, v in batch.items()}
            logits, aux, _ = model.forward(p, micro, moe_groups=groups)
            ce, _ = steps.lm_loss_parts(logits, micro["labels"],
                                        cfg.vocab_size)
            loss = ce / count
            gs.append(torch.autograd.grad(
                loss + steps.MOE_AUX_COEF * aux / len(parts), leaves,
                allow_unused=True, materialize_grads=True))
            loss_sum += float(loss.detach())
        for j, a in enumerate(acc):
            part = gs[0][j].to(sum_dtype or torch.float32)
            for g in gs[1:]:
                part = part + g[j].to(sum_dtype or torch.float32)
            a += part.to(torch.float32)
    grads = [a / N_MICRO for a in acc]
    if sum_dtype is not None:
        return grads
    opt = adamw(LR, eps=EPS)
    g = tree_unflatten(params, grads)
    p2, s2, _ = opt.update(g, opt.init(params), params)
    return loss_sum / N_MICRO, {n: {k: v.detach().numpy() for k, v in
                                    _flat(t).items()} for n, t in (
        ("grads", g), ("params", p2), ("m", s2["m"]), ("v", s2["v"]))}


def _expected_gathers(jp, shape):
    """From the reference policy's specs on ``shape``, the gathers one
    forward makes, by top-level key of the parameter tree (a gather a
    data-parallel axis of more than 1 that shards a leaf; a stacked
    leaf's once a layer), and the largest gathered leaf's bytes (a
    layer's slice of a stacked one)."""
    sizes = dict(zip(AXES[len(shape)], shape))
    specs = _flat(j_policy.param_pspecs(jp, _jmesh(shape)))
    whole = _flat(jax.tree.map(np.asarray, jp))
    by_key, largest = {}, 0
    for k, spec in specs.items():
        axes = [a for part in spec if part is not None
                for a in ((part,) if isinstance(part, str) else part)
                if a in ("pod", "data") and sizes[a] > 1]
        if not axes:
            continue
        top = k.split("/")[1]
        n = whole[k].shape[0] if top in STACKS else 1
        by_key[top] = by_key.get(top, 0) + len(axes) * n
        largest = max(largest, whole[k].nbytes // n)
    return by_key, largest


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results (spawned once, run beside the reference's
    JAX work; the ranks also run the one-rank path, an arch each), the
    reference's and the one-rank path's steps by arch, and the JAX
    parameters."""
    import torch.multiprocessing as mp

    from repro_torch.configs import registry
    from repro_torch.models.factory import build_model
    tmp = tmp_path_factory.mktemp("zero")
    jparams, inputs = {}, {}
    for arch in ARCHS:
        # the port's init (the reference's tree and leaf names), handed to
        # both; non-zero biases, so that a dropped or doubled one shows
        pnp = _numpy(build_model(_cfg(registry, arch)).init(
            torch.Generator().manual_seed(0), device="cpu"))
        jparams[arch] = jtu.tree_map_with_path(
            lambda path, x: jnp.asarray(x) + (0.05 if str(path[-1].key) in (
                "bq", "bk", "bv") else 0.0), pnp)
        inputs[arch] = _inputs(_cfg(j_registry, arch))
        with open(tmp / f"{arch}.pkl", "wb") as f:
            pickle.dump((jax.tree.map(np.asarray, jparams[arch]),
                         inputs[arch]), f)
    ctx = mp.start_processes(_worker, args=(_free_port(), str(tmp)),
                             nprocs=WORLD, join=False, start_method="spawn")
    with ThreadPoolExecutor(3) as pool:     # XLA compiles off the GIL
        ref = dict(zip(ARCHS, pool.map(lambda a: _reference(
            a, jparams[a], inputs[a], DP[a]), ARCHS)))
    for _ in range(240):                    # at most 240 s
        if ctx.join(timeout=1):
            break
    else:
        for proc in ctx.processes:
            proc.kill()
        pytest.fail("the four ranks did not finish in 240 s")
    ranks, one = [], {}
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
        one.update(ranks[-1].pop("one"))
    return ranks, ref, one, jparams


@pytest.mark.parametrize("arch,shape,remat", CASES, ids=IDS)
def test_train_step_equals_the_reference_and_the_one_rank_path(
        runs, arch, shape, remat):
    ranks, ref, one, _ = runs
    assert _dp(shape) == DP[arch]
    for r, res in enumerate(ranks):
        got = res[arch, shape, remat]
        assert got["n_micro"] == N_MICRO
        for loss, want, who in ((*ref[arch], "reference"),
                                (*one[arch], "one-rank path")):
            assert got["loss"] == pytest.approx(loss, rel=1e-6), (r, who)
            for name in ("grads", "params", "m", "v"):
                assert sorted(got["whole"][name]) == sorted(want[name])
                for k, w in want[name].items():
                    np.testing.assert_allclose(
                        got["whole"][name][k], w, err_msg=f"rank {r} "
                        f"{who} {name} {k}", **GRAD_TOL)


@pytest.mark.parametrize("arch,shape,remat", CASES, ids=IDS)
def test_each_rank_holds_the_reference_slice(runs, arch, shape, remat):
    """The rank's shards of the new parameters, m and v are the slices of
    the reference's whole ones that its ``NamedSharding`` gives the
    device at the rank's mesh coordinate (m and v shard as their
    parameters)."""
    ranks, ref, _, jparams = runs
    jmesh = _jmesh(shape)
    specs = _flat(j_policy.param_pspecs(jparams[arch], jmesh))
    want = ref[arch][1]
    for r, res in enumerate(ranks):
        got = res[arch, shape, remat]
        dev = jmesh.devices[got["coord"]]
        for name in ("params", "m", "v"):
            for k, w in want[name].items():
                idx = jax.sharding.NamedSharding(jmesh, specs[k]) \
                    .devices_indices_map(w.shape)[dev]
                np.testing.assert_allclose(got["shards"][name][k], w[idx],
                                           err_msg=f"rank {r} {name} {k}",
                                           **GRAD_TOL)


@pytest.mark.parametrize("arch,shape,remat", [c for c in CASES
                                              if c[1][-1] == 1],
                         ids=[i for i, c in zip(IDS, CASES) if c[1][-1] == 1])
def test_gathers_a_layer_at_a_time(runs, arch, shape, remat):
    ranks, _, _, jparams = runs
    by_key, largest = _expected_gathers(jparams[arch], shape)
    total = sum(by_key.values())
    layers = sum(n for k, n in by_key.items() if k in STACKS)
    fwd = total + layers * (remat != "none")
    for res in ranks:
        got = res[arch, shape, remat]
        c = got["collectives"]
        assert c.get("all-gather", 0) == fwd * N_MICRO, c
        assert c.get("reduce-scatter", 0) == total * N_MICRO, c
        assert 0 < got["largest_gather"] <= largest
        assert got["layer_gathers"] >= layers * N_MICRO


@pytest.mark.parametrize("arch,shape,remat", CASES, ids=IDS)
def test_no_gathered_layer_is_saved_outside_its_checkpoint(runs, arch,
                                                           shape, remat):
    """Under "full" and "dots" a layer's gathered weights are saved only
    inside its checkpointed body (recomputed, with the gather, in the
    backward); under "none" autograd keeps them for the backward."""
    ranks, _, _, _ = runs
    for res in ranks:
        got = res[arch, shape, remat]
        assert got["layer_gathers"] > 0
        if remat == "none":
            assert got["saved_gathered"] > 0
        else:
            assert got["saved_gathered"] == 0


def test_a_bf16_step_sums_the_ranks_in_f32(runs):
    """The (2, 1) bf16 step's gradients against the f32 sums of the same
    rows' bf16 gradients: within f32 rounding (the ranks' sums and the
    micro-batches' in another order), where the bf16 sums of the same
    gradients differ by bf16 rounding."""
    ranks, _, one, jparams = runs
    from repro_torch.train.optimizer import tree_leaves_with_path
    names = ["/" + "/".join(map(str, path)) for path, _ in
             tree_leaves_with_path(jax.tree.map(np.asarray,
                                                jparams[BF16_ARCH]))]
    f32 = dict(zip(names, (g.numpy() for g in one["bf16"][torch.float32])))
    b16 = dict(zip(names, (g.numpy() for g in one["bf16"][torch.bfloat16])))
    worst_b16 = 0.0
    for res in ranks:
        got = res["bf16"]["grads"]
        assert sorted(got) == sorted(f32)
        for k, w in f32.items():
            top = float(np.abs(w).max()) or 1.0
            assert got[k].dtype == np.float32
            assert float(np.abs(got[k] - w).max()) <= 1e-6 * top, k
            worst_b16 = max(worst_b16, float(np.abs(b16[k] - w).max()) / top)
    assert worst_b16 > 1e-4


@pytest.mark.parametrize("arch,shape,remat", CASES, ids=IDS)
def test_serving_on_zero_weights_equals_tp_only(runs, arch, shape, remat):
    """Prefill + decode on ZeRO-placed weights (each layer gathered as it
    runs) equal the tp-only placement's; on a 'model' axis of 1 the
    tp-only steps dispatch no collective, and the ZeRO steps only their
    all-gathers, a layer's at a time (a decode step runs no encoder).
    A leaf gathered along a dim other than its first is a view of the
    gathered blocks, so a product may take another kernel than on the
    tp-only leaf: tests/test_torch_tensor_parallel.py's tolerance."""
    ranks, _, _, jparams = runs
    by_key, _ = _expected_gathers(jparams[arch], shape)
    want = [sum(by_key.values())] + [
        sum(n for k, n in by_key.items() if k != "enc_layers")] * GEN
    for r, res in enumerate(ranks):
        got = res[arch, shape, "serve"]
        for i, (z, t) in enumerate(zip(got["zero"]["logits"],
                                       got["tp_only"]["logits"])):
            np.testing.assert_allclose(z, t, atol=1e-5, rtol=1e-5,
                                       err_msg=f"rank {r} call {i}")
        if shape[-1] == 1:
            assert all(c == {} for c in got["tp_only"]["collectives"])
            assert got["zero"]["collectives"] == [{"all-gather": n}
                                                  for n in want]


def test_no_collective_on_a_one_rank_mesh():
    """(1, 1): the ZeRO steps of mamba2-130m (tied embeddings) dispatch no
    collective (tests/test_torch_tensor_parallel.py holds deepseek-7b's
    and zamba2-1.2b's)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import costing, steps
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models.factory import build_model
    from repro_torch.sharding.policy import place
    from repro_torch.train.optimizer import adamw

    mesh = make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    for arch in ("mamba2-130m",):
        cfg = _cfg(registry, arch)
        model = build_model(cfg)
        whole = model.init(torch.Generator().manual_seed(0), device="cpu")
        params = place(whole, mesh)
        inp = _inputs(cfg)
        pre = steps.make_prefill_step(model, mesh, ShapeConfig(
            "p", "prefill", S, B))
        opt = adamw(1e-4)
        fn, _ = steps.make_train_step(model, mesh, ShapeConfig(
            "t", "train", S, B), opt)
        _, c_pre = costing.count_ops(pre, params, _prefill_batch(inp))
        _, c_train = costing.count_ops(fn, params, place(opt.init(whole),
                                                         mesh),
                                       _train_batch(inp))
        for c in (c_pre, c_train):
            assert c.collectives()["count_by_type"] == {}, arch
