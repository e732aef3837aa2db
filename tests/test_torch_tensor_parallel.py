"""The port's tensor-parallel steps (``launch/steps`` on a 'model' axis of
more than 1: the dense, vlm, ssm and hybrid families compute each rank's
'model' shard) against the one-rank port path and the reference: four
gloo processes on the CPU (one ``torch.multiprocessing`` spawn), f32
smoke configs of deepseek-7b, qwen2-vl-72b (QKV biases and M-RoPE),
mamba2-130m (tied embeddings) and zamba2-1.2b (the shared block), on
(data 1, model 4) and (data 2, model 2) meshes.

* Prefill logits (made whole on every rank) and 8 decode steps (teacher
  forced: the same next tokens on both sides) equal the one-rank port
  path on the same rows and the reference's prefill and decode_step:
  atol 1e-5 + rtol 1e-5 (f32 sums split over the ranks add in another
  order; a head, vocab or mask fault moves logits by O(1)).
* One train step's loss and gradients (gathered whole) equal the
  reference's step at the same data-parallel size: loss 1e-6 relative,
  gradients atol 1e-6 + rtol 1e-4 (tests/test_torch_train_distributed.py's).
* Each rank's DTensor shard equals the slice the reference's
  ``NamedSharding`` gives that device, and the leaf the step computes
  with (``steps._local``) the slice of the spec without its data-parallel
  axes (the reference's ``_drop_fsdp``).
* The smoke configs have 2 KV heads: on 4 'model' ranks they do not
  divide, and the step gathers ``wk``/``wv`` over 'model' (counted
  all-gathers) and keeps the KV head its q head reads.
* On a (1, 1) mesh ``costing.OpCounter`` sees no collective in a prefill,
  a decode step or a train step; the moe and audio families keep the
  whole-weight route.
"""
import os
import pickle
import socket

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

ARCHS = ("deepseek-7b", "qwen2-vl-72b", "mamba2-130m", "zamba2-1.2b")
MESHES = ((1, 4), (2, 2))
B, S, GEN, WORLD = 4, 16, 8, 4
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)


def _cfg(registry, arch):
    return registry.smoke_config(arch).replace(dtype="float32")


def _inputs(cfg):
    """tokens (B, S + GEN), labels (B, S) (some masked), and the vlm's
    patch embeddings and (t, h, w) positions (the patches on a 2 x n/2
    grid at t 0, then the text)."""
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + GEN + 1)).astype(np.int32)
    out = {"tokens": toks[:, :S + GEN],
           "labels": toks[:, 1:S + 1].copy()}
    out["labels"][1, :5] = -1
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


def _prefill_batch(inp):
    out = {"tokens": inp["tokens"][:, :S]}
    if "mrope_positions" in inp:
        out["vision_embeds"] = inp["vision_embeds"]
        out["mrope_positions"] = inp["mrope_positions"][:, :, :S]
    return out


def _decode_batch(inp, i):
    out = {"tokens": inp["tokens"][:, S + i:S + i + 1]}
    if "mrope_positions" in inp:
        out["mrope_positions"] = inp["mrope_positions"][:, :, S + i:S + i + 1]
    return out


def _train_batch(inp):
    out = {"tokens": inp["tokens"][:, :S], "labels": inp["labels"]}
    if "mrope_positions" in inp:
        out["vision_embeds"] = inp["vision_embeds"]
        out["mrope_positions"] = inp["mrope_positions"][:, :, :S]
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------- ranks ---
def _rank_case(rank, arch, shape, params, inp):
    """One (arch, mesh) on this rank: prefill + decode against the
    one-rank path, the collectives of one prefill, the train step's loss
    and whole gradients, and the rank's shards."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import costing, steps
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models.factory import build_model
    from repro_torch.sharding.policy import place
    from repro_torch.train.optimizer import Optimizer

    cfg = _cfg(registry, arch)
    model = build_model(cfg)
    mesh = make_mesh_compat(shape, ("data", "model"), device="cpu")
    placed = place(params, mesh)
    d = mesh.get_coordinate()[0]
    rows = slice(d * B // shape[0], (d + 1) * B // shape[0])

    def t(batch):
        return {k: torch.as_tensor(v) for k, v in batch.items()}

    def mine(batch):        # this rank's rows of a host batch
        return {k: (v[:, rows] if k == "mrope_positions" else v[rows])
                for k, v in t(batch).items()}

    pre = steps.make_prefill_step(model, mesh, ShapeConfig(
        "p", "prefill", S, B, kv_dtype="float32"))
    dec = steps.make_decode_step(model, mesh, ShapeConfig(
        "d", "decode", S + GEN, B, kv_dtype="float32"))
    (logits, cache), counter = costing.count_ops(pre, placed,
                                                 _prefill_batch(inp))
    one, one_cache = model.prefill(params, mine(_prefill_batch(inp)),
                                   kv_dtype="float32")
    out = {"rows": (rows.start, rows.stop), "logits": [logits.numpy()],
           "one_err": [float((logits - one).abs().max())],
           "prefill_collectives": counter.collectives(),
           "tensor_parallel": (pre.tensor_parallel, dec.tensor_parallel),
           "kv_heads": int(cache["kv" if "kv" in cache else "shared_attn"]
                           ["k"].shape[3]) if cfg.uses_attention else 0}
    cache, one_cache = grow_cache(cache, GEN), grow_cache(one_cache, GEN)
    ok = bool(torch.allclose(logits, one, **LOGIT_TOL))
    for i in range(GEN):
        logits, cache = dec(placed, cache, _decode_batch(inp, i))
        one, one_cache = model.decode(params, one_cache,
                                      mine(_decode_batch(inp, i)))
        ok &= bool(torch.allclose(logits, one, **LOGIT_TOL))
        out["logits"].append(logits.numpy())
        out["one_err"].append(float((logits - one).abs().max()))
    out["one_ok"] = ok

    ident = Optimizer(init=lambda p: {}, update=lambda g, s, p: (g, s, {}))
    fn, info = steps.make_train_step(model, mesh, ShapeConfig(
        "t", "train", S, B, microbatch_seqs_per_shard=1), ident)
    g, _, m = fn(placed, {}, _train_batch(inp))
    out.update(loss=float(m["loss"]), n_micro=info["n_micro"],
               train_tp=info["tensor_parallel"],
               grads={k: v.full_tensor().numpy()
                      for k, v in _flat(g).items()},
               shards={k: v.to_local().numpy()
                       for k, v in _flat(placed).items()},
               local={k: steps._local(v, mesh).numpy()
                      for k, v in _flat(placed).items()})
    return out


def _worker(rank, port, tmp):
    import torch.distributed as dist

    from repro_torch.models.transformer import params_from_jax
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        res = {}
        for arch in ARCHS:
            with open(os.path.join(tmp, f"{arch}.pkl"), "rb") as f:
                pnp, inp = pickle.load(f)
            params = params_from_jax(pnp, device="cpu")
            for shape in MESHES:
                res[arch, shape] = _rank_case(rank, arch, shape, params, inp)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ reference ---
def _jmesh(shape):
    return jax.sharding.Mesh(np.array(jax.devices()[:int(np.prod(shape))])
                             .reshape(shape), ("data", "model"))


def _reference(arch, jp, inp):
    """The reference's prefill + teacher-forced decode logits, and its
    train step (loss, gradients) at data-parallel sizes 1 and 2."""
    cfg = _cfg(j_registry, arch)
    jm = j_build(cfg)
    jb = {k: jnp.asarray(v) for k, v in _prefill_batch(inp).items()}
    lg, cache = jax.jit(jm.prefill, static_argnames="kv_dtype")(
        jp, jb, kv_dtype="float32")

    def grow(path, x):
        name = next((str(e.key) for e in reversed(path)
                     if isinstance(e, jtu.DictKey)), None)
        if name in ("k", "v"):
            pad = [(0, 0)] * x.ndim
            pad[2] = (0, GEN)
            return jnp.pad(x, pad)
        return x
    cache = jtu.tree_map_with_path(grow, cache)
    logits = [np.asarray(lg)]
    decode = jax.jit(jm.decode)
    for i in range(GEN):
        lg, cache = decode(jp, cache, {k: jnp.asarray(v) for k, v in
                                       _decode_batch(inp, i).items()})
        logits.append(np.asarray(lg))
    ident = j_opt.Optimizer(init=lambda p: {},
                            update=lambda g, s, p: (g, s, {}))
    train = {}
    for dp in (1, 2):
        mesh = _jmesh((dp, 1))
        fn, info = j_steps.make_train_step(jm, mesh, j_base.ShapeConfig(
            "t", "train", S, B, microbatch_seqs_per_shard=1), ident)
        with mesh:
            g, _, m = jax.jit(fn)(jp, {}, {k: jnp.asarray(v) for k, v in
                                           _train_batch(inp).items()})
        train[dp] = (float(m["loss"]), _flat(jax.tree.map(np.asarray, g)),
                     info["n_micro"])
    return logits, train


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results (spawned once, run beside the reference's
    JAX work) and the reference's, by arch."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("tp")
    params, inputs = {}, {}
    for arch in ARCHS:
        cfg = _cfg(j_registry, arch)
        jp = j_build(cfg).init(jax.random.PRNGKey(0))
        # non-zero biases, so that a dropped or doubled one shows
        jp = jtu.tree_map_with_path(
            lambda path, x: x + 0.05 if str(path[-1].key) in (
                "bq", "bk", "bv") else x, jp)
        params[arch], inputs[arch] = jp, _inputs(cfg)
        with open(tmp / f"{arch}.pkl", "wb") as f:
            pickle.dump((jax.tree.map(np.asarray, jp), inputs[arch]), f)
    ctx = mp.start_processes(_worker, args=(_free_port(), str(tmp)),
                             nprocs=WORLD, join=False, start_method="spawn")
    ref = {arch: _reference(arch, params[arch], inputs[arch])
           for arch in ARCHS}
    for _ in range(240):                    # at most 240 s
        if ctx.join(timeout=1):
            break
    else:
        for proc in ctx.processes:
            proc.kill()
        pytest.fail("the four ranks did not finish in 240 s")
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, ref, params


CASES = [(a, m) for a in ARCHS for m in MESHES]
IDS = [f"{a}-{m[0]}x{m[1]}" for a, m in CASES]


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_prefill_and_decode_equal_one_rank_and_the_reference(runs, arch,
                                                             shape):
    ranks, ref, _ = runs
    want = ref[arch][0]
    for r, res in enumerate(ranks):
        got = res[arch, shape]
        assert got["tensor_parallel"] == (True, True)
        assert got["one_ok"], (r, got["one_err"])
        lo, hi = got["rows"]
        assert len(got["logits"]) == GEN + 1
        for i, (g, w) in enumerate(zip(got["logits"], want)):
            np.testing.assert_allclose(g, w[lo:hi], err_msg=f"rank {r} "
                                       f"step {i}", **LOGIT_TOL)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_train_step_equals_the_reference_at_the_same_dp(runs, arch, shape):
    ranks, ref, _ = runs
    loss, want, n_micro = ref[arch][1][shape[0]]
    for r, res in enumerate(ranks):
        got = res[arch, shape]
        assert got["train_tp"] and got["n_micro"] == n_micro
        assert got["loss"] == pytest.approx(loss, rel=1e-6), r
        assert sorted(got["grads"]) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got["grads"][k], want[k],
                                       err_msg=f"rank {r} {k}", **GRAD_TOL)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_each_rank_holds_the_reference_slice(runs, arch, shape):
    """The DTensor shard is the reference's ``NamedSharding`` slice of the
    device at the rank's mesh coordinate; the leaf the step computes with
    is the slice of the spec without its data-parallel axes. A leaf the
    policy splits over 'model' is never whole on a rank."""
    ranks, _, params = runs
    jmesh = _jmesh(shape)
    jp = params[arch]
    specs = _flat(j_policy.param_pspecs(jp, jmesh))
    whole = _flat(jax.tree.map(np.asarray, jp))
    for r, res in enumerate(ranks):
        got = res[arch, shape]
        dev = jmesh.devices[r // shape[1], r % shape[1]]
        for k, w in whole.items():
            for spec, mine in ((specs[k], got["shards"][k]),
                               (j_steps._drop_fsdp(specs[k]),
                                got["local"][k])):
                idx = jax.sharding.NamedSharding(jmesh, spec) \
                    .devices_indices_map(w.shape)[dev]
                np.testing.assert_array_equal(mine, w[idx],
                                              err_msg=f"rank {r} {k}")
            if "model" in jax.tree.leaves(tuple(specs[k])):
                assert got["local"][k].size < w.size, (r, k)


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen2-vl-72b",
                                  "zamba2-1.2b"])
def test_kv_heads_that_do_not_divide_the_model_axis(runs, arch):
    """2 KV heads on 4 'model' ranks: the policy splits ``wk``/``wv``
    columns inside a head; each rank gathers them (two all-gathers an
    attention block, and nothing gathers on (1, 4) otherwise) and keeps
    the one KV head its q head reads; on (2, 2) a rank holds its own KV
    head and gathers only over 'data'."""
    ranks, _, _ = runs
    cfg = _cfg(j_registry, arch)
    n_attn = (cfg.n_layers // cfg.hybrid_attn_every
              if cfg.family == "hybrid" else cfg.n_layers)
    assert cfg.n_kv_heads % 4 and cfg.n_kv_heads % 2 == 0
    for res in ranks:
        got = res[arch, (1, 4)]
        assert got["kv_heads"] == 1
        assert got["prefill_collectives"]["count_by_type"][
            "all-gather"] == 2 * n_attn
        assert res[arch, (2, 2)]["kv_heads"] == 1


def test_no_collective_on_a_one_rank_mesh():
    """(1, 1): a prefill, a decode step and a train step of the
    tensor-parallel families dispatch no collective (the model code takes
    no mesh context there)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import costing, steps
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models.factory import build_model
    from repro_torch.sharding.policy import place
    from repro_torch.train.optimizer import adamw

    mesh = make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    for arch in ("deepseek-7b", "zamba2-1.2b"):
        cfg = _cfg(registry, arch)
        model = build_model(cfg)
        params = place(model.init(torch.Generator().manual_seed(0),
                                  device="cpu"), mesh)
        inp = _inputs(cfg)
        pre = steps.make_prefill_step(model, mesh, ShapeConfig(
            "p", "prefill", S, B))
        dec = steps.make_decode_step(model, mesh, ShapeConfig(
            "d", "decode", S, B))
        opt = adamw(1e-4)
        fn, info = steps.make_train_step(model, mesh, ShapeConfig(
            "t", "train", S, B), opt)
        assert not (pre.tensor_parallel or dec.tensor_parallel
                    or info["tensor_parallel"])
        (_, cache), c_pre = costing.count_ops(pre, params,
                                              _prefill_batch(inp))
        cache = steps.decode_cache(model, mesh, ShapeConfig(
            "d", "decode", S, B), device="cpu")
        _, c_dec = costing.count_ops(dec, params, cache,
                                     _decode_batch(inp, 0))
        state = place(opt.init(model.init(torch.Generator().manual_seed(0),
                                          device="cpu")), mesh)
        _, c_train = costing.count_ops(fn, params, state, _train_batch(inp))
        for c in (c_pre, c_dec, c_train):
            assert c.collectives()["count_by_type"] == {}, arch


def test_the_route_is_chosen_by_family():
    """On a 'model' axis of 2 the dense, vlm, ssm and hybrid families are
    tensor-parallel; the moe family (phi3.5-moe, deepseek-v2 with MLA) and
    the audio family keep the whole-weight route; a 'model' axis of 1 is
    never tensor-parallel."""
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.sharding.policy import MeshShape
    tp = {a: steps.tensor_parallel(registry.get_arch(a), MeshShape(
        ("data", "model"), (2, 2))) for a in registry.ARCHS}
    assert tp == {a: registry.get_arch(a).family in
                  ("dense", "vlm", "ssm", "hybrid") for a in tp}
    assert not any(steps.tensor_parallel(registry.get_arch(a), MeshShape(
        ("data", "model"), (4, 1))) for a in registry.ARCHS)
