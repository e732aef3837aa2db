"""The port's tensor-parallel steps for the moe and audio families
(``launch/steps`` on a 'model' axis of more than 1: expert parallelism,
MLA's heads, whisper's encoder, decoder and cross-attention heads)
against the one-rank port path and the reference: four gloo processes on
the CPU (one ``torch.multiprocessing`` spawn), f32 smoke configs of
phi3.5-moe (GQA + 4 experts top-2), deepseek-v2 (MLA + 4 routed experts
top-2 + 2 shared) and whisper-tiny (QKV biases, tied embeddings), on
(data 1, model 4) and (data 2, model 2) meshes. The weights are the
reference's (``params_from_jax``), the inputs drawn with numpy.

* Prefill logits (whole on every rank) and 8 teacher-forced decode steps
  equal the one-rank port path on the same rows and the reference's
  prefill and decode_step with one routing group a data-parallel rank
  (``moe_groups``): atol 1e-5 + rtol 1e-5 (f32 sums split over the ranks
  add in another order; an expert, head or reduction fault moves logits
  by O(1)). The smoke configs' capacity factor 1.25 drops tokens.
* Routing: at the default capacity factor, every rank's routing of its
  prefill (``ffn.route``: top-k, each expert's kept tokens, the slots,
  the gates) equals every other rank's of its rows bit for bit, and the
  one-rank path's (its gates within the logits' tolerance: the hidden
  states' sums run in another order there), and ``apply_moe``
  on one input, whole on every rank, routes exactly as on one card
  (tokens dropped) with its output within the same tolerance.
* One train step's loss and gradients (gathered whole) equal the
  reference's step at the same data-parallel size: loss 1e-6 relative,
  gradients atol 1e-6 + rtol 1e-4. The replicated leaves whose gradient
  comes through the ranks' shards (``w_router``, MLA's ``w_dq``,
  ``w_dkv``, ``q_norm``, ``kv_norm``, whisper's ``bk``/``bv`` and
  ``dec_pos``) are each named.
* Each rank's DTensor shard equals the slice the reference's
  ``NamedSharding`` gives that device (the experts, ``w_uq``/``w_uk``/
  ``w_uv`` and ``wo`` split over 'model'), and the leaf the step computes
  with the slice of the spec without its data-parallel axes.
* On a (1, 1) mesh ``costing.OpCounter`` sees no collective in a
  prefill, a decode step or a train step.
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

ARCHS = ("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", "whisper-tiny")
MESHES = ((1, 4), (2, 2))
B, S, GEN, WORLD = 4, 16, 8, 4
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
# the replicated leaves whose gradient the ranks' shards make up
NAMED = {"phi3.5-moe-42b-a6.6b": ("w_router",),
         "deepseek-v2-236b": ("w_router", "w_dq", "w_dkv", "q_norm",
                              "kv_norm"),
         "whisper-tiny": ("bk", "bv", "dec_pos")}
# leaves split over 'model' on both meshes
SPLIT = {"phi3.5-moe-42b-a6.6b": ("w_gate_e", "w_up_e", "w_down_e", "wq",
                                  "wo"),
         "deepseek-v2-236b": ("w_gate_e", "w_up_e", "w_down_e", "w_uq",
                              "w_uk", "w_uv", "wo"),
         "whisper-tiny": ("wq", "wo", "w_in", "w_out")}


def _cfg(registry, arch):
    return registry.smoke_config(arch).replace(dtype="float32")


def _inputs(cfg):
    """tokens (B, S + GEN), labels (B, S) (some masked), whisper's frame
    embeddings, and an input to one ``apply_moe`` (B, S, d) whose
    routing drops tokens."""
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (B, S + GEN + 1)).astype(np.int32)
    out = {"tokens": toks[:, :S + GEN], "labels": toks[:, 1:S + 1].copy()}
    out["labels"][1, :5] = -1
    if cfg.family == "audio":
        out["enc_frames"] = (rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)) * 0.1).astype(np.float32)
    # tokens that share a direction crowd the same experts, which then
    # drop some at capacity factor 1.25
    out["moe_x"] = (rng.standard_normal((B, S, cfg.d_model))
                    + 2.0 * rng.standard_normal(cfg.d_model)).astype(
                        np.float32)
    return out


def _prefill_batch(inp):
    out = {"tokens": inp["tokens"][:, :S]}
    if "enc_frames" in inp:
        out["enc_frames"] = inp["enc_frames"]
    return out


def _decode_batch(inp, i):
    return {"tokens": inp["tokens"][:, S + i:S + i + 1]}


def _train_batch(inp):
    out = {"tokens": inp["tokens"][:, :S], "labels": inp["labels"]}
    if "enc_frames" in inp:
        out["enc_frames"] = inp["enc_frames"]
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------- ranks ---
class _Routes:
    """Records each routing ``ffn.apply_moe`` takes (``ffn.route``)."""

    def __init__(self):
        from repro_torch.models import ffn
        self.ffn, self.route, self.seen = ffn, ffn.route, []

    def __enter__(self):
        def spy(*a, **kw):
            r = self.route(*a, **kw)
            self.seen.append({k: getattr(r, k).detach().numpy() for k in
                              ("topi", "sel_idx", "slot", "sel_gate")})
            return r
        self.ffn.route = spy
        return self.seen

    def __exit__(self, *exc):
        self.ffn.route = self.route


def _moe_case(cfg, mesh, params, inp):
    """One ``apply_moe`` (the first layer's weights, ``inp["moe_x"]``
    whole on every rank, default capacity) under the mesh context on the
    rank's shard, and on one card: (routings, outputs, aux losses)."""
    from repro_torch.launch import steps
    from repro_torch.models import ffn
    from repro_torch.sharding import policy
    from repro_torch.sharding.policy import place
    x = torch.as_tensor(inp["moe_x"])
    whole = {k: v[0] for k, v in params["layers"]["moe"].items()
             if k != "shared"}
    if "shared" in params["layers"]["moe"]:
        whole["shared"] = {k: v[0] for k, v in
                           params["layers"]["moe"]["shared"].items()}
    mine = steps._locals(place(whole, mesh), mesh)
    with _Routes() as seen, torch.no_grad():
        with policy.use_ctx_mesh(mesh):
            out, aux = ffn.apply_moe(mine, x, cfg)
        one, one_aux = ffn.apply_moe(whole, x, cfg)
    return seen, (out.numpy(), one.numpy()), (float(aux), float(one_aux))


def _rank_case(rank, arch, shape, params, inp):
    """One (arch, mesh) on this rank: prefill + decode against the
    one-rank path, the prefill's routings, one apply_moe, the train
    step's loss and whole gradients, and the rank's shards."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
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

    def mine(batch):        # this rank's rows of a host batch
        return {k: torch.as_tensor(v)[rows] for k, v in batch.items()}

    pre = steps.make_prefill_step(model, mesh, ShapeConfig(
        "p", "prefill", S, B, kv_dtype="float32"))
    dec = steps.make_decode_step(model, mesh, ShapeConfig(
        "d", "decode", S + GEN, B, kv_dtype="float32"))
    with _Routes() as routes:
        logits, cache = pre(placed, _prefill_batch(inp))
    with _Routes() as one_routes:
        one, one_cache = model.prefill(params, mine(_prefill_batch(inp)),
                                       kv_dtype="float32")
    out = {"rows": (rows.start, rows.stop), "logits": [logits.numpy()],
           "one_err": [float((logits - one).abs().max())],
           "routes": routes, "one_routes": one_routes,
           "tensor_parallel": (pre.tensor_parallel, dec.tensor_parallel)}
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
    if cfg.moe is not None:
        out["moe"] = _moe_case(cfg, mesh, params, inp)

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


def _grow(path, x):
    """The reference's cache with room for GEN more tokens (the self
    attention's and MLA's sequence axis; the cross cache keeps its
    frames)."""
    keys = [str(e.key) for e in path if isinstance(e, jtu.DictKey)]
    if keys[-1] in ("k", "v", "c_kv", "k_rope") and "cross" not in keys:
        pad = [(0, 0)] * x.ndim
        pad[2] = (0, GEN)
        return jnp.pad(x, pad)
    return x


def _reference(arch, jp, inp):
    """The reference's prefill + teacher-forced decode logits with one
    routing group a data-parallel rank, and its train step (loss,
    gradients), at data-parallel sizes 1 and 2."""
    cfg = _cfg(j_registry, arch)
    jm = j_build(cfg)
    serve, train = {}, {}
    ident = j_opt.Optimizer(init=lambda p: {},
                            update=lambda g, s, p: (g, s, {}))
    for dp in (1, 2):
        jb = {k: jnp.asarray(v) for k, v in _prefill_batch(inp).items()}
        lg, cache = jax.jit(jm.prefill, static_argnames=(
            "kv_dtype", "moe_groups"))(jp, jb, kv_dtype="float32",
                                       moe_groups=dp)
        cache = jtu.tree_map_with_path(_grow, cache)
        logits = [np.asarray(lg)]
        decode = jax.jit(jm.decode, static_argnames="moe_groups")
        for i in range(GEN):
            lg, cache = decode(jp, cache, {k: jnp.asarray(v) for k, v in
                                           _decode_batch(inp, i).items()},
                               moe_groups=dp)
            logits.append(np.asarray(lg))
        serve[dp] = logits
        mesh = _jmesh((dp, 1))
        fn, info = j_steps.make_train_step(jm, mesh, j_base.ShapeConfig(
            "t", "train", S, B, microbatch_seqs_per_shard=1), ident)
        with mesh:
            g, _, m = jax.jit(fn)(jp, {}, {k: jnp.asarray(v) for k, v in
                                           _train_batch(inp).items()})
        train[dp] = (float(m["loss"]), _flat(jax.tree.map(np.asarray, g)),
                     info["n_micro"])
    return serve, train


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results (spawned once, run beside the reference's
    JAX work) and the reference's, by arch."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("tp_moe")
    params, inputs = {}, {}
    for arch in ARCHS:
        cfg = _cfg(j_registry, arch)
        jp = j_build(cfg).init(jax.random.PRNGKey(0))
        # non-zero biases and positions, so that a dropped or doubled one
        # shows
        jp = jtu.tree_map_with_path(
            lambda path, x: x + 0.05 if str(path[-1].key) in (
                "bq", "bk", "bv", "b_in", "b_out") else x, jp)
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
MOE_CASES = [c for c in CASES if c[0] != "whisper-tiny"]
MOE_IDS = [i for c, i in zip(CASES, IDS) if c[0] != "whisper-tiny"]


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_prefill_and_decode_equal_one_rank_and_the_reference(runs, arch,
                                                             shape):
    ranks, ref, _ = runs
    want = ref[arch][0][shape[0]]
    for r, res in enumerate(ranks):
        got = res[arch, shape]
        assert got["tensor_parallel"] == (True, True)
        assert got["one_ok"], (r, got["one_err"])
        lo, hi = got["rows"]
        assert len(got["logits"]) == GEN + 1
        for i, (g, w) in enumerate(zip(got["logits"], want)):
            np.testing.assert_allclose(g, w[lo:hi], err_msg=f"rank {r} "
                                       f"step {i}", **LOGIT_TOL)


@pytest.mark.parametrize("arch,shape", MOE_CASES, ids=MOE_IDS)
def test_every_rank_routes_as_one_card(runs, arch, shape):
    """The prefill's routings (one a layer) are the same on every rank of
    a data-parallel row and equal the one-rank path's on those rows; one
    ``apply_moe`` on one input drops tokens at the default capacity
    factor, routes as on one card on every rank, and its output and aux
    loss match."""
    ranks, _, _ = runs
    cfg = _cfg(j_registry, arch)
    for r, res in enumerate(ranks):
        got = res[arch, shape]
        assert len(got["routes"]) == cfg.n_layers
        peer = ranks[r - r % shape[1]][arch, shape]   # model rank 0's
        for layer, (a, b, c) in enumerate(zip(
                got["routes"], peer["routes"], got["one_routes"])):
            for k in ("topi", "sel_idx", "slot", "sel_gate"):
                msg = f"rank {r} layer {layer} {k}"
                np.testing.assert_array_equal(a[k], b[k], err_msg=msg)
                if k == "sel_gate":     # the one card's sums in its order
                    np.testing.assert_allclose(a[k], c[k], err_msg=msg,
                                               **LOGIT_TOL)
                else:
                    np.testing.assert_array_equal(a[k], c[k], err_msg=msg)
        seen, (out, one), (aux, one_aux) = got["moe"]
        assert len(seen) == 2
        for k in ("topi", "sel_idx", "slot", "sel_gate"):
            np.testing.assert_array_equal(seen[0][k], seen[1][k],
                                          err_msg=f"rank {r} {k}")
        assert (seen[0]["slot"] < 0).any(), "no token dropped"
        np.testing.assert_allclose(out, one, err_msg=f"rank {r}",
                                   **LOGIT_TOL)
        assert aux == one_aux


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_train_step_equals_the_reference_at_the_same_dp(runs, arch, shape):
    ranks, ref, _ = runs
    loss, want, n_micro = ref[arch][1][shape[0]]
    named = [k for k in want if k.rsplit("/", 1)[-1] in NAMED[arch]]
    assert {k.rsplit("/", 1)[-1] for k in named} == set(NAMED[arch])
    for r, res in enumerate(ranks):
        got = res[arch, shape]
        assert got["train_tp"] and got["n_micro"] == n_micro
        assert got["loss"] == pytest.approx(loss, rel=1e-6), r
        assert sorted(got["grads"]) == sorted(want)
        for k in named + [k for k in want if k not in named]:
            np.testing.assert_allclose(got["grads"][k], want[k],
                                       err_msg=f"rank {r} {k}", **GRAD_TOL)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_each_rank_holds_the_reference_slice(runs, arch, shape):
    """The DTensor shard is the reference's ``NamedSharding`` slice of the
    device at the rank's mesh coordinate; the leaf the step computes with
    is the slice of the spec without its data-parallel axes. The experts,
    MLA's up-projections, the attention's q and output projections and
    the MLP are split over 'model': never whole on a rank."""
    ranks, _, params = runs
    jmesh = _jmesh(shape)
    jp = params[arch]
    specs = _flat(j_policy.param_pspecs(jp, jmesh))
    whole = _flat(jax.tree.map(np.asarray, jp))
    split = [k for k in whole if k.rsplit("/", 1)[-1] in SPLIT[arch]]
    assert {k.rsplit("/", 1)[-1] for k in split} == set(SPLIT[arch])
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
        for k in split:
            assert got["local"][k].size * shape[1] == whole[k].size, (r, k)


def test_no_collective_on_a_one_rank_mesh():
    """(1, 1): a prefill, a decode step and a train step of the moe and
    audio families dispatch no collective (the model code takes no mesh
    context there)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import costing, steps
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models.factory import build_model
    from repro_torch.sharding.policy import place
    from repro_torch.train.optimizer import adamw

    mesh = make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    for arch in ARCHS:
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
        cache = grow_cache(cache, 1)
        _, c_dec = costing.count_ops(dec, params, cache,
                                     _decode_batch(inp, 0))
        state = place(opt.init(model.init(torch.Generator().manual_seed(0),
                                          device="cpu")), mesh)
        _, c_train = costing.count_ops(fn, params, state, _train_batch(inp))
        for c in (c_pre, c_dec, c_train):
            assert c.collectives()["count_by_type"] == {}, arch
