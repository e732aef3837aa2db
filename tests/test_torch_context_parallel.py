"""The port's context-parallel decode (``launch/steps`` on a batch that does
not split over the data-parallel axes: each 'data' rank holds a block of
the decode cache's sequence, as the reference's ``cache_pspecs`` splits
it, and the ranks combine their partial softmaxes) against the one-rank
port path and the reference: four gloo processes on the CPU (one
``torch.multiprocessing`` spawn), f32 smoke configs of zamba2-1.2b (the
hybrid's shared block), deepseek-7b (GQA, a bf16 and an int8 cache),
deepseek-v2 (MLA's latent cache), whisper-tiny (the self cache and the
32-frame cross cache) and mamba2-130m (no sequence cache), on
(data 2, model 1), (data 4, model 1) and (data 2, model 2) meshes, at
batch 1 and batch 3 (neither splits over 2 or 4 ranks). The cache holds
32 positions; a 10-token prompt and 16 teacher-forced steps write
positions 0-25, so the writes cross the blocks' edges at 8, 16 and 24.

* Prefill logits and every decode step's equal the reference's prefill
  and decode_step (unsharded, the same weights through
  ``params_from_jax``) and the one-rank port path: atol 1e-5 + rtol 1e-5
  (f32 softmax sums split over the ranks add in another order; a block,
  mask or combine fault moves logits by O(1)). With a bf16 or int8 cache
  that order can move a cached value across a rounding edge, one step of
  the cache's dtype, and every later step reads it: there the logits are
  held at atol 1e-4 + rtol 1e-4 end to end, and each step alone at 1e-5
  (``test_each_step_equals_the_one_rank_step``: the one-rank decode step
  on the ranks' blocks joined).
* After the prefill and after every step, each rank's cache leaves equal
  the slice of the one-rank path's whole cache that the reference's
  ``cache_pspecs`` gives the device at the rank's mesh coordinate. Along
  'model' the rank holds what the tensor-parallel steps compute with:
  the KV heads of its q heads (the int8 scales too, which the reference's
  spec leaves whole over 'model') and the SSM's B and C conv windows
  whole (its projections are replicated). Tolerance: f32 leaves the
  logits', bf16 leaves one bf16 step (rtol 2^-7), int8 values one
  quantization step.
* A decode step writes its token only in the block that holds its
  position: every other position of every rank's block is unchanged.
* No logit and no cache value is NaN, on the ranks whose blocks hold no
  valid key (every block past the current position).
* ``costing.OpCounter``: a decode step on a batch that splits (batch 4 on
  (2, 1)) and mamba2-130m's on batch 1 dispatch no all-reduce (the
  parameters' all-gathers over 'data' only); zamba2-1.2b's on batch 1 two
  a shared-block pass (the combine's max and sum). A one-rank mesh
  dispatches no collective (``test_no_collective_on_a_one_rank_mesh``).
* The partial softmax and its combine hold against ``sdpa`` and
  ``mla_attention_decode`` on simulated blocks of uneven validity, in one
  process.
"""
import functools
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

# (arch, cache dtype)
VARIANTS = (("zamba2-1.2b", "float32"), ("deepseek-7b", "bfloat16"),
            ("deepseek-7b", "int8"), ("deepseek-v2-236b", "float32"),
            ("whisper-tiny", "float32"), ("mamba2-130m", "float32"))
MESHES = ((2, 1), (4, 1), (2, 2))
BATCHES = (1, 3)
T, P, GEN, WORLD = 32, 10, 16, 4
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
QUANT_LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)   # bf16 and int8 caches
SEQ_LEAVES = ("k", "v", "k_scale", "v_scale", "c_kv", "k_rope")


def _cfg(registry, arch):
    return registry.smoke_config(arch).replace(dtype="float32")


def _inputs(cfg):
    """tokens (3, P + GEN) and whisper's frame embeddings (3, 32, d); a
    batch of b takes the first b rows."""
    rng = np.random.default_rng(3)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (3, P + GEN)
                                  ).astype(np.int32)}
    if cfg.family == "audio":
        out["enc_frames"] = (rng.standard_normal(
            (3, cfg.encoder.n_frames, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def _prefill_batch(inp, b):
    out = {"tokens": inp["tokens"][:b, :P]}
    if "enc_frames" in inp:
        out["enc_frames"] = inp["enc_frames"][:b]
    return out


def _decode_batch(inp, b, i):
    return {"tokens": inp["tokens"][:b, P + i:P + i + 1]}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(tree):
    """A copy of a cache's leaves (updated in place by the steps) as numpy
    arrays by path (bf16 as ml_dtypes')."""
    import ml_dtypes

    def conv(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16
                                                    ).copy()
        return x.numpy().copy()
    return {k: conv(v) for k, v in _flat(tree).items()}


# ---------------------------------------------------------------- ranks ---
@functools.lru_cache(maxsize=None)
def _submesh(shape):
    """A (data, model) mesh of ``shape`` over this rank's share of the
    four: the whole world, or for (2, 1) one of two replicas."""
    from repro_torch.launch.mesh import make_mesh_compat
    rep = WORLD // (shape[0] * shape[1])
    if rep == 1:
        return make_mesh_compat(shape, ("data", "model"), device="cpu")
    return make_mesh_compat((rep,) + tuple(shape), ("rep", "data", "model"),
                            device="cpu")["data", "model"]


def _rank_case(arch, kv, shape, b, params, inp, one):
    """One (variant, mesh, batch) on this rank: prefill + GEN steps
    through the steps, with the rank's logits and cache after each, and
    (``one``) the one-rank path's logits and whole caches."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models.factory import build_model
    from repro_torch.sharding.policy import place

    cfg = _cfg(registry, arch)
    model = build_model(cfg)
    mesh = _submesh(shape)
    placed = place(params, mesh)
    sc = ShapeConfig("cp", "decode", T, b, kv_dtype=kv)
    pre = steps.make_prefill_step(model, mesh, sc)
    dec = steps.make_decode_step(model, mesh, sc)
    logits, cache = pre(placed, _prefill_batch(inp, b))
    out = {"coord": tuple(mesh.get_coordinate()),
           "cp": (pre.context_parallel, dec.context_parallel),
           "logits": [logits.numpy()], "cache": [_np(cache)]}
    for i in range(GEN):
        logits, cache = dec(placed, cache, _decode_batch(inp, b, i))
        out["logits"].append(logits.numpy())
        out["cache"].append(_np(cache))
    if one:
        t = {k: torch.as_tensor(v) for k, v in _prefill_batch(inp, b).items()}
        lg, whole = model.prefill(params, t, kv_dtype=kv)
        whole = grow_cache(whole, T - P)
        out["one_logits"], out["one_cache"] = [lg.numpy()], [_np(whole)]
        for i in range(GEN):
            lg, whole = model.decode(params, whole, {
                k: torch.as_tensor(v)
                for k, v in _decode_batch(inp, b, i).items()})
            out["one_logits"].append(lg.numpy())
            out["one_cache"].append(_np(whole))
    return out


def _collectives(params, inps):
    """Rank-0's-eye counts of one decode step's collectives on (2, 1):
    zamba2-1.2b on batch 4 (splits) and batch 1, mamba2-130m on batch 1."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import costing, steps
    from repro_torch.models.factory import build_model
    from repro_torch.sharding.policy import place

    mesh = _submesh((2, 1))
    out = {}
    for arch, b in (("zamba2-1.2b", 4), ("zamba2-1.2b", 1),
                    ("mamba2-130m", 1)):
        model = build_model(_cfg(registry, arch))
        placed = place(params[arch, "float32"], mesh)
        sc = ShapeConfig("cp", "decode", T, b, kv_dtype="float32")
        cache = steps.decode_cache(model, mesh, sc, device="cpu")
        tok = np.zeros((b, 1), np.int32)
        _, c = costing.count_ops(steps.make_decode_step(model, mesh, sc),
                                 placed, cache, {"tokens": tok})
        out[arch, b] = c.collectives()["count_by_type"]
    # one all-gather a sharded leaf a layer: each layer gathers its own
    # shards as it runs, the leaves outside the stack once a step
    out["sharded_leaves"] = sum(
        (x.shape[0] if k.startswith("/layers/") else 1)
        * any(p.is_shard() for p in x.placements)
        for k, x in _flat(place(params["zamba2-1.2b", "float32"], mesh)
                          ).items())
    return out


def _worker(rank, port, tmp):
    import torch.distributed as dist

    from repro_torch.models.transformer import params_from_jax
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        params, inps = {}, {}
        for arch, kv in VARIANTS:
            with open(os.path.join(tmp, f"{arch}.pkl"), "rb") as f:
                pnp, inps[arch] = pickle.load(f)
            params[arch, kv] = params_from_jax(pnp, device="cpu")
        res = {}
        for arch, kv in VARIANTS:
            for shape in MESHES:
                for b in BATCHES:
                    res[arch, kv, shape, b] = _rank_case(
                        arch, kv, shape, b, params[arch, kv], inps[arch],
                        one=rank == 0 and shape == MESHES[0])
        res["collectives"] = _collectives(params, inps)
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
    """Room for T positions: the reference's self caches padded along
    their sequence axis; the cross cache keeps its frames."""
    keys = [str(e.key) for e in path if isinstance(e, jtu.DictKey)]
    if keys[-1] in SEQ_LEAVES and "cross" not in keys:
        pad = [(0, 0)] * x.ndim
        pad[2] = (0, T - x.shape[2])
        return jnp.pad(x, pad)
    return x


def _reference(arch, kv, jp, inp, b):
    """The reference's prefill + teacher-forced decode logits, unsharded."""
    jm = j_build(_cfg(j_registry, arch))
    jb = {k: jnp.asarray(v) for k, v in _prefill_batch(inp, b).items()}
    lg, cache = jax.jit(jm.prefill, static_argnames="kv_dtype")(
        jp, jb, kv_dtype=kv)
    cache = jtu.tree_map_with_path(_grow, cache)
    logits = [np.asarray(lg)]
    decode = jax.jit(jm.decode)
    for i in range(GEN):
        lg, cache = decode(jp, cache, {k: jnp.asarray(v) for k, v in
                                       _decode_batch(inp, b, i).items()})
        logits.append(np.asarray(lg))
    return logits


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results (spawned once, run beside the reference's
    JAX work), the reference's logits by (arch, cache dtype, batch), and
    its weights by arch."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("cp")
    params, inputs = {}, {}
    for arch, _ in VARIANTS:
        if arch in params:
            continue
        cfg = _cfg(j_registry, arch)
        params[arch] = j_build(cfg).init(jax.random.PRNGKey(0))
        inputs[arch] = _inputs(cfg)
        with open(tmp / f"{arch}.pkl", "wb") as f:
            pickle.dump((jax.tree.map(np.asarray, params[arch]),
                         inputs[arch]), f)
    ctx = mp.start_processes(_worker, args=(_free_port(), str(tmp)),
                             nprocs=WORLD, join=False, start_method="spawn")
    ref = {(arch, kv, b): _reference(arch, kv, params[arch], inputs[arch], b)
           for arch, kv in VARIANTS for b in BATCHES}
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


CASES = [(a, kv, m, b) for a, kv in VARIANTS for m in MESHES for b in BATCHES]
IDS = [f"{a}-{kv}-{m[0]}x{m[1]}-b{b}" for a, kv, m, b in CASES]


def _whole(ranks, arch, kv, b):
    return ranks[0][arch, kv, MESHES[0], b]


@pytest.mark.parametrize("arch,kv,shape,b", CASES, ids=IDS)
def test_logits_equal_the_reference_and_one_rank(runs, arch, kv, shape, b):
    ranks, ref, _ = runs
    want, one = ref[arch, kv, b], _whole(ranks, arch, kv, b)["one_logits"]
    tol = LOGIT_TOL if kv == "float32" else QUANT_LOGIT_TOL
    for r, res in enumerate(ranks):
        got = res[arch, kv, shape, b]
        assert got["cp"] == (True, True)
        assert len(got["logits"]) == GEN + 1
        for i, g in enumerate(got["logits"]):
            assert np.isfinite(g).all(), (r, i)
            np.testing.assert_allclose(g, want[i], err_msg=f"rank {r} step "
                                       f"{i} vs the reference", **tol)
            np.testing.assert_allclose(g, one[i], err_msg=f"rank {r} step "
                                       f"{i} vs one rank", **tol)


def _nest(flat, leaf=lambda v: v):
    """A flat {path: array} cache as its nested tree, ``leaf`` of each."""
    out = {}
    for k, v in flat.items():
        node = out
        *head, last = k.strip("/").split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = leaf(v)
    return out


def _held_spec(name, spec, specs_by_name):
    """The reference's cache spec, with what the port holds over 'model'
    in its place: the int8 scales split as their k/v, the SSM's B and C
    conv windows whole."""
    parts = list(spec)
    if name in ("k_scale", "v_scale"):
        parts[3] = tuple(specs_by_name[name[0]])[3]
    if name in ("conv_b", "conv_c"):
        parts[2] = None
    return jax.sharding.PartitionSpec(*parts)


def _tol(x):
    if x.dtype == np.int8:
        return dict(atol=1, rtol=0)
    if x.dtype.itemsize == 2:          # bfloat16 (ml_dtypes')
        return dict(atol=0, rtol=2.0 ** -7)
    return LOGIT_TOL


@pytest.mark.parametrize("arch,kv,shape,b", CASES, ids=IDS)
def test_each_rank_holds_its_cache_pspecs_slice(runs, arch, kv, shape, b):
    """After the prefill and after each step, each rank's cache is the
    slice of the whole cache that the reference's ``cache_pspecs`` gives
    its device, its sequence blocks over 'data' included; the one block
    that holds a step's position is the only one that step writes."""
    ranks, _, _ = runs
    whole = _whole(ranks, arch, kv, b)["one_cache"]
    jmesh = _jmesh(shape)
    specs = _flat(j_steps.cache_pspecs(_nest(whole[0]), j_base.ShapeConfig(
        "cp", "decode", T, b, kv_dtype=kv), jmesh))
    n_data = shape[0]
    for r, res in enumerate(ranks):
        got = res[arch, kv, shape, b]
        dev = jmesh.devices[got["coord"]]
        for k, w in whole[0].items():
            name = k.rsplit("/", 1)[-1]
            group = {n.rsplit("/", 1)[-1]: s for n, s in specs.items()
                     if n.rsplit("/", 1)[0] == k.rsplit("/", 1)[0]}
            spec = _held_spec(name, specs[k], group)
            if name in SEQ_LEAVES and w.shape[2] % n_data == 0:
                assert "data" in tuple(spec), (k, spec)
            idx = jax.sharding.NamedSharding(jmesh, spec) \
                .devices_indices_map(w.shape)[dev]
            for i, (mine, want) in enumerate(zip(got["cache"], whole)):
                assert mine[k].shape == want[k][idx].shape, (r, k, i)
                assert not np.isnan(mine[k].astype(np.float32)).any()
                np.testing.assert_allclose(
                    mine[k].astype(np.float32),
                    want[k][idx].astype(np.float32),
                    err_msg=f"rank {r} {k} after step {i}",
                    **_tol(mine[k]))
            if name not in SEQ_LEAVES or k.startswith("/cross"):
                continue
            t = mine[k].shape[2]
            start = (got["coord"][0] * t if "data" in tuple(spec) else 0)
            for i in range(1, GEN + 1):
                pos = P + i - 1
                changed = np.nonzero((got["cache"][i][k]
                                      != got["cache"][i - 1][k]).any(
                    axis=tuple(a for a in range(mine[k].ndim) if a != 2)))[0]
                own = start <= pos < start + t
                assert list(changed + start) == ([pos] if own else []), \
                    (r, k, i, changed, start)


def _tensor(v):
    """A numpy array (bf16 as ml_dtypes') as a tensor of its own."""
    if str(v.dtype) == "bfloat16":
        return torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(v.copy())


def _joined(ranks, arch, kv, shape, b, i):
    """The ranks' caches after step i of a (n, 1) mesh, their blocks
    joined along each sequence axis that 'data' splits."""
    parts = sorted((res[arch, kv, shape, b]["coord"][0],
                    res[arch, kv, shape, b]["cache"][i]) for res in ranks
                   [:shape[0]])
    return {k: (np.concatenate([p[k] for _, p in parts], axis=2)
                if k.rsplit("/", 1)[-1] in SEQ_LEAVES else x)
            for k, x in parts[0][1].items()}


STEP_CASES = [(a, kv, m, b) for a, kv in VARIANTS for m in MESHES[:2]
              for b in BATCHES]


@pytest.mark.parametrize("arch,kv,shape,b", STEP_CASES,
                         ids=[f"{a}-{kv}-{m[0]}x{m[1]}-b{b}"
                              for a, kv, m, b in STEP_CASES])
def test_each_step_equals_the_one_rank_step(runs, arch, kv, shape, b):
    """On (2, 1) and (4, 1), each decode step of the ranks equals the
    one-rank decode step run on their blocks joined, at LOGIT_TOL, and
    writes what it writes (the cache tolerances above): a step held
    alone, whatever a bf16 or int8 cache carried over from the steps
    before."""
    from repro_torch.configs import registry
    from repro_torch.models.factory import build_model
    from repro_torch.models.transformer import params_from_jax
    ranks, _, jparams = runs
    model = build_model(_cfg(registry, arch))
    params = params_from_jax(jax.tree.map(np.asarray, jparams[arch]),
                             device="cpu")
    inp = _inputs(_cfg(j_registry, arch))
    got = ranks[0][arch, kv, shape, b]
    for i in range(GEN):
        cache = _nest(_joined(ranks, arch, kv, shape, b, i), _tensor)
        batch = _decode_batch(inp, b, i)
        lg, cache = model.decode(params, cache, {
            k: torch.as_tensor(v) for k, v in batch.items()})
        np.testing.assert_allclose(got["logits"][i + 1], lg.numpy(),
                                   err_msg=f"step {i}", **LOGIT_TOL)
        after = _joined(ranks, arch, kv, shape, b, i + 1)
        for k, x in _np(cache).items():
            np.testing.assert_allclose(after[k].astype(np.float32),
                                       x.astype(np.float32),
                                       err_msg=f"{k} step {i}", **_tol(x))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "deepseek-7b",
                                  "deepseek-v2-236b", "whisper-tiny"])
def test_a_rank_with_no_valid_key_gives_no_nan(runs, arch):
    """On (4, 1) the blocks from 16 and from 24 hold no valid key until
    the position reaches them: the ranks' logits stay finite and equal to
    the one-rank path's at every step (the test above holds them), and
    those blocks are still zero after the prefill."""
    ranks, _, _ = runs
    for res in ranks[2:]:
        got = res[arch, "float32" if arch != "deepseek-7b" else "bfloat16",
                  (4, 1), 1]
        assert got["coord"][0] >= 2
        for k, v in got["cache"][0].items():
            if k.rsplit("/", 1)[-1] in SEQ_LEAVES and \
                    not k.startswith("/cross"):
                assert not v.astype(np.float32).any(), k
        assert all(np.isfinite(lg).all() for lg in got["logits"])


def test_no_new_collective_on_a_batch_that_splits(runs):
    """A decode step on (2, 1): batch 4 splits (only the parameters'
    all-gathers over 'data', a layer's as it runs), mamba2-130m has no sequence
    cache (no all-reduce), zamba2-1.2b's batch 1 adds the combine's max
    and sum for each of its two shared-block passes."""
    ranks, _, _ = runs
    for res in ranks:
        c = res["collectives"]
        assert c["zamba2-1.2b", 4] == {"all-gather": c["sharded_leaves"]}
        assert "all-reduce" not in c["mamba2-130m", 1]
        assert c["zamba2-1.2b", 1] == {"all-gather": c["sharded_leaves"],
                                       "all-reduce": 4}


def test_no_collective_on_a_one_rank_mesh():
    """(1, 1): batch 1 never splits the cache; a prefill and a decode step
    dispatch no collective, and the cache is whole."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import costing, steps
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models.factory import build_model
    from repro_torch.sharding.policy import place

    mesh = make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    for arch in ("zamba2-1.2b", "deepseek-v2-236b", "whisper-tiny"):
        cfg = _cfg(registry, arch)
        model = build_model(cfg)
        params = place(model.init(torch.Generator().manual_seed(0),
                                  device="cpu"), mesh)
        sc = ShapeConfig("cp", "decode", T, 1)
        pre = steps.make_prefill_step(model, mesh, sc)
        dec = steps.make_decode_step(model, mesh, sc)
        assert not (pre.context_parallel or dec.context_parallel)
        batch = _prefill_batch(_inputs(cfg), 1)
        (_, cache), c_pre = costing.count_ops(pre, params, batch)
        cache = steps.decode_cache(model, mesh, sc, device="cpu")
        assert all(x.shape[2] == (cfg.encoder.n_frames if k.startswith(
            "/cross") else T) for k, x in _flat(cache).items()
            if k.rsplit("/", 1)[-1] in SEQ_LEAVES)
        _, c_dec = costing.count_ops(dec, params, cache,
                                     _decode_batch(_inputs(cfg), 1, 0))
        for c in (c_pre, c_dec):
            assert c.collectives()["count_by_type"] == {}, arch


# ------------------------------------------------------- one process ---
class _Blocks:
    """``policy.max_dp``/``sum_dp`` over simulated ranks: partials stacked
    on a leading axis, one a block."""

    @staticmethod
    def max(x, dp):
        return x.amax(0, keepdim=True).expand_as(x)

    @staticmethod
    def sum(x, dp):
        return x.sum(0, keepdim=True).expand_as(x)


def _validity(b, t, n, pos):
    """(n, b, t // n): block r of each row's keys valid up to pos[row]."""
    gpos = torch.arange(t)
    return torch.stack([(gpos[None] <= pos[:, None])[:, r * t // n:
                                                     (r + 1) * t // n]
                        for r in range(n)])


@pytest.mark.parametrize("n", [2, 4])
def test_partial_softmax_combine_equals_sdpa(monkeypatch, n):
    """Four blocks of 8 keys, rows valid up to 3, 12, 20 and 31: some
    blocks all valid, some partly, some with no valid key."""
    from repro_torch.models import attention as attn
    from repro_torch.sharding import policy
    monkeypatch.setattr(policy, "max_dp", _Blocks.max)
    monkeypatch.setattr(policy, "sum_dp", _Blocks.sum)
    g = torch.Generator().manual_seed(0)
    b, t, kh, gp, dh = 4, 32, 2, 3, 16
    q = torch.randn((b, 1, kh * gp, dh), generator=g)
    k = torch.randn((b, t, kh, dh), generator=g) * 2
    v = torch.randn((b, t, kh, 24), generator=g)
    pos = torch.tensor([3, 12, 20, 31])
    valid = _validity(b, t, n, pos)
    want = attn.sdpa(q, k, v, k_valid=torch.cat(list(valid), 1), gp=gp)
    parts = [attn.sdpa_partial(q, kb, vb, k_valid=vb_, gp=gp)
             for kb, vb, vb_ in zip(k.chunk(n, 1), v.chunk(n, 1), valid)]
    o, m, l = (torch.stack(x) for x in zip(*parts))
    assert torch.isinf(m).any() and not torch.isnan(o).any()
    assert (o[torch.isinf(m)] == 0).all() and (l[torch.isinf(m)] == 0).all()
    got = attn.combine_partials(o, m, l, None)
    for r in range(n):
        torch.testing.assert_close(got[r], want, **LOGIT_TOL)


def test_partial_mla_decode_equals_the_whole(monkeypatch):
    """``mla_attention_decode`` over four blocks of the latent cache, the
    blocks' latent partials combined before ``w_uv``, equals it over the
    whole cache."""
    from repro_torch.configs import registry
    from repro_torch.models import attention as attn
    from repro_torch.models.common import rope_for_heads
    from repro_torch.sharding import policy
    cfg = _cfg(registry, "deepseek-v2-236b")
    g = torch.Generator().manual_seed(1)
    p = attn.init_mla(g, cfg, device="cpu")
    b, t, n = 4, 32, 4
    m = cfg.mla
    x = torch.randn((b, 1, cfg.d_model), generator=g)
    c_kv = torch.randn((b, t, m.kv_lora_rank), generator=g)
    k_rope = torch.randn((b, t, m.qk_rope_head_dim), generator=g)
    pos = torch.tensor([3, 12, 20, 31])
    cos, sin = rope_for_heads(pos[:, None], m.qk_rope_head_dim,
                              cfg.rope_theta)
    valid = _validity(b, t, n, pos)
    want = attn.mla_attention_decode(p, x, cfg, cos, sin, c_kv, k_rope,
                                     torch.cat(list(valid), 1))
    captured = []

    def combine(o, m_, l, dp):
        captured.append((o, m_, l))
        return o
    monkeypatch.setattr(attn, "combine_partials", combine)
    for r in range(n):
        attn.mla_attention_decode(p, x, cfg, cos, sin, c_kv.chunk(n, 1)[r],
                                  k_rope.chunk(n, 1)[r], valid[r], dp=object())
    monkeypatch.undo()
    monkeypatch.setattr(policy, "max_dp", _Blocks.max)
    monkeypatch.setattr(policy, "sum_dp", _Blocks.sum)
    o, m_, l = (torch.stack(z) for z in zip(*captured))
    assert torch.isinf(m_).any() and not torch.isnan(o).any()
    lat = attn.combine_partials(o, m_, l, None)[0].to(x.dtype)
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, cfg.n_heads, m.v_head_dim)
    ctx = torch.einsum("bshr,rhv->bshv", lat, w_uv)
    got = ctx.reshape(b, 1, -1) @ p["wo"]
    torch.testing.assert_close(got, want, **LOGIT_TOL)
