"""The port's training substrate (configs/{base.ShapeConfig,shapes,
deployment}, the mesh half of sharding/policy, train/{compression,
checkpoint,runtime}, data/pipeline, launch/steps' loss, specs and counts)
against the reference, on the CPU.

Tolerances: ``lm_loss`` within 1e-6 relative (f32 sums of 64 terms in
another order); the compressors exactly equal (the same f32 arithmetic
on the same entries; the data has no ties in |g + r|, where
``torch.topk`` and ``jax.lax.top_k`` may keep different entries);
error feedback within 1e-6 (one f32 rounding of g + r). Specs, counts,
checkpoint bytes and recovery are exact.
"""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as j_base  # noqa: E402
from repro.configs import deployment as j_dep  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.configs import shapes as j_shapes  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models.factory import build_model as j_build  # noqa: E402
from repro.sharding import policy as j_policy  # noqa: E402
from repro.train import checkpoint as j_ck  # noqa: E402
from repro.train import compression as j_comp  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import deployment as t_dep  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.configs import shapes as t_shapes  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.models.factory import build_model as t_build  # noqa: E402
from repro_torch.sharding import policy as t_policy  # noqa: E402
from repro_torch.train import checkpoint as t_ck  # noqa: E402
from repro_torch.train import compression as t_comp  # noqa: E402
from repro_torch.train import runtime as t_rt  # noqa: E402

ARCHS = sorted(j_registry.ARCHS)
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


# ---------------------------------------------------------- pure Python ----
def test_shape_config_fields_and_defaults_equal_the_reference():
    got = [(f.name, f.type, f.default) for f in
           dataclasses.fields(t_base.ShapeConfig)]
    want = [(f.name, f.type, f.default) for f in
            dataclasses.fields(j_base.ShapeConfig)]
    assert got == want


def test_shapes_applicability_and_tuned_shapes_equal_the_reference():
    assert sorted(t_shapes.SHAPES) == sorted(j_shapes.SHAPES)
    for name in j_shapes.SHAPES:
        assert dataclasses.asdict(t_shapes.SHAPES[name]) == \
            dataclasses.asdict(j_shapes.SHAPES[name])
    for arch in ARCHS:
        ja, ta = j_registry.get_arch(arch), t_registry.get_arch(arch)
        for name in j_shapes.SHAPES:
            js, ts = j_shapes.SHAPES[name], t_shapes.SHAPES[name]
            assert t_shapes.shape_applicable(ta, ts) == \
                j_shapes.shape_applicable(ja, js), (arch, name)
            assert dataclasses.asdict(t_dep.tuned_shape(ta, ts)) == \
                dataclasses.asdict(j_dep.tuned_shape(ja, js)), (arch, name)


# ---------------------------------------------------------------- policy ---
# the reference's abstract init traces every layer: deepseek-v2's 60
# layers of 160 experts take ~50 s here, so both packages' trees are built
# at CUT layers (specs do not depend on depth: the layer axis replicates)
# and its full-depth count is extrapolated from 1 and 2 layers
CUT = {"deepseek-v2-236b": 2}


def _cfgs(arch, **kw):
    kw = dict(head_pad_to=16, **kw)
    return (j_registry.get_arch(arch).replace(**kw),
            t_registry.get_arch(arch).replace(**kw))


@pytest.fixture(scope="module")
def abstract():
    """Both packages' abstract parameter trees of every arch (head_pad_to
    16, as tests/test_distributed.py pads them for the production mesh):
    the reference's from ``jax.eval_shape``, the port's meta tensors."""
    out = {}
    for arch in ARCHS:
        jc, tc = _cfgs(arch, **({"n_layers": CUT[arch]} if arch in CUT
                                else {}))
        out[arch] = (j_steps.abstract_params(j_build(jc)),
                     t_steps.abstract_params(t_build(tc)))
    return out


def _j_leaves_with_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


def _t_leaves_with_paths(tree):
    return {"/".join(str(p) for p in path): leaf for path, leaf in
            _t_paths(tree)}


def _t_paths(tree, path=()):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _t_paths(tree[k],
                                                             path + (k,))]
    return [(path, tree)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_specs_equal_the_reference_on_the_production_meshes(
        abstract, mesh):
    """Leaf for leaf, all ten archs: the reference's ``param_pspecs`` on a
    stand-in that has only axis names and a devices array of the mesh's
    shape, the port's on a ``MeshShape``."""
    names, shape = MESHES[mesh]
    j_mesh = types.SimpleNamespace(axis_names=names,
                                   devices=np.empty(shape))
    t_mesh = t_policy.MeshShape(names, shape)
    for arch in ARCHS:
        j_shapes_, t_shapes_ = abstract[arch]
        want = _j_leaves_with_paths(j_policy.param_pspecs(j_shapes_, j_mesh))
        got = _t_leaves_with_paths(t_policy.param_pspecs(t_shapes_, t_mesh))
        assert sorted(got) == sorted(want), arch
        for k in want:
            assert tuple(got[k]) == tuple(want[k]), (arch, k)
            # the serving specs (tp_only): ZeRO axes dropped
            assert tuple(t_steps._drop_fsdp(got[k])) == \
                tuple(j_steps._drop_fsdp(want[k])), (arch, k)


def test_optimizer_state_specs_follow_the_params_as_the_reference(abstract):
    """``opt_state_sds``: AdamW's m and v take their parameter's spec, the
    step count none, as the reference's ``param_pspecs`` gives them on
    its optimizer state; ``params_sds`` pairs each meta tensor with its
    spec."""
    from repro.train.optimizer import adamw as j_adamw
    from repro_torch.train.optimizer import adamw as t_adamw
    names, shape = MESHES["2x16x16"]
    j_mesh = types.SimpleNamespace(axis_names=names,
                                   devices=np.empty(shape))
    t_mesh = t_policy.MeshShape(names, shape)
    j_shapes_, t_shapes_ = abstract["zamba2-1.2b"]
    j_state = jax.eval_shape(j_adamw(1e-3).init, j_shapes_)
    want = _j_leaves_with_paths(j_policy.param_pspecs(j_state, j_mesh))
    pairs, specs = t_steps.opt_state_sds(t_adamw(1e-3), t_shapes_, t_mesh)
    got = _t_leaves_with_paths(specs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), k
    paired = _t_leaves_with_paths(pairs)
    assert all(isinstance(v, t_steps.TensorSpec) and
               tuple(v.spec) == tuple(got[k]) for k, v in paired.items())
    assert paired["m/layers/ssm/w_x"].meta.dtype == torch.float32
    model = t_build(t_registry.get_arch("zamba2-1.2b").replace(
        head_pad_to=16))
    pairs, specs = t_steps.params_sds(model, t_mesh)
    assert {k: tuple(v.spec) for k, v in
            _t_leaves_with_paths(pairs).items()} == \
        {k: tuple(v) for k, v in _t_leaves_with_paths(specs).items()}


def test_param_counts_from_meta_trees_equal_the_reference(abstract):
    """tests/test_models_smoke.py's five archs (and the other five), total
    and active parameters; deepseek-v2 at full depth against the
    reference's count at 1 and 2 layers, extrapolated (its layers are
    alike)."""
    name = "deepseek-v2-236b"
    jc, _ = _cfgs(name, n_layers=1)
    one = j_steps.count_params_from_shapes(j_steps.abstract_params(
        j_build(jc)))
    two = j_steps.count_params_from_shapes(abstract[name][0])
    full = t_steps.count_params_from_shapes(t_steps.abstract_params(
        t_build(_cfgs(name)[1])))
    depth = t_registry.get_arch(name).n_layers
    assert full == two + (depth - 2) * (two - one)
    for arch in ARCHS:
        j_shapes_, t_shapes_ = abstract[arch]
        cfg = t_registry.get_arch(arch)
        assert all(x.device.type == "meta"
                   for x in _t_leaves_with_paths(t_shapes_).values())
        assert t_steps.count_params_from_shapes(t_shapes_) == \
            j_steps.count_params_from_shapes(j_shapes_), arch
        assert t_steps.count_active_params(t_shapes_, cfg) == \
            j_steps.count_active_params(j_shapes_,
                                        j_registry.get_arch(arch)), arch


def test_input_and_cache_specs_equal_the_reference(monkeypatch):
    """``input_specs`` and ``cache_pspecs`` (through ``cache_specs_sds``)
    on the production mesh for the decode and train cells, every arch
    (smoke widths: the specs' logic is shape-driven). The reference's
    ShapeDtypeStructs are stood in for by their shape and spec."""
    monkeypatch.setattr(j_steps, "_sds", lambda shape, dtype, mesh, spec:
                        types.SimpleNamespace(shape=shape, spec=spec))
    names, shape = MESHES["16x16"]
    j_mesh = types.SimpleNamespace(axis_names=names,
                                   devices=np.empty(shape))
    t_mesh = t_policy.MeshShape(names, shape)
    for arch in ARCHS:
        jc = j_registry.smoke_config(arch)
        tc = t_registry.smoke_config(arch)
        for cell in (j_base.ShapeConfig("d", "decode", 64, 32),
                     j_base.ShapeConfig("l", "decode", 64, 1),
                     j_base.ShapeConfig("t", "train", 64, 32)):
            tcell = t_base.ShapeConfig(**dataclasses.asdict(cell))
            js = {k: (tuple(v.shape), tuple(v.spec)) for k, v in
                  j_steps.input_specs(jc, cell, j_mesh).items()}
            ts = {k: (tuple(v.meta.shape), tuple(v.spec))
                  for k, v in t_steps.input_specs(tc, tcell, t_mesh).items()}
            assert ts == js, (arch, cell.name)
            if cell.kind != "decode":
                continue
            jcache = jax.eval_shape(lambda: j_build(jc).init_cache(
                cell.global_batch, cell.seq_len, cell.kv_dtype))
            want = _j_leaves_with_paths(
                j_steps.cache_pspecs(jcache, cell, j_mesh))
            got = t_steps.cache_specs_sds(t_build(tc), tcell, t_mesh)
            got = {k: (tuple(v.meta.shape), tuple(v.spec)) for k, v in
                   _t_leaves_with_paths(got).items()}
            jsh = {k: tuple(v.shape) for k, v in
                   _j_leaves_with_paths(jcache).items()}
            assert sorted(got) == sorted(want), arch
            for k in want:
                assert got[k] == (jsh[k], tuple(want[k])), (arch, k)


def test_placements_put_pod_major_shards_where_the_reference_does():
    """('pod', 'data') on one tensor dim is Shard(d) on both mesh dims in
    mesh order; a size-1 or indivisible axis replicates."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = t_policy.MeshShape(("pod", "data", "model"), (2, 4, 2))
    spec = t_policy.spec_for("wq", (64, 6), mesh)
    assert spec == (("pod", "data"), "model")
    assert t_policy.placements(spec, mesh) == (Shard(0), Shard(0), Shard(1))
    spec = t_policy.spec_for("wo", (3, 64), mesh)
    assert spec == (None, ("pod", "data"))
    assert t_policy.placements(spec, mesh) == (Shard(1), Shard(1),
                                                Replicate())
    assert t_policy.batch_spec(mesh, 3) == (("pod", "data"), None, None)
    assert t_policy.batch_spec(t_policy.MeshShape(("data", "model"),
                                                  (4, 2)), 2) == \
        ("data", None)


# -------------------------------------------------------------- lm_loss ----
def test_lm_loss_with_vocab_padding_and_masked_labels():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 8, 40)).astype(np.float32)
    labels = rng.integers(0, 33, (2, 8)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, 5] = -7
    want = float(j_steps.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                                 33))
    got = float(t_steps.lm_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels), 33))
    assert got == pytest.approx(want, rel=1e-6)
    # every label masked: the reference's max(count, 1) guard
    none = np.full_like(labels, -1)
    assert float(t_steps.lm_loss(torch.from_numpy(logits),
                                 torch.from_numpy(none), 33)) == 0.0


# ---------------------------------------------------------- compression ----
def _tie_free(shape, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape).astype(np.float32)
    r = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    mags = np.abs(g + r).ravel()
    assert len(np.unique(mags)) == mags.size      # no ties in |g + r|
    return g, r


@pytest.mark.parametrize("make", ["topk", "int8"])
def test_compressors_equal_the_reference_with_error_feedback(make):
    t_c = {"topk": lambda: t_comp.topk_compressor(0.25),
           "int8": t_comp.int8_compressor}[make]()
    j_c = {"topk": lambda: j_comp.topk_compressor(0.25),
           "int8": j_comp.int8_compressor}[make]()
    g, r = _tie_free((8, 8), 0)
    h, _ = _tie_free((5,), 1)
    grads = {"w": g, "b": [h]}
    state = t_c.init({"w": torch.from_numpy(g), "b": [torch.from_numpy(h)]})
    assert all(float(x.abs().sum()) == 0 for x in (state["w"],
                                                   state["b"][0]))
    state = {"w": torch.from_numpy(r), "b": [torch.zeros(5)]}
    j_state = {"w": jnp.asarray(r), "b": [jnp.zeros(5)]}
    for _ in range(3):
        dec, new, stats = t_c.apply(
            {"w": torch.from_numpy(grads["w"]),
             "b": [torch.from_numpy(grads["b"][0])]}, state)
        j_dec, j_new, j_stats = j_c.apply(
            {"w": jnp.asarray(grads["w"]), "b": [jnp.asarray(h)]}, j_state)
        assert stats == j_stats
        for got, want in ((dec["w"], j_dec["w"]), (dec["b"][0],
                                                   j_dec["b"][0]),
                          (new["w"], j_new["w"]), (new["b"][0],
                                                   j_new["b"][0])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # error feedback: nothing is lost
        np.testing.assert_allclose((dec["w"] + new["w"]).numpy(),
                                   grads["w"] + state["w"].numpy(),
                                   atol=1e-6)
        state, j_state = new, j_new


def test_compressed_training_still_converges():
    from repro_torch.train.optimizer import adamw
    opt = adamw(0.05)
    comp = t_comp.topk_compressor(0.5)
    params = {"w": torch.tensor([4.0, -3.0, 2.0, -1.0])}
    state = opt.init(params)
    resid = comp.init(params)
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        dec, resid, _ = comp.apply(grads, resid)
        params, state, _ = opt.update(dec, state, params)
    assert float(params["w"].abs().max()) < 5e-2


# ----------------------------------------------------------- checkpoint ----
def _trees(seed=0):
    """The same tree in both packages: bf16, f32 and int32 leaves, a
    list, a 0-d leaf."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    jt = {"layers": {"wq": jnp.asarray(w, jnp.bfloat16),
                     "scale": jnp.asarray(w[0])},
          "stack": [jnp.arange(5, dtype=jnp.int32), jnp.float32(3.5)],
          "count": jnp.int32(7)}
    tt = {"layers": {"wq": torch.from_numpy(w).to(torch.bfloat16),
                     "scale": torch.from_numpy(w[0].copy())},
          "stack": [torch.arange(5, dtype=torch.int32),
                    torch.tensor(3.5)],
          "count": torch.tensor(7, dtype=torch.int32)}
    return jt, tt


def test_checkpoints_are_byte_identical_to_the_reference(tmp_path):
    jt, tt = _trees()
    j_dir = j_ck.save(tmp_path / "j", 3, jt)
    t_dir = t_ck.save(tmp_path / "t", 3, tt)
    jm = (j_dir / "manifest.json").read_text()
    tm = (t_dir / "manifest.json").read_text()
    assert tm == jm
    for leaf in json.loads(jm)["leaves"]:
        assert (t_dir / leaf["file"]).read_bytes() == \
            (j_dir / leaf["file"]).read_bytes(), leaf["key"]
    assert {m["dtype"] for m in json.loads(jm)["leaves"]} == \
        {"bfloat16", "float32", "int32"}


def test_checkpoints_restore_across_the_packages(tmp_path):
    jt, tt = _trees(1)
    t_ck.save(tmp_path / "t", 2, tt)
    j_ck.save(tmp_path / "j", 2, jt)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(jnp.shape(x),
                                                       x.dtype), jt)
    back = j_ck.restore(tmp_path / "t", 2, like)        # port -> reference
    assert back["layers"]["wq"].dtype == jnp.bfloat16
    got = t_ck.restore(tmp_path / "j", 2, tt, device="cpu")
    assert got["layers"]["wq"].dtype == torch.bfloat16
    for (j, t), (jb, tb) in zip(zip(jax.tree.leaves(back),
                                    jax.tree.leaves(jt)),
                                zip(_flat_t(got), _flat_t(tt))):
        np.testing.assert_array_equal(np.asarray(j, np.float32),
                                      np.asarray(t, np.float32))
        assert torch.equal(jb, tb)
    assert got["count"].dim() == 0 and got["count"].device.type == "cpu"


def _flat_t(tree):
    from repro_torch.train.optimizer import tree_leaves
    return tree_leaves(tree)


def test_checkpoint_gc_keeps_keep_and_latest_step(tmp_path):
    _, tt = _trees()
    for s in (1, 2, 3, 4, 5):
        t_ck.save(tmp_path, s, tt, keep=2)
    assert t_ck.latest_step(tmp_path) == 5
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_4", "step_5"]
    assert not list(tmp_path.glob(".tmp_*"))


def test_async_saver_copies_on_the_caller(tmp_path):
    """A tensor changed right after ``save`` returns is saved as it was."""
    _, tt = _trees()
    before = tt["layers"]["scale"].clone()
    saver = t_ck.AsyncSaver()
    saver.save(tmp_path, 1, tt)
    tt["layers"]["scale"].add_(100.0)
    saver.wait()
    back = t_ck.restore(tmp_path, 1, tt, device="cpu")
    assert torch.equal(back["layers"]["scale"], before)


# -------------------------------------------------------------- runtime ----
def test_runtime_recovers_and_matches_uninterrupted(tmp_path):
    def step_fn(params, opt, batch):
        p = {"w": params["w"] + batch["x"]}
        return p, opt, {"loss": p["w"].sum()}

    def batches(step):
        return {"x": torch.tensor(float(step + 1))}

    rt = t_rt.TrainRuntime(step_fn, t_rt.RuntimeConfig(str(tmp_path / "a"),
                                                        ckpt_every=3),
                           device="cpu")
    p0 = {"w": torch.tensor([0.0])}
    pa, _, hist_a = rt.run(p0, {}, batches, num_steps=10)
    rt = t_rt.TrainRuntime(step_fn, t_rt.RuntimeConfig(str(tmp_path / "b"),
                                                        ckpt_every=3),
                           device="cpu")
    rt.inject_failure_at = {5, 8}
    pb, _, hist_b = rt.run(p0, {}, batches, num_steps=10)
    assert rt.recoveries == 2
    assert torch.equal(pa["w"], pb["w"])           # replay-exact
    assert [h["step"] for h in hist_a] == list(range(10))
    assert float(p0["w"]) == 0.0                   # the input is untouched


def test_runtime_recovery_of_a_model_is_replay_exact(tmp_path):
    """mamba2-130m's smoke config (f32) through ``launch.train.setup``:
    failures at steps 2 and 4, checkpoints every 2 steps; params and
    optimizer state ``torch.equal`` to the uninterrupted run's."""
    from repro_torch.launch import train as t_train
    from repro_torch.train.optimizer import tree_leaves

    def run(name, fail):
        args = t_train.parse_args([
            "--arch", "mamba2-130m", "--steps", "6", "--batch", "2",
            "--seq", "32", "--ckpt-every", "2", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / name)])
        st = t_train.setup(args, log=lambda _: None)
        st.runtime.inject_failure_at = fail
        p, o, hist = st.runtime.run(st.params, st.opt_state, st.batches,
                                    num_steps=6)
        return p, o, hist, st.runtime.recoveries

    pa, oa, ha, ra = run("a", set())
    pb, ob, hb, rb = run("b", {2, 4})
    assert (ra, rb) == (0, 2)
    for x, y in zip(tree_leaves((pa, oa)), tree_leaves((pb, ob))):
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        y = y.full_tensor() if hasattr(y, "full_tensor") else y
        assert torch.equal(x, y)
    assert ha[-1]["loss"] == hb[-1]["loss"]
    assert np.isfinite([h["loss"] for h in ha]).all()


def test_straggler_detector():
    det = t_rt.StragglerDetector(warmup=3, z_thresh=2.5)
    flagged = [det.observe(i, 0.1 + 0.001 * (i % 2)) for i in range(20)]
    assert not any(flagged)
    assert det.observe(20, 1.5)          # 15x normal -> flagged
    assert det.flagged[0][0] == 20
    assert not det.observe(21, 0.1)      # baseline not poisoned


# -------------------------------------------------------- data pipeline ----
def test_prefetcher_preserves_stream_and_propagates_errors():
    items = list(range(50))
    assert list(t_pipe.Prefetcher(iter(items), depth=4)) == items

    def gen():
        yield 1
        raise ValueError("boom")
    with pytest.raises(ValueError):
        list(t_pipe.Prefetcher(gen()))


def test_batched_equals_the_reference():
    x = np.arange(10)[:, None]
    y = np.arange(10)
    got = list(t_pipe.batched(x, y, 4, epochs=2, seed=3))
    want = list(j_pipe.batched(x, y, 4, epochs=2, seed=3))
    assert len(got) == len(want) == 4     # 2 per epoch (drop remainder)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["labels"], w["labels"])


def test_rank_rows_cut_each_micro_batch_over_the_ranks():
    """Rank r of 2, 2 micro-batches of a batch of 8: rows 2r, 2r+1 of
    micro-batch 0 (rows 0-3) and of micro-batch 1 (rows 4-7)."""
    assert t_pipe.rank_rows(8, 2, 0, 2).tolist() == [0, 1, 4, 5]
    assert t_pipe.rank_rows(8, 2, 1, 2).tolist() == [2, 3, 6, 7]
    assert t_pipe.rank_rows(8, 1, 1, 2).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError):
        t_pipe.rank_rows(6, 2, 0, 2)
