"""One training step of the port (launch/steps.make_train_step, at dp = 1 on
a gloo world of 1) against the reference's, on the CPU: one smoke arch
per family, f32, the same numpy batch and the reference's initial weights
(``params_from_jax``).

Each step runs with an identity optimizer in both packages (its update
returns the gradients as the new parameters), so the step's loss and its
gradients (the mean over the micro-batches, compressed where the case
says so) are compared directly: loss within 1e-6 relative, each gradient
leaf within atol 1e-6 + rtol 1e-4 (f32 sums of a few hundred terms in
another order, through the remat recomputation too). The cases cover
``n_micro`` 2 (phi3.5-moe), remat "full", "dots" and "none", and an int8
compressed step (its per-tensor scale and rounding on the reduced
gradients: the same entries round alike unless they sit within an f32
rounding of a half-step, which these seeded inputs do not).

The AdamW step (zamba2) compares the loss and grad norm within 1e-5
relative, and the updated parameters within 1e-7 (a few ulps of the
weights) where the gradient is above 1e-4, and within 2 lr everywhere:
AdamW's first step moves each entry by lr * g / (|g| + eps), which moves
by lr * eps * dg / g^2 when g moves by dg; at the gradients' tolerance
that is ~1e-9 above 1e-4, and O(lr) where |g| is within a few eps
(1e-8) of zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as j_base  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models.factory import build_model as j_build  # noqa: E402
from repro.train import compression as j_comp  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh_compat  # noqa: E402
from repro_torch.models.factory import build_model as t_build  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.sharding.policy import place  # noqa: E402
from repro_torch.train import compression as t_comp  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402

B, S = 4, 32
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
# arch -> (micro-batch seqs a shard, remat policy, compressor)
CASES = {
    "mamba2-130m": (B, "full", "int8"),
    "zamba2-1.2b": (B, "dots", None),
    "deepseek-7b": (B, "none", None),
    "phi3.5-moe-42b-a6.6b": (B // 2, "full", None),
    "deepseek-v2-236b": (B, "full", None),
    "qwen2-vl-72b": (B, "full", None),
    "whisper-tiny": (B, "full", None),
}


def _ident(opt_cls):
    return opt_cls(init=lambda p: {}, update=lambda g, s, p: (g, s, {}))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :5] = -1                     # masked labels
    if cfg.family == "audio":
        batch["enc_frames"] = (rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        batch["mrope_positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, None], (3, B, S)).copy()
        batch["vision_embeds"] = (rng.standard_normal(
            (B, cfg.vision.n_patches, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def mesh():
    return make_mesh_compat((1, 1), ("data", "model"), device="cpu")


def _j_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _setup(arch):
    jc = j_registry.smoke_config(arch).replace(dtype="float32")
    tc = t_registry.smoke_config(arch).replace(dtype="float32")
    p = j_build(jc).init(jax.random.PRNGKey(0))
    return jc, tc, p, params_from_jax(jax.tree.map(np.asarray, p),
                                      device="cpu")


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _close(got, want, **tol):
    g, w = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(_whole(g[k]).numpy(), w[k], err_msg=k,
                                   **tol)


_REF: dict = {}


def _reference(arch):
    """The reference's identity-optimizer step of a case (once per test
    module): (initial params, gradients, residual, metrics, info)."""
    if arch not in _REF:
        mbs, remat, comp = CASES[arch]
        jc, _, p, _ = _setup(arch)
        cell = j_base.ShapeConfig("t", "train", S, B,
                                  microbatch_seqs_per_shard=mbs,
                                  remat_policy=remat)
        j_c = {None: None, "int8": j_comp.int8_compressor()}[comp]
        fn, info = j_steps.make_train_step(j_build(jc), _j_mesh(), cell,
                                           _ident(j_opt.Optimizer),
                                           compressor=j_c)
        state = {} if j_c is None else {"opt": {}, "residual": j_c.init(p)}
        g, o, m = jax.jit(fn)(p, state, {k: jnp.asarray(v) for k, v in
                                         _batch(jc).items()})
        _REF[arch] = (p, g, o.get("residual"), m, info)
    return _REF[arch]


def _cell(arch):
    mbs, remat, _ = CASES[arch]
    return t_base.ShapeConfig("t", "train", S, B,
                              microbatch_seqs_per_shard=mbs,
                              remat_policy=remat)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_train_step_equals_the_reference(mesh, arch):
    _, tc, _, tp = _setup(arch)
    _, jg, j_resid, jm, j_info = _reference(arch)
    t_c = {None: None, "int8": t_comp.int8_compressor()}[CASES[arch][2]]
    t_fn, t_info = t_steps.make_train_step(
        t_build(tc), mesh, _cell(arch), _ident(t_opt.Optimizer),
        compressor=t_c)
    assert (t_info["n_micro"], t_info["moe_groups"]) == \
        (j_info["n_micro"], j_info["moe_groups"])
    assert t_info["n_micro"] == B // CASES[arch][0]
    t_state = {} if t_c is None else {"opt": {},
                                      "residual": t_c.init(tp)}
    tg, t_o, tm = t_fn(place(tp, mesh), place(t_state, mesh), _batch(tc))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6)
    _close(tg, jg, **GRAD_TOL)
    if t_c is not None:
        _close(t_o["residual"], j_resid, **GRAD_TOL)
    # the step wrote none of its inputs
    for x, y in zip(t_opt.tree_leaves(tp), jax.tree.leaves(_setup(arch)[2])):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_remat_policies_give_the_same_gradients(mesh):
    """zamba2: "none", "full" and "dots" compute the same gradients (the
    recomputed forward repeats the same arithmetic)."""
    _, tc, _, tp = _setup("zamba2-1.2b")
    batch = _batch(tc)
    out = {}
    for remat in ("none", "full", "dots"):
        cell = t_base.ShapeConfig("t", "train", S, B, remat_policy=remat)
        _, info = t_steps.make_train_step(t_build(tc), mesh, cell)
        loss, g = info["grads"](place(tp, mesh), batch)
        out[remat] = (float(loss), {k: _whole(v) for k, v in
                                    _flat(g).items()})
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for k, v in out["none"][1].items():
            assert torch.equal(out[remat][1][k], v), (remat, k)


def test_adamw_step_equals_the_reference(mesh):
    """zamba2's case with AdamW: the port's step against the reference's
    AdamW on the reference's gradients of the same step."""
    lr = 1e-3
    _, tc, _, tp = _setup("zamba2-1.2b")
    p, jg, _, jm, _ = _reference("zamba2-1.2b")
    j_adam = j_opt.adamw(lr)
    jp2, _, j_om = jax.jit(j_adam.update)(jg, j_adam.init(p), p)
    t_adam = t_opt.adamw(lr)
    t_fn, _ = t_steps.make_train_step(t_build(tc), mesh,
                                      _cell("zamba2-1.2b"), t_adam)
    tp2, t_o2, tm = t_fn(place(tp, mesh), place(t_adam.init(tp), mesh),
                         _batch(tc))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(j_om["grad_norm"]),
                                                   rel=1e-5)
    assert int(t_o2["count"]) == 1
    g, w, grad = _flat(tp2), _flat(jax.tree.map(np.asarray, jp2)), \
        _flat(jax.tree.map(np.asarray, jg))
    moved = 0
    for k in w:
        got = _whole(g[k]).numpy()
        away = np.abs(grad[k]) > 1e-4
        np.testing.assert_allclose(got[away], w[k][away], atol=1e-7,
                                   err_msg=k)
        assert np.abs(got - w[k]).max() <= 2 * lr
        moved += int(away.sum())
    assert moved > 0.5 * sum(v.size for v in w.values()), moved


def test_prefill_and_decode_steps_run_the_model_on_this_ranks_rows(mesh):
    """``make_prefill_step`` / ``make_decode_step`` on a mesh of one rank:
    the model's ``prefill`` (with the cell's kv dtype and last-token head)
    and ``decode_step`` on the whole batch, from placed parameters and a
    host batch."""
    _, tc, _, tp = _setup("phi3.5-moe-42b-a6.6b")
    model = t_build(tc)
    cell = t_base.ShapeConfig("p", "prefill", S, B, kv_dtype="float32",
                              prefill_last_only=True)
    placed = place(tp, mesh)
    toks = _batch(tc)["tokens"]
    logits, cache = t_steps.make_prefill_step(model, mesh, cell)(
        placed, {"tokens": toks})
    with torch.no_grad():
        want, want_cache = model.prefill(
            tp, {"tokens": torch.from_numpy(toks)}, kv_dtype="float32",
            last_only=True)
    assert torch.equal(logits, want)
    for k in ("k", "v"):
        assert torch.equal(cache["kv"][k], want_cache["kv"][k])
    from repro_torch.launch.serve import grow_cache
    step = {"tokens": np.argmax(logits.numpy(), -1)[:, None]}
    got, _ = t_steps.make_decode_step(model, mesh, cell)(
        placed, grow_cache(cache, 1), step)
    with torch.no_grad():
        want, _ = model.decode(tp, grow_cache(want_cache, 1),
                               {"tokens": torch.from_numpy(step["tokens"])})
    assert torch.equal(got, want)
