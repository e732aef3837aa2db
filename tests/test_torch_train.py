"""Training in the port (train/optimizer, models/cnn.bce_loss,
core/pipeline.fit_cnn/train_cnn) against the JAX reference on the CPU,
from the reference's initial weights (``params_from_jax``).

Tolerances: ``bce_loss`` within 1e-6 and each gradient leaf within atol
1e-6 + rtol 1e-5 of ``jax.value_and_grad(bce_loss)``; AdamW fed the same
gradients for 20 steps keeps params, m and v within atol 1e-6 of the
reference's (a few f32 ulps at the weights' scale); SGD and the cosine
schedule within 1e-6.

``fit_cnn`` is held against the reference's ``train_cnn`` loop (same
initial weights, same ``np.random.default_rng(seed)`` index stream,
batch 16, lr 3e-3) parameter for parameter after 1 step (1e-6, where
the step's gradient is not in AdamW's eps regime: see that test) and
10 steps (1e-4) only. f32 training trajectories part after a few tens of
steps: both packages' loops run the same arithmetic in another order
(XLA's convolutions and reductions against PyTorch's), and each step
feeds the last one's rounding into the next. Measured on the CPU with
the same loop in both packages:

    model                         steps  max |d param|  max |d score|
    cnn_l1_c8_d16, 16 px gray         1        6.0e-8         9.7e-8
                                     10        6.0e-8         2.1e-7
                                     40        8.2e-5         2.0e-5
                                    150        1.3e-4         5.7e-3
    cnn_l2_c16_d16, 32 px rgb         1        1.9e-7         1.2e-7
                                     10        3.4e-5         8.6e-6
                                     40        3.3e-2         0.21
                                    150        0.18           0.81

At 150 steps the two runs' eval accuracies were 0.865 vs 0.875 and 1.0
vs 0.965: the same learning, another trajectory. So whole-training
parity is behavioural (tests/test_torch_system.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import TahomaCNNConfig as JCfg  # noqa: E402
from repro.core.pipeline import train_cnn as jtrain_cnn  # noqa: E402
from repro.models.cnn import bce_loss as jbce_loss  # noqa: E402
from repro.models.cnn import init_cnn as jinit_cnn  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs.base import TahomaCNNConfig  # noqa: E402
from repro_torch.core.pipeline import fit_cnn, train_cnn  # noqa: E402
from repro_torch.data.synthetic import (DEFAULT_PREDICATES,  # noqa: E402
                                        make_corpus)
from repro_torch.models.cnn import bce_loss, params_from_jax  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

MODELS = {"l1_16_gray": ((1, 8, 16), 16, 1),
          "l2_32_rgb": ((2, 16, 16), 32, 3),
          "l3_28_rgb": ((3, 8, 16), 28, 3)}    # 28 -> 14 -> 7 -> 3


def _jax_model(key, seed=0):
    (layers, conv, dense), hw, ch = MODELS[key]
    cfg = JCfg(layers, conv, dense, input_hw=hw, input_channels=ch)
    return cfg, jinit_cnn(jax.random.PRNGKey(seed), cfg)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _images(hw, ch, n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, hw, hw, ch)).astype(np.float32),
            rng.integers(0, 2, n).astype(np.float32))


def _close_leaves(got, want, atol, rtol=0.0):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=atol, rtol=rtol)


@pytest.mark.parametrize("key", sorted(MODELS))
def test_bce_loss_and_gradients_match_the_reference(key):
    cfg, jp = _jax_model(key)
    x, y = _images(cfg.input_hw, cfg.input_channels)
    jloss, jgrads = jax.jit(jax.value_and_grad(jbce_loss))(
        jp, jnp.asarray(x), jnp.asarray(y))
    tp = params_from_jax(_np_tree(jp), "cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    loss = bce_loss(tp, torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jloss)) <= 1e-6
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-5)


def _grad_stream(params_np, steps, scale, seed=1):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale
                                    ).astype(np.float32), params_np)
            for _ in range(steps)]


@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_adamw_matches_the_reference_on_the_same_gradients(clip):
    """20 steps, weight decay on; 'active' gradients have a global norm
    far above 1 (clipped every step), 'inactive' ones far below."""
    _, jp = _jax_model("l2_32_rgb")
    p_np = _np_tree(jp)
    grads = _grad_stream(p_np, 20, 1.0 if clip == "active" else 1e-4)
    j = jopt.adamw(3e-3, weight_decay=0.1)
    t = topt.adamw(3e-3, weight_decay=0.1)
    js, ts = j.init(jp), t.init(params_from_jax(p_np, "cpu"))
    jparams, tparams = jp, params_from_jax(p_np, "cpu")
    j_update = jax.jit(j.update)
    for g in grads:
        jparams, js, jinfo = j_update(jax.tree.map(jnp.asarray, g), js,
                                      jparams)
        tparams, ts, tinfo = t.update(params_from_jax(g, "cpu"), ts, tparams)
        assert abs(float(tinfo["grad_norm"]) - float(jinfo["grad_norm"])) \
            <= 1e-5 * float(jinfo["grad_norm"])
    assert (float(jinfo["grad_norm"]) > 1.0) == (clip == "active")
    assert int(ts["count"]) == int(js["count"]) == 20
    _close_leaves(tparams, jparams, 1e-6)
    _close_leaves(ts["m"], js["m"], 1e-6)
    _close_leaves(ts["v"], js["v"], 1e-6)


def test_sgd_and_cosine_schedule_match_the_reference():
    _, jp = _jax_model("l1_16_gray")
    p_np = _np_tree(jp)
    sched = (1e-2, 3, 12)
    j = jopt.sgd(jopt.cosine_schedule(*sched), momentum=0.9)
    t = topt.sgd(topt.cosine_schedule(*sched), momentum=0.9)
    js, ts = j.init(jp), t.init(params_from_jax(p_np, "cpu"))
    jparams, tparams = jp, params_from_jax(p_np, "cpu")
    for g in _grad_stream(p_np, 15, 0.5):
        jparams, js, _ = j.update(jax.tree.map(jnp.asarray, g), js, jparams)
        tparams, ts, _ = t.update(params_from_jax(g, "cpu"), ts, tparams)
    _close_leaves(tparams, jparams, 1e-6)
    _close_leaves(ts["mu"], js["mu"], 1e-6)
    jfn, tfn = jopt.cosine_schedule(2.0, 10, 100, 0.2), \
        topt.cosine_schedule(2.0, 10, 100, 0.2)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert abs(float(tfn(torch.tensor(step, dtype=torch.int32)))
                   - float(jfn(jnp.int32(step)))) <= 1e-6
        assert float(tfn(step)) == float(tfn(torch.tensor(step)))


# ----------------------------------- tests/test_substrate.py mirror ------
@pytest.mark.parametrize("make", [lambda: topt.adamw(0.1),
                                  lambda: topt.sgd(0.05, momentum=0.9)])
def test_optimizer_converges_quadratic(make):
    opt = make()
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_cosine_schedule():
    fn = topt.cosine_schedule(1.0, warmup=10, total=100, floor_frac=0.1)
    assert float(fn(torch.tensor(5, dtype=torch.int32))) == \
        pytest.approx(0.5)
    assert float(fn(torch.tensor(10, dtype=torch.int32))) == \
        pytest.approx(1.0, abs=0.02)
    assert float(fn(torch.tensor(100, dtype=torch.int32))) == \
        pytest.approx(0.1, abs=0.02)


# ------------------------------------------------- the training loop -----
def _fit_both(key, steps):
    cfg, jp = _jax_model(key, seed=3)
    x, y = make_corpus(DEFAULT_PREDICATES[1], 64, hw=cfg.input_hw, seed=0)
    if cfg.input_channels == 1:
        x = x[..., 1:2]       # the green channel, where ferret's signal is
    want = jtrain_cnn(cfg, x, y, steps=steps, seed=3)
    got = fit_cnn(params_from_jax(_np_tree(jp), "cpu"), x, y, steps=steps,
                  seed=3, device="cpu")
    for p in tree_leaves(got):
        assert not p.requires_grad and p.is_contiguous() \
            and p.dtype == torch.float32
    return cfg, jp, x, y, got, want


@pytest.mark.parametrize("key", ["l1_16_gray", "l2_32_rgb"])
def test_fit_cnn_matches_the_reference_train_cnn_after_one_step(key):
    """Within 1e-6 wherever the step's gradient exceeds 1e-6 in size.
    Below that, AdamW's first step g / (|g| + eps), eps = 1e-8, is no
    longer +-lr: it passes the gradient's relative rounding difference
    between the packages' convolutions on at lr's scale (a gradient of
    9.19e-10 in JAX and 9.27e-10 in PyTorch moves a dense weight of
    cnn_l2_c16_d16 by 2.8e-6 more). Those weights are held within 1% of
    lr (3e-5), still 100x below a wrong batch, lr or decay."""
    cfg, jp, x, y, got, want = _fit_both(key, 1)
    idx = np.random.default_rng(3).integers(0, len(x), size=16)
    _, g = jax.value_and_grad(jbce_loss)(jp, jnp.asarray(x[idx]),
                                         jnp.asarray(y[idx], jnp.float32))
    for t, w, gl in zip(tree_leaves(got), jax.tree.leaves(want),
                        jax.tree.leaves(g)):
        d = np.abs(t.numpy() - np.asarray(w))
        tiny = np.abs(np.asarray(gl)) <= 1e-6
        assert d[~tiny].max(initial=0.0) <= 1e-6
        assert d[tiny].max(initial=0.0) <= 3e-5


@pytest.mark.parametrize("key", ["l1_16_gray", "l2_32_rgb"])
def test_fit_cnn_matches_the_reference_train_cnn_after_ten_steps(key):
    *_, got, want = _fit_both(key, 10)
    _close_leaves(got, want, 1e-4)


def test_fit_cnn_leaves_its_initial_weights_alone():
    _, jp = _jax_model("l1_16_gray")
    init = params_from_jax(_np_tree(jp), "cpu")
    before = [p.clone() for p in tree_leaves(init)]
    x, y = _images(16, 1, n=32)
    fit_cnn(init, x, y, steps=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(init), before))
    assert not any(p.requires_grad for p in tree_leaves(init))


def test_train_cnn_is_deterministic_on_the_cpu():
    cfg = TahomaCNNConfig(2, 8, 16, input_hw=16, input_channels=3)
    x, y = make_corpus(DEFAULT_PREDICATES[0], 48, hw=16, seed=2)
    a = train_cnn(cfg, x, y, steps=12, seed=5, device="cpu")
    b = train_cnn(cfg, x, y, steps=12, seed=5, device="cpu")
    c = train_cnn(cfg, x, y, steps=12, seed=6, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert not all(torch.equal(p, q) for p, q in zip(tree_leaves(a),
                                                     tree_leaves(c)))
