"""Port parity (src/repro_torch vs src/repro) for the numpy copies
(configs, data/synthetic), core/transforms and models/cnn. Inputs come
from a numpy seed and go through both packages; weights cross from JAX
to torch with ``params_from_jax``.

Tolerances: pyramid levels and color representations are compared
bit-for-bit (dyadic k/256 pixels make every pooled sum exact in f32);
CNN probabilities within atol 1e-5 (f32 convolutions and dense products
summed in another order than XLA's); int8 ``q`` and ``scale`` bit-for-bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import tahoma_cnn as j_grid  # noqa: E402
from repro.configs.base import TahomaCNNConfig as JCfg  # noqa: E402
from repro.core import transforms as jt  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.configs import tahoma_cnn as t_grid  # noqa: E402
from repro_torch.configs.base import TahomaCNNConfig as TCfg  # noqa: E402
from repro_torch.core import transforms as tt  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402


def _dyadic(n, hw, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, hw, hw, 3)).astype(np.float32) / 256.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------ numpy copies ------------
def test_synthetic_generators_equal_reference():
    specs = jsyn.DEFAULT_PREDICATES[:3]
    assert [(s.name, s.channel, s.freq, s.amplitude) for s in specs] == \
        [(s.name, s.channel, s.freq, s.amplitude)
         for s in tsyn.DEFAULT_PREDICATES[:3]]
    for a, b in zip(jsyn.make_corpus(specs[1], 12, hw=16, seed=3),
                    tsyn.make_corpus(tsyn.DEFAULT_PREDICATES[1], 12, hw=16,
                                     seed=3)):
        assert np.array_equal(a, b)
    jx, jy = jsyn.make_multi_corpus(specs, 10, hw=16, seed=4,
                                    positive_rate=0.4)
    tx, ty = tsyn.make_multi_corpus(tsyn.DEFAULT_PREDICATES[:3], 10, hw=16,
                                    seed=4, positive_rate=0.4)
    assert np.array_equal(jx, tx) and np.array_equal(jy, ty)
    for a, b in zip(jsyn.three_way_split(jx, jy, seed=1),
                    tsyn.three_way_split(tx, ty, seed=1)):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("small", [True, False])
def test_model_grid_equals_reference(small):
    ja = j_grid.architecture_space(small)
    ta = t_grid.architecture_space(small)
    assert [a.arch_id for a in ja] == [a.arch_id for a in ta]
    assert j_grid.representation_space(small) == \
        t_grid.representation_space(small)
    assert JCfg().arch_id == TCfg().arch_id


# ------------------------------------------------ transforms --------------
@pytest.mark.parametrize("base,res", [(32, [16, 8, 4]), (64, [32, 8]),
                                      (32, [32, 16]), (224, [112, 56, 28])])
def test_pyramid_levels_bit_identical(base, res):
    img = _dyadic(2, base, seed=base)
    assert [(s.resolution, s.source) for s in jt.plan_pyramid(res, base)] \
        == [(s.resolution, s.source) for s in tt.plan_pyramid(res, base)]
    j = jt.materialize_pyramid(jnp.asarray(img), res)
    t = tt.materialize_pyramid(torch.from_numpy(img), res)
    assert sorted(j) == sorted(t)
    for r in j:
        assert np.array_equal(np.asarray(j[r]), t[r].numpy()), r
        # progressive == from base (the nesting property)
        assert np.array_equal(t[r].numpy(),
                              tt.resize_area(torch.from_numpy(img), r)
                              .numpy()), r


def test_representations_bit_identical():
    img = _dyadic(3, 32, seed=1)
    jreps = jt.representation_space([8, 16, 32])
    treps = tt.representation_space([8, 16, 32])
    j = jt.materialize_representations(jnp.asarray(img), jreps)
    t = tt.materialize_representations(torch.from_numpy(img), treps)
    for jr, tr in zip(jreps, treps):
        assert jr.name == tr.name and jr.values == tr.values
        assert np.array_equal(np.asarray(j[jr]), t[tr].numpy()), tr.name
        assert np.array_equal(
            np.asarray(jt.apply_transform(jnp.asarray(img), jr)),
            tt.apply_transform(torch.from_numpy(img), tr).numpy())


def test_plan_pyramid_rejects_non_nesting():
    with pytest.raises(ValueError):
        tt.plan_pyramid([120], 224)


def test_transform_cost_and_bytes_moved_equal():
    for res in (8, 16, 32):
        for color in jt.COLOR_REPS:
            jr, tr = jt.Representation(res, color), \
                tt.Representation(res, color)
            for src in (None, 32, 64):
                assert jt.transform_cost(jr, 64, src) == \
                    tt.transform_cost(tr, 64, src)
    for base in (32, 64):
        assert jt.pyramid_bytes_moved(jt.representation_space([8, 16, 32]),
                                      base) == \
            tt.pyramid_bytes_moved(tt.representation_space([8, 16, 32]),
                                   base)


# ------------------------------------------------ cnn ---------------------
CNN_CASES = [  # (layers, conv, dense, hw, channels): 14 -> 7 -> 3 is odd
    (1, 4, 8, 16, 1), (2, 8, 16, 16, 3), (2, 4, 8, 14, 1), (3, 4, 8, 12, 3),
]


@pytest.mark.parametrize("layers,conv,dense,hw,ch", CNN_CASES)
def test_cnn_scores_on_reference_weights(layers, conv, dense, hw, ch):
    jcfg = JCfg(layers, conv, dense, input_hw=hw, input_channels=ch)
    tcfg = TCfg(layers, conv, dense, input_hw=hw, input_channels=ch)
    jp = jcnn.init_cnn(jax.random.PRNGKey(hw + layers), jcfg)
    tp = tcnn.init_cnn(torch.Generator().manual_seed(0), tcfg, device="cpu")
    # shape parity of the torch initializer
    assert jax.tree.map(lambda x: tuple(x.shape), jp) == \
        jax.tree.map(lambda x: tuple(x.shape), tp)
    assert jcnn.cnn_flops(jcfg) == tcnn.cnn_flops(tcfg)
    x = np.random.default_rng(layers).random((5, hw, hw, ch),
                                             dtype=np.float32)
    want = np.asarray(jax.jit(jcnn.cnn_predict_proba)(jp, jnp.asarray(x)))
    got = tcnn.cnn_predict_proba(tcnn.params_from_jax(_np(jp), "cpu"),
                                 torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("layers,conv,dense,hw,ch", CNN_CASES[:2])
def test_quantize_cnn_bit_identical(layers, conv, dense, hw, ch):
    jp = jcnn.init_cnn(jax.random.PRNGKey(7),
                       JCfg(layers, conv, dense, input_hw=hw,
                            input_channels=ch))
    jq = _np(jcnn.quantize_cnn(jp))
    tq = tcnn.quantize_cnn(tcnn.params_from_jax(_np(jp), "cpu"))
    for a, b in zip(jax.tree.leaves(jq), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), tq))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # carried-over qparams dequantize to the reference's f32 weights
    jd = _np(jcnn.dequantize_cnn(jcnn.quantize_cnn(jp)))
    td = tcnn.dequantize_cnn(tcnn.params_from_jax(jq, "cpu"))
    for a, b in zip(jax.tree.leaves(jd), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), td))):
        assert np.array_equal(a, b)
