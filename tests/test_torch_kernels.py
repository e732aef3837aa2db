"""The port's kernel wrappers on CPU tensors (their plain versions) vs the
reference's Pallas kernels run in interpret mode, as tests/test_kernels.py
and tests/test_fused_hotpath.py run them. The CUDA kernels themselves are
held against these same plain versions on the card by chip_smoke.py.

Tolerances: pyramid levels bit-for-bit (dyadic pixels); f32 and int8
stage-0 scores within atol 1e-5 (f32 sums in another order); matmul at
tests/test_kernels.py::test_matmul's tolerances (1e-3 f32, 3e-2 bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import TahomaCNNConfig  # noqa: E402
from repro.core.transforms import Representation as JRep  # noqa: E402
from repro.kernels import image_transform as j_it  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.models.cnn import init_cnn, quantize_cnn  # noqa: E402
from repro_torch.core.transforms import Representation  # noqa: E402
from repro_torch.kernels import image_transform as t_it  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels.matmul import matmul  # noqa: E402
from repro_torch.models.cnn import params_from_jax  # noqa: E402

RNG = np.random.default_rng(0)


def _dyadic(n, hw, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, hw, hw, 3)).astype(np.float32) / 256.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("color", ["rgb", "r", "g", "b", "gray"])
def test_color_weight_matrix_equals_reference(color):
    assert np.array_equal(j_it.color_weight_matrix(color),
                          t_it.color_weight_matrix(color))


STAGE0_CASES = [  # (seed, base, stage-0 res divisor, color, conv layers)
    (0, 16, 4, "gray", 2), (1, 32, 4, "gray", 2), (2, 32, 2, "rgb", 1),
    (3, 32, 1, "b", 2),
]


@pytest.mark.parametrize("seed,base,div,color,n_conv", STAGE0_CASES)
def test_fused_pyramid_stage0_matches_reference_kernel(seed, base, div,
                                                       color, n_conv):
    res = base // div
    cfg = TahomaCNNConfig(n_conv_layers=n_conv, conv_nodes=4, dense_nodes=8,
                          input_hw=res,
                          input_channels=3 if color == "rgb" else 1)
    jp = init_cnn(jax.random.PRNGKey(seed), cfg)
    jq = quantize_cnn(jp)
    imgs = _dyadic(3, base, seed)
    out_res = [base // 2, base // 4]
    tp, tq = params_from_jax(_np(jp), "cpu"), params_from_jax(_np(jq), "cpu")
    trep = Representation(res, color)
    for jqp, tqp in ((None, None), (jq, tq)):
        j_lv, j_s = j_it.fused_pyramid_stage0(
            jnp.asarray(imgs), out_res, jp, JRep(res, color), qparams=jqp,
            interpret=True)
        r_lv, r_s = j_ref.fused_pyramid_stage0_ref(
            jnp.asarray(imgs), out_res, jp, JRep(res, color), qparams=jqp)
        t_lv, t_s = t_it.fused_pyramid_stage0(
            torch.from_numpy(imgs), out_res, tp, trep, qparams=tqp)
        for r in out_res:
            assert np.array_equal(t_lv[r].numpy(), np.asarray(j_lv[r])), r
            assert np.array_equal(t_lv[r].numpy(), np.asarray(r_lv[r])), r
        np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(t_s.numpy(), np.asarray(r_s), atol=1e-5,
                                   rtol=0)
        # the CPU wrapper IS the plain version
        p_lv, p_s = t_ref.fused_pyramid_stage0_ref(
            torch.from_numpy(imgs), out_res, tp, trep, qparams=tqp)
        assert torch.equal(p_s, t_s)


@pytest.mark.parametrize("shape", [(64, 96, 32), (128, 128, 128),
                                   (33, 17, 65), (256, 64, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_reference_kernel(shape, dtype):
    m, k, n = shape
    jdt = np.float32 if dtype == "float32" else jnp.bfloat16
    a = RNG.standard_normal((m, k)).astype(jdt)
    b = RNG.standard_normal((k, n)).astype(jdt)
    want = np.asarray(j_ops.matmul_op(a, b), np.float32)
    tdt = getattr(torch, dtype)
    ta = torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
    tb = torch.from_numpy(np.asarray(b, np.float32)).to(tdt)
    got = matmul(ta, tb)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    tol = 1e-3 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=tol)
    # out_dtype is honoured
    assert matmul(ta, tb, out_dtype=torch.float32).dtype == torch.float32


def test_matmul_exact_on_indicator_matrices():
    """The evaluator's operands are 0/1 indicators: the products are
    integer counts, exact in f32."""
    a = (RNG.random((128, 40)) < 0.5).astype(np.float32)
    b = (RNG.random((40, 75)) < 0.5).astype(np.float32)
    got = matmul(torch.from_numpy(a), torch.from_numpy(b),
                 out_dtype=torch.float32).numpy()
    assert np.array_equal(got, a @ b)


# ---- the card's tiling of csrc/matmul.cu, chosen on the host
from repro_torch.kernels import bindings  # noqa: E402

EVALUATOR_SHAPES = [(128, 512, 1805), (128, 512, 361)]   # (M, K, N)


@pytest.mark.parametrize("m,k,n", EVALUATOR_SHAPES + [(13, 512, 1805)])
def test_matmul_plan_fills_the_card_at_the_evaluator_shapes(m, k, n):
    bm, bn, split, k_chunk = bindings.matmul_plan(m, n, k)
    blocks = -(-m // bm) * -(-n // bn) * split
    assert blocks >= bindings.SMS, (bm, bn, split, blocks)


@pytest.mark.parametrize("m,k,n", EVALUATOR_SHAPES + [
    (33, 17, 65), (64, 96, 32), (128, 128, 128), (256, 64, 130),
    (1, 1, 1), (3, 0, 5), (13, 512, 361), (700, 300, 900)])
def test_matmul_plan_covers_every_output_and_every_k(m, k, n):
    bm, bn, split, k_chunk = bindings.matmul_plan(m, n, k)
    assert (bm, bn) in bindings.MM_TILES
    assert k_chunk % bindings.MM_BK == 0 and split >= 1
    # the chunks cover K, and none is empty (each adds a partial sum)
    assert split * k_chunk >= k and (split == 1 or (split - 1) * k_chunk < k)
    assert -(-m // bm) * bm >= m and -(-n // bn) * bn >= n


@pytest.mark.parametrize("m,k,n", EVALUATOR_SHAPES)
def test_matmul_split_k_chunks_partition_k_exactly(m, k, n):
    """The plan's K chunks, one partial product each, added in chunk order
    z = 0, 1, ... as the kernel's second pass adds them, give the exact
    counts of the evaluator's 0/1 operands: every k lies in exactly one
    chunk. (That the card adds them in the same order on every run is
    chip_smoke.py's "rerun bit-identical" check.)"""
    rng = np.random.default_rng(m + n)
    a = (rng.random((m, k)) < 0.5).astype(np.float32)
    b = (rng.random((k, n)) < 0.5).astype(np.float32)
    _, _, split, k_chunk = bindings.matmul_plan(m, n, k)
    assert split > 1                # both evaluator shapes split K
    chunks = [range(k)[z * k_chunk:(z + 1) * k_chunk] for z in range(split)]
    assert sorted(i for c in chunks for i in c) == list(range(k))
    got = np.zeros((m, n), np.float32)
    for c in chunks:
        got += a[:, c.start:c.stop] @ b[c.start:c.stop]
    assert np.array_equal(got, a @ b)
    assert np.array_equal(matmul(torch.from_numpy(a), torch.from_numpy(b),
                                 out_dtype=torch.float32).numpy(), got)


@pytest.mark.parametrize("m,k,n", EVALUATOR_SHAPES)
def test_matmul_matches_reference_kernel_on_evaluator_indicators(m, k, n):
    """The evaluator's products, (128, 512) @ (512, A or M) on 0/1
    indicators: the CPU wrapper equals the Pallas kernel in interpret mode
    exactly."""
    rng = np.random.default_rng(n)
    a = (rng.random((m, k)) < 0.5).astype(np.float32)
    b = (rng.random((k, n)) < 0.5).astype(np.float32)
    want = np.asarray(j_ops.matmul_op(a, b))
    got = matmul(torch.from_numpy(a), torch.from_numpy(b),
                 out_dtype=torch.float32)
    assert np.array_equal(got.numpy(), want)
