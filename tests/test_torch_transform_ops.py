"""The port's kernel entry points (repro_torch.kernels.ops) on CPU tensors
(their plain versions) vs the reference's ops (repro.kernels.ops) with its
Pallas kernels in interpret mode, on the same numpy inputs. The CUDA
kernels themselves are held against these same plain versions on the card
by chip_smoke.py.

Tolerances: transform_op 1e-5 (tests/test_kernels.py::test_image_transform);
pyramid_transform_op on dyadic (uint8-derived) pixels equal for rgb/r/g/b
(exact sums, x1/x0 projections) and within 1e-6 for gray (three products
summed in another order); matmul, flash attention and the SSD scan at
tests/test_kernels.py's tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as j_ops  # noqa: E402
from repro_torch.core.transforms import plan_pyramid  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.image_transform import (  # noqa: E402
    SMEM_MAX, fused_pyramid_transform, fused_transform,
    transform_tiling)

COLORS = ["rgb", "r", "g", "b", "gray"]


@pytest.fixture(autouse=True)
def _no_launches():
    """Every op here runs on CPU tensors: no kernel is ever launched."""
    ops.reset_launch_counts()
    yield
    assert all(n == 0 for n in ops.LAUNCHES.values()), ops.LAUNCHES


def _uint8_images(b, hw, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, hw, hw, 3)).astype(np.float32) / 256.0


def test_color_weights_equal_reference():
    assert ops.COLOR_WEIGHTS.keys() == j_ops.COLOR_WEIGHTS.keys()
    for color, w in j_ops.COLOR_WEIGHTS.items():
        assert ops.COLOR_WEIGHTS[color].dtype == w.dtype
        assert np.array_equal(ops.COLOR_WEIGHTS[color], w), color


@pytest.mark.parametrize("res", [8, 16, 32])
@pytest.mark.parametrize("color", COLORS)
def test_transform_op_matches_pallas(res, color):
    img = np.random.default_rng(res).random((3, 32, 32, 3), np.float32)
    want = np.asarray(j_ops.transform_op(jnp.asarray(img), res=res,
                                         color=color))
    got = ops.transform_op(torch.from_numpy(img), res=res, color=color)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (3, res, res, 3 if color == "rgb" else 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_pyramid_transform_op_matches_pallas():
    img = _uint8_images(3, 32, seed=2)
    specs = ((16, "rgb"), (16, "gray"), (8, "r"), (4, "gray"), (32, "rgb"))
    want = j_ops.pyramid_transform_op(jnp.asarray(img), specs=specs)
    got = ops.pyramid_transform_op(torch.from_numpy(img), specs=specs)
    assert len(got) == len(want) == len(specs)
    for g, w, (res, color) in zip(got, want, specs):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if color == "gray":
            np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0)
        else:
            assert np.array_equal(g.numpy(), w), (res, color)


def test_matmul_op_matches_pallas():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((33, 17)).astype(np.float32)
    b = rng.standard_normal((17, 65)).astype(np.float32)
    want = np.asarray(j_ops.matmul_op(a, b))
    got = ops.matmul_op(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)


def test_flash_attention_op_matches_pallas():
    rng = np.random.default_rng(6)
    q, k, v = ((rng.standard_normal((1, 2, 64, 32)) * 0.5).astype(np.float32)
               for _ in range(3))
    want = np.asarray(j_ops.flash_attention_op(q, k, v, causal=True))
    got = ops.flash_attention_op(*map(torch.from_numpy, (q, k, v)),
                                 causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)


def test_ssd_scan_op_returns_y_and_matches_pallas():
    b, s, h, p, n = 1, 64, 2, 8, 16
    rng = np.random.default_rng(7)
    args = ((rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32),
            (rng.random((b, s, h)) * 0.1).astype(np.float32),
            (-rng.random(h) * 2).astype(np.float32),
            (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32))
    want = np.asarray(j_ops.ssd_scan_op(*args, chunk=16))
    got = ops.ssd_scan_op(*map(torch.from_numpy, args), chunk=16)
    assert torch.is_tensor(got) and tuple(got.shape) == (b, s, h, p)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-3)


def test_transforms_refuse_what_the_reference_asserts():
    img = torch.zeros(2, 32, 32, 3)
    gray = ops.COLOR_WEIGHTS["gray"]
    with pytest.raises(ValueError):                  # 32 % 12 != 0
        ops.transform_op(img, res=12)
    with pytest.raises(ValueError):
        fused_transform(img, gray, 64)
    with pytest.raises(ValueError):                  # 12 nests under nothing
        ops.pyramid_transform_op(img, specs=((16, "rgb"), (12, "gray")))
    with pytest.raises(ValueError):
        fused_pyramid_transform(img, [(0, gray)])
    with pytest.raises(ValueError):                  # not square
        ops.transform_op(torch.zeros(2, 32, 16, 3), res=8)
    with pytest.raises(ValueError):
        ops.pyramid_transform_op(torch.zeros(2, 32, 32, 4), specs=((8, "r"),))


@pytest.mark.parametrize("h,resolutions,tile", [
    (224, (28, 56, 112, 224), (8, 224)),     # the query path: 8-row strips
    (224, (56,), (8, 224)),
    (224, (224,), (8, 224)),
    (32, (4, 8, 16, 32), (32, 32)),          # a whole small frame
    (48, (16, 12), (24, 48)),                # factors 3 and 4: lcm 12
    (1024, (8,), (128, 128)),                # a strip would not fit
])
def test_transform_tiling(h, resolutions, tile):
    steps = plan_pyramid(resolutions, h)
    tile_h, tile_w, offsets, smem = transform_tiling(h, steps)
    assert (tile_h, tile_w) == tile
    assert h % tile_h == 0 and h % tile_w == 0
    for r in resolutions:             # every level's tile is whole pixels
        assert tile_h % (h // r) == 0 and tile_w % (h // r) == 0
    sizes = [tile_h * tile_w * 3] + [
        (tile_h * st.resolution // h) * (tile_w * st.resolution // h) * 3
        for st in steps]
    assert offsets == list(np.cumsum(sizes)[:-1])
    assert smem == 4 * sum(sizes) <= SMEM_MAX


def test_transform_tiling_refuses_what_one_block_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        transform_tiling(2048, plan_pyramid([8], 2048))
