"""The port's kernel entry points (repro_torch.kernels.ops) on CPU tensors
(their plain versions) vs the reference's ops (repro.kernels.ops) with its
Pallas kernels in interpret mode, on the same numpy inputs. The CUDA
kernels themselves are held against these same plain versions on the card
by chip_smoke.py.

Tolerances: transform_op 1e-5 (tests/test_kernels.py::test_image_transform);
pyramid_transform_op on dyadic (uint8-derived) pixels equal for rgb/r/g/b
(exact sums, x1/x0 projections) and within 1e-6 for gray (three products
summed in another order); matmul, flash attention and the SSD scan at
tests/test_kernels.py's tolerances. Also the host side of
fused_pyramid_transform's CUDA kernels (the tile plan, the strip plan and
its work items) and, emulated in torch, the strip kernel's arithmetic
against the Pallas kernel at the same tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as j_ops  # noqa: E402
from repro_torch.core.transforms import plan_pyramid  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.image_transform import (  # noqa: E402
    SMEM_MAX, STRIP_MAX_RING, STRIP_ROWS, STRIP_STATIC_SMEM,
    fused_pyramid_transform, fused_transform, output_kind, strip_grid,
    strip_plan, strip_work, transform_tiling)

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


# ---- the strip kernel's plan (csrc/image_transform.cu,
# fused_pyramid_strip_kernel), chosen on the host

@pytest.mark.parametrize("h,resolutions,aligned,chain", [
    (224, (112, 56, 28), True, 7),      # the query path's chains
    (224, (112, 28), True, 5),
    (240, (120, 80, 40), True, None),   # a tree: 80 and 120 from the base
    (224, (112, 32), True, None),       # 32 straight from 224: factor 7
    (84, (42, 21), True, None),         # a chain, base no multiple of 16
    (224, (112, 56, 28), False, None),  # frames off 16-byte alignment
])
def test_strip_plan_picks_the_register_path_for_chains(h, resolutions,
                                                       aligned, chain):
    plan = strip_plan(h, plan_pyramid(resolutions, h), aligned)
    assert (plan.chain if plan else None) == chain


@pytest.mark.parametrize("levels", [
    (112,), (56,), (28,), (112, 56), (112, 28), (56, 28), (112, 56, 28)])
def test_strip_plan_fits_shared_memory(levels):
    h = 224
    steps = plan_pyramid(levels, h)
    plan = strip_plan(h, steps)
    assert plan.ring == STRIP_MAX_RING and plan.tile_row == 3 * h + 4
    assert plan.lv_stride == sum(
        STRIP_ROWS // (h // r) * r * 3 for r in levels)
    assert plan.smem == 4 * (plan.ring * STRIP_ROWS * plan.tile_row
                             + 2 * plan.lv_stride)
    assert plan.smem + STRIP_STATIC_SMEM <= SMEM_MAX
    assert plan.tile_row % 4 == 0 and plan.lv_stride % 4 == 0


@pytest.mark.parametrize("b", [1, 7, 256, 257])
def test_strip_work_covers_every_strip_once(b):
    h, sms = 224, 132
    grid = strip_grid(b, h, sms)
    assert grid == min(b * h // STRIP_ROWS, sms)
    work = strip_work(b, h, grid)
    items = [w for block in work for w in block]
    assert sorted(items) == [(i, y) for i in range(b)
                             for y in range(0, h, STRIP_ROWS)]
    sizes = [len(block) for block in work]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def test_output_kinds_name_copies_and_selects():
    assert [output_kind(ops.COLOR_WEIGHTS[c]) for c in COLORS] \
        == [1, 2, 3, 4, 0]
    assert output_kind(np.eye(3, dtype=np.float32)[:, ::-1].copy()) == 0
    assert output_kind(np.full((3, 1), 1 / 3, np.float32)) == 0


def _strip_arithmetic(img, specs, mean=0.5, std=0.25):
    """The strip kernel's arithmetic in torch f32: each level of the chain
    from the one before, each window's sum with one rounded add a value in
    the kernel's order (rows, then pixels), times 1 / f^2; then per output
    kind a copy, a select, or three products and two adds in the kernel's
    order; then (x - mean) * (1 / std)."""
    b, h = img.shape[0], img.shape[1]
    levels = {h: img}
    for st in plan_pyramid([r for r, _ in specs], h):
        r, f = st.resolution, st.source // st.resolution
        x = levels[st.source].reshape(b, r, f, r, f, 3)
        acc = torch.zeros(b, r, r, 3)
        for fy in range(f):
            for fx in range(f):
                acc = acc + x[:, :, fy, :, fx, :]
        levels[r] = acc * (1.0 / (f * f))
    outs = []
    for r, color in specs:
        x, cw = levels[r], ops.COLOR_WEIGHTS[color]
        kind = output_kind(cw)
        if kind == 1:
            y = x
        elif kind >= 2:
            y = x[..., kind - 2:kind - 1]
        else:
            w = [float(v) for v in cw[:, 0]]
            y = ((x[..., 0] * w[0] + x[..., 1] * w[1])
                 + x[..., 2] * w[2])[..., None]
        outs.append((y - mean) * (1.0 / std))
    return outs


def test_strip_arithmetic_matches_pallas():
    """The strip kernel's pooling and projection, emulated, against the
    reference's Pallas kernel (interpret mode) on 4 dyadic 32 px frames
    with levels {16, 8, 4}: rgb/r/g/b bit for bit, gray within 1e-6."""
    img = _uint8_images(4, 32, seed=17)
    specs = tuple((r, c) for r in (32, 16, 8, 4) for c in COLORS)
    assert strip_plan(32, plan_pyramid([r for r, _ in specs], 32)).chain == 7
    want = j_ops.pyramid_transform_op(jnp.asarray(img), specs=specs)
    got = _strip_arithmetic(torch.from_numpy(img), specs)
    for g, w, (res, color) in zip(got, want, specs):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if color == "gray":
            np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0)
        else:
            assert np.array_equal(g.numpy(), w), (res, color)
