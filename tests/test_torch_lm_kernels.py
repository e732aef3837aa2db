"""The port's LM kernel wrappers on CPU tensors (their plain versions) vs
the reference's Pallas kernels run in interpret mode, at the shapes
tests/test_kernels.py uses. The CUDA kernels themselves are held against
these same plain versions on the card by chip_smoke.py.

Tolerances are the reference tests': flash attention 2e-3 in f32 and
3e-2 in bf16 (atol and rtol); the SSD scan 5e-4 atol / 5e-3 rtol, for y
and for the final state (f32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as j_ops  # noqa: E402
from repro.models.ssm import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402

SSD_TOL = dict(atol=5e-4, rtol=5e-3)


def _t(x):
    """numpy (f32 or ml_dtypes bf16) -> torch on the CPU, same values."""
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bhsd", [(1, 2, 64, 32), (2, 3, 128, 64),
                                  (1, 1, 256, 16)])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_flash_attention_matches_pallas(causal, bhsd, dtype):
    rng = np.random.default_rng(sum(bhsd) + causal)
    q, k, v = ((rng.standard_normal(bhsd) * 0.5).astype(dtype)
               for _ in range(3))
    want = np.asarray(j_ops.flash_attention_op(q, k, v, causal=causal),
                      np.float32)
    ops.reset_launch_counts()
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert ops.LAUNCHES["flash_attention"] == 0     # CPU: the plain version
    assert got.dtype == _t(q).dtype and tuple(got.shape) == bhsd
    tol = 2e-3 if dtype == np.float32 else 3e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def _ssd_inputs(shp, seed):
    b, s, h, p, n = shp
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32),
            (rng.random((b, s, h)) * 0.1).astype(np.float32),
            (-rng.random(h) * 2).astype(np.float32),
            (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32))


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("shp", [(1, 64, 2, 8, 16), (2, 128, 3, 16, 32)])
def test_ssd_scan_matches_pallas_and_model_state(chunk, shp):
    args = _ssd_inputs(shp, chunk + shp[1])
    y_pallas = np.asarray(j_ops.ssd_scan_op(*args, chunk=chunk))
    _, j_final = j_ssd_chunked(*(jnp.asarray(a) for a in args), chunk)
    y, final = ssd_scan(*(_t(a) for a in args), chunk=chunk)
    assert y.dtype == final.dtype == torch.float32
    b, s, h, p, n = shp
    assert tuple(final.shape) == (b, h, p, n)
    np.testing.assert_allclose(y.numpy(), y_pallas, **SSD_TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(j_final), **SSD_TOL)


def test_ssd_scan_chunk_invariance_and_refusals():
    """The chunk length only moves f32 rounding (the kernel runs its own);
    a sequence that is no multiple of the chunk is refused, as the
    reference's ssd_chunked refuses it."""
    args = [_t(a) for a in _ssd_inputs((1, 128, 2, 8, 16), 7)]
    y1, f1 = ssd_scan(*args, chunk=16)
    y2, f2 = ssd_scan(*args, chunk=128)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), **SSD_TOL)
    np.testing.assert_allclose(f1.numpy(), f2.numpy(), **SSD_TOL)
    with pytest.raises(ValueError, match="multiple"):
        ssd_scan(*(t[:, :100] if t.dim() > 1 else t for t in args),
                 chunk=64)


# ---- strided operands: the (B,S,H,D).transpose(1, 2) views the model passes
from repro_torch.kernels import bindings  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_operand  # noqa: E402


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bhsd", [(1, 2, 64, 32), (2, 3, 128, 64),
                                  (1, 1, 256, 16)])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_flash_attention_on_transposed_views_matches_pallas(causal, bhsd,
                                                            dtype):
    b, h, s, d = bhsd
    rng = np.random.default_rng(sum(bhsd) + 7 * causal)
    q, k, v = ((rng.standard_normal((b, s, h, d)) * 0.5).astype(dtype)
               for _ in range(3))
    want = np.asarray(j_ops.flash_attention_op(
        *(x.transpose(0, 2, 1, 3) for x in (q, k, v)), causal=causal),
        np.float32)
    views = [_t(x).transpose(1, 2) for x in (q, k, v)]
    assert all(not t.is_contiguous() for t in views) or h == 1
    got = flash_attention(*views, causal=causal)
    assert tuple(got.shape) == bhsd and got.dtype == views[0].dtype
    tol = 2e-3 if dtype == np.float32 else 3e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_flash_strides_take_the_models_views(device, dtype, d):
    b, s, h = 2, 40, 3
    x = torch.zeros(b, s, h, d, dtype=dtype, device=device)
    view = x.transpose(1, 2)                       # (B,H,S,D), strided
    assert bindings.flash_refusal(view) is None
    assert bindings.flash_strides(view) == (s * h * d, d, h * d)
    assert kernel_operand(view) is view            # no copy
    out = torch.empty_like(view)                   # the wrapper's output
    assert out.stride() == view.stride()
    assert out.transpose(1, 2).is_contiguous()     # the model's layout back
    assert bindings.flash_strides(out) == (s * h * d, d, h * d)
    # a dimension of size 1 never needs its stride
    one = torch.zeros(1, s, 1, d, dtype=dtype, device=device).transpose(1, 2)
    assert bindings.flash_strides(one) == (0, 0, d)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_strides_refuse_what_the_kernel_cannot_take(dtype):
    wide = torch.zeros(2, 3, 40, 64, dtype=dtype)
    cases = {
        "last stride": wide.transpose(2, 3)[:, :, :16, :],   # (…, 40) cols
        "row stride": torch.zeros(2, 3, 40, 18, dtype=dtype)[..., :16],
        "data pointer": torch.zeros(2 * 3 * 40 * 16 + 1, dtype=dtype)[1:]
        .view(2, 3, 40, 16),
    }
    for why, t in cases.items():
        assert bindings.flash_refusal(t) is not None, why
        with pytest.raises(ValueError):
            bindings.flash_strides(t)
        copy = kernel_operand(t)                   # the wrapper copies it
        assert copy is not t and torch.equal(copy, t)
        assert bindings.flash_refusal(copy) is None
    with pytest.raises(ValueError):
        bindings.flash_strides(torch.zeros(3, 40, 16, dtype=dtype))
