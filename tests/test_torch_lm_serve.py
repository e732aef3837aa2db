"""The slice as a whole: the port's ``launch.serve.serve`` (prefill, cache
growth, greedy decode) against the reference's serving loop, jitted as
``repro.launch.serve`` runs it, with the reference's cache growth, on the
f32 smoke config of zamba2-1.2b with the same weights and prompts.

Logits agree at every step within atol 2e-4 / rtol 2e-3
(tests/test_decode_consistency.py's tolerance), and the greedy tokens are
identical. A step where the reference's top two logits lie within that
tolerance of each other is a near-tie: such steps are counted and named in
the failure message, never skipped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import smoke_config as j_smoke  # noqa: E402
from repro.models.factory import build_model as j_build  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402

ATOL, RTOL = 2e-4, 2e-3


def _reference_serve(model, params, tokens, gen, kv_dtype):
    """launch/serve.py's loop: jitted prefill, ``grow`` to prompt+gen,
    jitted greedy decode. Returns (tokens (B, gen+1), logits per step)."""
    prefill = jax.jit(lambda p, bt: model.prefill(p, bt, kv_dtype=kv_dtype))
    decode = jax.jit(lambda p, c, bt: model.decode(p, c, bt))
    logits, cache = prefill(params, {"tokens": jnp.asarray(tokens)})

    def grow(path, x):
        name = next((str(e.key) for e in reversed(path)
                     if isinstance(e, jax.tree_util.DictKey)), "")
        if name in ("k", "v", "c_kv", "k_rope", "k_scale", "v_scale") \
                and x.ndim >= 3:
            pad = [(0, 0)] * x.ndim
            pad[2] = (0, gen)
            return jnp.pad(x, pad)
        return x
    cache = jax.tree_util.tree_map_with_path(grow, cache)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, seen = [tok], [logits]
    for _ in range(gen):
        logits, cache = decode(params, cache, {"tokens": tok})
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(tok)
        seen.append(logits)
    return (np.asarray(jnp.concatenate(toks, 1)),
            np.stack([np.asarray(x) for x in seen]))


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_serve_matches_the_reference_loop(kv_dtype):
    b, s, gen = 2, 32, 6
    jcfg = j_smoke("zamba2-1.2b").replace(dtype="float32")
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (b, s)).astype(np.int32)
    want_toks, want_logits = _reference_serve(jm, jp, prompts, gen, kv_dtype)

    model = build_model(smoke_config("zamba2-1.2b").replace(dtype="float32"))
    params = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ops.reset_launch_counts()
    res = t_serve.serve(model, params, prompts, gen, kv_dtype, device="cpu")
    assert all(n == 0 for n in ops.LAUNCHES.values())   # plain versions
    assert res.tokens.shape == (b, gen + 1)
    assert res.logits.shape == want_logits.shape
    assert res.prefill_s > 0 and res.decode_s > 0

    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    ties = [(step, row, float(gap[step, row]))
            for step, row in zip(*np.nonzero(
                gap <= 2 * (ATOL + RTOL * np.abs(top2[..., 1]))))]
    got = res.tokens.numpy()
    assert np.array_equal(got, want_toks), (
        f"greedy tokens differ; near-ties (step, row, gap): {ties}")
    np.testing.assert_allclose(res.logits.numpy(), want_logits, atol=ATOL,
                               rtol=RTOL, err_msg=f"near-ties: {ties}")


def test_serve_cli_runs_the_smoke_config_on_the_cpu(capsys):
    res = t_serve.main(["--arch", "mamba2-130m", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "32", "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=mamba2-130m params=" in out and "tok/s" in out
    assert tuple(res.tokens.shape) == (2, 4)
    cfg = smoke_config("mamba2-130m")
    assert int(res.tokens.max()) < cfg.padded_vocab()


def test_grow_cache_pads_only_the_sequence_axis_of_attention_leaves():
    model = build_model(smoke_config("zamba2-1.2b"))
    cache = model.init_cache(2, 5, "int8", device="cpu")
    grown = t_serve.grow_cache(cache, 3)
    for name in ("k", "v", "k_scale", "v_scale"):
        old, new = cache["shared_attn"][name], grown["shared_attn"][name]
        assert new.shape[2] == 8 and new.dtype == old.dtype
        assert not new[:, :, 5:].any()
    for name, leaf in cache["ssm"].items():
        assert grown["ssm"][name].shape == leaf.shape
