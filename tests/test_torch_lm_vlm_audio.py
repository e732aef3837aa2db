"""The port's vlm family (qwen2-vl's backbone: GQA with QKV bias, M-RoPE
over (t, h, w) position streams, patch embeddings replacing the prompt's
prefix) and audio family (whisper-tiny's encoder-decoder, models/encdec)
against the reference on the same inputs and the same weights (carried
over with ``params_from_jax``), on f32 smoke configs; and which attention
of each new family goes through the flash kernel wrapper.

Tolerances: logits, encoder states, attention outputs and cache leaves
atol 2e-4 / rtol 2e-3 (tests/test_decode_consistency.py's own; f32 sums
in another order); elementwise pieces (norms, angles, positions) 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as j_registry  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models import encdec as j_encdec  # noqa: E402
from repro.models.factory import build_model as j_build  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models import encdec as t_encdec  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.models.factory import build_model, count_params  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-3)
ELEM = dict(atol=1e-6, rtol=1e-6)
NEW = ["qwen2-vl-72b", "whisper-tiny"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _close_trees(got, want):
    """Leaf for leaf, dtypes too."""
    g, w = _flat(got), _flat(_np(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert str(g[k].dtype).split(".")[1] == w[k].dtype.name, k
        np.testing.assert_allclose(g[k].float().numpy(),
                                   np.asarray(w[k], np.float32),
                                   err_msg=k, **TOL)


def _grow(cache, extra):
    """The reference's cache growth (launch/serve.py's ``grow``): the
    cross cache keeps its length."""
    def growleaf(path, x):
        nm = next((str(e.key) for e in reversed(path)
                   if isinstance(e, jtu.DictKey)), None)
        in_cross = any(isinstance(e, jtu.DictKey) and str(e.key) == "cross"
                       for e in path)
        if nm in ("k", "v", "c_kv", "k_rope", "k_scale", "v_scale") \
                and not in_cross:
            pad = [(0, 0)] * x.ndim
            pad[2] = (0, extra)
            return jnp.pad(x, pad)
        return x
    return jtu.tree_map_with_path(growleaf, cache)


_MODELS = {}


def _model(arch):
    """(torch cfg, jax cfg, jax params, port params, jitted jax Model) of
    the f32 smoke config; QKV biases made non-zero, so that a dropped one
    shows."""
    if arch not in _MODELS:
        jcfg = j_registry.smoke_config(arch).replace(dtype="float32")
        tcfg = t_registry.smoke_config(arch).replace(dtype="float32")
        jm = j_build(jcfg)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        jp = jtu.tree_map_with_path(
            lambda path, x: x + 0.05 if str(path[-1].key) in (
                "bq", "bk", "bv", "b_in", "b_out") else x, jp)
        jit = jm._replace(
            forward=jax.jit(lambda p, b: jm.forward(p, b,
                                                    remat_policy="none")),
            prefill=jax.jit(jm.prefill, static_argnames="kv_dtype"),
            decode=jax.jit(jm.decode))
        _MODELS[arch] = (tcfg, jcfg, jp,
                         t_tr.params_from_jax(_np(jp), device="cpu"), jit)
    return _MODELS[arch]


def _inputs(arch, b, s, seed=1):
    """tokens (B,S) and the family's extras: whisper's frame embeddings;
    qwen2-vl's patch embeddings and (t, h, w) positions (the patches on a
    2 x n/2 grid at t 0, then the text, every stream counting on)."""
    cfg = t_registry.smoke_config(arch)
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        out["enc_frames"] = (rng.standard_normal(
            (b, cfg.encoder.n_frames, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        n = cfg.vision.n_patches
        out["vision_embeds"] = (rng.standard_normal((b, n, cfg.d_model))
                                * 0.1).astype(np.float32)
        pos = np.broadcast_to(np.arange(s), (3, b, s)).copy()
        pos[0, :, :n] = 0
        pos[1, :, :n] = np.arange(n) // (n // 2)
        pos[2, :, :n] = np.arange(n) % (n // 2)
        out["mrope_positions"] = pos.astype(np.int32)
    return out


def _cut(batch, s):
    """The first s positions of a batch (the whole frames and patches)."""
    out = dict(batch, tokens=batch["tokens"][:, :s])
    if "mrope_positions" in batch:
        out["mrope_positions"] = batch["mrope_positions"][:, :, :s]
    return out


def _step(batch, i):
    out = {"tokens": batch["tokens"][:, i:i + 1]}
    if "mrope_positions" in batch:
        out["mrope_positions"] = batch["mrope_positions"][:, :, i:i + 1]
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# ------------------------------------------------------------ elementwise --
def test_mrope_sinusoidal_positions_and_rmsnorm_vec_match():
    rng = np.random.default_rng(0)
    pos3 = rng.integers(0, 300, (3, 2, 9)).astype(np.int32)
    for hd, sections in ((16, (2, 3, 3)), (128, (16, 24, 24))):
        got = t_common.mrope_for_heads(torch.from_numpy(pos3), hd, 1e6,
                                       sections)
        want = j_common.mrope_for_heads(jnp.asarray(pos3), hd, 1e6, sections)
        for g, w in zip(got, want):
            assert tuple(g.shape) == (2, 9, 1, hd // 2)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **ELEM)
    with pytest.raises(ValueError):
        t_common.mrope_for_heads(torch.from_numpy(pos3), 16, 1e6, (2, 3, 4))
    for n, d in ((32, 64), (1500, 384), (7, 2)):
        np.testing.assert_allclose(
            t_common.sinusoidal_positions(n, d).numpy(),
            np.asarray(j_common.sinusoidal_positions(n, d)), **ELEM)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3
    scale = rng.standard_normal(24).astype(np.float32)
    np.testing.assert_allclose(
        t_common.rmsnorm_vec(torch.from_numpy(x), torch.from_numpy(scale),
                             1e-6).numpy(),
        np.asarray(j_common.rmsnorm_vec(jnp.asarray(x), jnp.asarray(scale),
                                        1e-6)), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- the models --
@pytest.mark.parametrize("arch", NEW)
def test_configs_and_init_trees_match_the_reference(arch):
    tcfg, _, jp, _, _ = _model(arch)
    for t_cfg, j_cfg in ((t_registry.get_arch(arch),
                          j_registry.get_arch(arch)),
                         (t_registry.smoke_config(arch),
                          j_registry.smoke_config(arch))):
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    mine = build_model(tcfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    g, w = _flat(mine), _flat(_np(jp))
    assert sorted(g) == sorted(w)
    for k in w:
        assert tuple(g[k].shape) == w[k].shape, k
        assert str(g[k].dtype).split(".")[1] == str(w[k].dtype), k
    assert count_params(mine) == sum(x.size for x in jtu.tree_leaves(jp))


@pytest.mark.parametrize("arch", NEW)
def test_forward_prefill_and_decode_steps_match(arch):
    """qwen2-vl with patch embeddings and (t, h, w) M-RoPE positions;
    whisper with frame embeddings (its encoder, the self and cross
    caches). Logits of forward and prefill, the cache, then three decode
    steps on the grown cache, each against the reference and forward."""
    tcfg, _, jp, tp, jm = _model(arch)
    tm = build_model(tcfg)
    b, s = 2, 20
    batch = _inputs(arch, b, s + 8)
    jfull, _, _ = jm.forward(jp, _j(batch))
    tfull, taux, _ = tm.forward(tp, _t(batch))
    np.testing.assert_allclose(tfull.numpy(), np.asarray(jfull), **TOL)
    assert float(taux) == 0.0
    pre = _cut(batch, s)
    jlast, jcache = jm.prefill(jp, _j(pre), kv_dtype="float32")
    tlast, tcache = tm.prefill(tp, _t(pre), kv_dtype="float32")
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    _close_trees(tcache, jcache)
    jc, tc = _grow(jcache, 4), t_serve.grow_cache(tcache, 4)
    for i in range(3):
        jlg, jc = jm.decode(jp, jc, _j(_step(batch, s + i)))
        tlg, tc = tm.decode(tp, tc, _t(_step(batch, s + i)))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
        np.testing.assert_allclose(tlg.numpy(), tfull[:, s + i].numpy(),
                                   **TOL)
    _close_trees(tc, jc)


def test_whisper_encode_matches_and_the_cross_cache_is_bf16():
    tcfg, jcfg, jp, tp, _ = _model("whisper-tiny")
    frames = _inputs("whisper-tiny", 2, 4)["enc_frames"]
    got = t_encdec.encode(tp, torch.from_numpy(frames), tcfg)
    want = jax.jit(lambda p, f: j_encdec.encode(p, f, jcfg, "none"))(
        jp, jnp.asarray(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for kv in ("bfloat16", "float32", "int8"):
        tc = build_model(tcfg).init_cache(3, 10, kv, device="cpu")
        _close_trees(tc, j_build(jcfg).init_cache(3, 10, kv))
        assert tc["cross"]["k"].dtype == torch.bfloat16
        assert tc["cross"]["k"].shape[2] == tcfg.encoder.n_frames
    grown = t_serve.grow_cache(tc, 5)
    assert grown["self"]["k"].shape[2] == 15
    assert grown["cross"]["k"].shape[2] == tcfg.encoder.n_frames


@pytest.mark.parametrize("arch", NEW)
def test_prefill_decode_matches_forward(arch):
    """tests/test_decode_consistency.py's check on the port, with the
    reference's extras (qwen2-vl: patch embeddings and positions that
    count tokens on all three streams)."""
    tcfg, _, _, tp, _ = _model(arch)
    tm = build_model(tcfg)
    b, s = 2, 16
    batch = _t(_inputs(arch, b, s + 1, seed=3))
    if "mrope_positions" in batch:
        batch["mrope_positions"] = torch.arange(s + 1)[None, None].expand(
            3, b, s + 1)
    full, _, _ = tm.forward(tp, batch)
    last, cache = tm.prefill(tp, _cut(batch, s), kv_dtype="float32")
    np.testing.assert_allclose(last.numpy(), full[:, s - 1].numpy(), **TOL)
    lg, cache = tm.decode(tp, t_serve.grow_cache(cache, 4), _step(batch, s))
    np.testing.assert_allclose(lg.numpy(), full[:, s].numpy(), **TOL)
    assert int(cache["pos"][0]) == s + 1


def _reference_greedy(jm, jp, batch, gen, family):
    """launch/serve.py's loop on the reference: jitted prefill, ``grow``,
    jitted greedy decode, the vlm family's step i at position S + i on
    every stream."""
    b, s = batch["tokens"].shape
    prefill = jax.jit(lambda p, bt: jm.prefill(p, bt, kv_dtype="float32"))
    decode = jax.jit(lambda p, c, bt: jm.decode(p, c, bt))
    logits, cache = prefill(jp, _j(batch))
    cache = _grow(cache, gen)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, seen = [tok], [logits]
    for i in range(gen):
        db = {"tokens": tok}
        if family == "vlm":
            db["mrope_positions"] = jnp.full((3, b, 1), s + i, jnp.int32)
        logits, cache = decode(jp, cache, db)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(tok)
        seen.append(logits)
    return (np.asarray(jnp.concatenate(toks, 1)),
            np.stack([np.asarray(x) for x in seen]))


@pytest.mark.parametrize("arch", NEW)
def test_serve_matches_a_reference_greedy_loop(arch):
    """``launch.serve.serve`` (f32 KV; qwen2-vl with its patch prefix and
    (t, h, w) positions, whisper with frames) against the reference's
    greedy loop with the same weights: logits within tolerance at every
    step, greedy tokens identical (a reference near-tie is named in the
    failure, never skipped)."""
    tcfg, _, jp, tp, jm = _model(arch)
    b, s, gen = 2, 20, 5
    batch = _inputs(arch, b, s, seed=11)
    want_toks, want_logits = _reference_greedy(jm, jp, batch, gen,
                                               tcfg.family)
    extras = {k: torch.from_numpy(v) for k, v in batch.items()
              if k != "tokens"}
    ops.reset_launch_counts()
    res = t_serve.serve(build_model(tcfg), tp, batch["tokens"], gen,
                        "float32", device="cpu", **extras)
    assert all(n == 0 for n in ops.LAUNCHES.values())   # plain versions
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    ties = np.argwhere(gap <= 2 * (TOL["atol"]
                                   + TOL["rtol"] * np.abs(top2[..., 1])))
    assert np.array_equal(res.tokens.numpy(), want_toks), (
        f"greedy tokens differ; near-ties (step, row): {ties.tolist()}")
    np.testing.assert_allclose(res.logits.numpy(), want_logits, **TOL)


def test_serve_cli_runs_every_new_family_on_the_cpu(capsys):
    for arch in ("whisper-tiny", "qwen2-vl-72b", "phi3.5-moe-42b-a6.6b"):
        res = t_serve.main(["--arch", arch, "--device", "cpu", "--batch",
                            "2", "--prompt-len", "12", "--gen", "2"])
        assert f"arch={arch} params=" in capsys.readouterr().out
        assert tuple(res.tokens.shape) == (2, 3)
    with pytest.raises(ValueError, match="enc_frames"):
        model = build_model(t_registry.smoke_config("whisper-tiny"))
        t_serve.serve(model, _model("whisper-tiny")[3],
                      np.zeros((1, 4), np.int32), 1, device="cpu")


# ------------------------------------------------- the flash kernel's use --
@pytest.mark.parametrize("arch,want", [
    ("phi3.5-moe-42b-a6.6b", ["causal (2, 4, 24, 16) (2, 4, 24, 16)"] * 2),
    ("deepseek-v2-236b", []),
    ("qwen2-vl-72b", ["causal (2, 4, 24, 16) (2, 4, 24, 16)"] * 2),
    ("whisper-tiny", ["full (2, 4, 32, 16) (2, 4, 32, 16)"] * 2
     + ["causal (2, 4, 24, 16) (2, 4, 24, 16)",
        "full (2, 4, 24, 16) (2, 4, 32, 16)"] * 2)])
def test_full_sequence_attention_goes_through_the_flash_wrapper(
        monkeypatch, arch, want):
    """One prefill calls the flash wrapper once per GQA attention: every
    phi3.5 and qwen2-vl layer (causal), whisper's encoder layers (not
    causal), then per decoder layer its self-attention (causal) and
    cross-attention (not causal, S queries on T frames); MLA never (its
    q/k and v heads differ in width). Decode calls it never."""
    calls = []
    real = t_tr.flash_attention

    def spy(q, k, v, *, causal):
        calls.append(f"{'causal' if causal else 'full'} "
                     f"{tuple(q.shape)} {tuple(k.shape)}")
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(t_tr, "flash_attention", spy)
    tcfg, _, _, tp, _ = _model(arch)
    tm = build_model(tcfg)
    batch = _t(_inputs(arch, 2, 25))
    _, cache = tm.prefill(tp, _cut(batch, 24))
    assert calls == want
    tm.decode(tp, t_serve.grow_cache(cache, 1), _step(batch, 24))
    assert len(calls) == len(want)


@pytest.mark.parametrize("s,t,causal", [(24, 72, False), (72, 24, False),
                                         (40, 40, True)])
def test_flash_plain_version_at_head_width_64_matches_reference_sdpa(
        s, t, causal):
    """The wrapper on CPU tensors at D = 64, whisper's head width, on
    (B,S,H,D).transpose(1, 2) views: cross-attention's S != T without
    the mask, and the causal self-attention, against the reference's
    ``attn.sdpa``."""
    rng = np.random.default_rng(s + t)
    q = rng.standard_normal((2, s, 6, 64)).astype(np.float32) * 0.5
    k, v = (rng.standard_normal((2, t, 6, 64)).astype(np.float32) * 0.5
            for _ in range(2))
    got = flash_attention(*(torch.from_numpy(x).transpose(1, 2)
                            for x in (q, k, v)), causal=causal)
    want = j_attn.sdpa(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               **TOL)


def test_new_families_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    tp = _model("whisper-tiny")[3]
    for arch in ("whisper-tiny", "deepseek-v2-236b", "qwen2-vl-72b"):
        model = build_model(t_registry.smoke_config(arch))
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init(torch.Generator())
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init_cache(1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_serve.serve(build_model(_model("whisper-tiny")[0]), tp,
                      np.zeros((1, 4), np.int32), 1,
                      enc_frames=np.zeros((1, 32, 64), np.float32))
