"""The port's dense LM family (src/repro_torch/{configs,models,serve,data})
vs the reference on the same inputs and the same weights (carried over
with ``params_from_jax``), on f32 smoke configs of the four dense archs:
deepseek-7b (MHA), minitron-4b (GQA), granite-20b (MQA) and qwen2.5-32b
(GQA with QKV bias).

Tolerances: logits, attention outputs and cache leaves atol 2e-4 / rtol
2e-3 (tests/test_decode_consistency.py's own; f32 sums in another order);
int8 KV is held the way the reference holds it (relative logit error
against f32 KV < 0.08) and against the reference's own int8 decode at the
f32 tolerance, its int8 codes within one step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as j_registry  # noqa: E402
from repro.data import synthetic as j_synth  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models.factory import build_model as j_build  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.data import synthetic as t_synth  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch.serve import grow_cache  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.models.factory import build_model, count_params  # noqa: E402
from repro_torch.serve import kvcache  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-3)
DENSE = ["deepseek-7b", "minitron-4b", "granite-20b", "qwen2.5-32b"]


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
    """Leaf for leaf, dtypes too (int8 codes within one step)."""
    g, w = _flat(got), _flat(_np(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert str(g[k].dtype).split(".")[1] == w[k].dtype.name, k
        if g[k].dtype == torch.int8:
            assert np.abs(g[k].numpy().astype(int)
                          - w[k].astype(int)).max() <= 1, k
            continue
        np.testing.assert_allclose(g[k].float().numpy(),
                                   np.asarray(w[k], np.float32),
                                   err_msg=k, **TOL)


def _grow(cache, extra):
    def growleaf(path, x):
        nm = next((str(e.key) for e in reversed(path)
                   if isinstance(e, jtu.DictKey)), None)
        if nm in ("k", "v", "k_scale", "v_scale"):
            pad = [(0, 0)] * x.ndim
            pad[2] = (0, extra)
            return jnp.pad(x, pad)
        return x
    return jtu.tree_map_with_path(growleaf, cache)


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_and_smoke_configs_equal_the_reference(arch):
    for t_cfg, j_cfg in ((t_registry.get_arch(arch),
                          j_registry.get_arch(arch)),
                         (t_registry.smoke_config(arch),
                          j_registry.smoke_config(arch))):
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
        assert t_cfg.n_heads_padded == j_cfg.n_heads_padded
        assert t_cfg.padded_vocab() == j_cfg.padded_vocab()
        assert tuple(t_attn.layout_from_cfg(t_cfg)) == \
            tuple(j_attn.layout_from_cfg(j_cfg))


@pytest.mark.parametrize("arch", sorted(t_registry.ARCHS))
def test_every_registered_smoke_config_equals_the_reference_field_for_field(
        arch):
    """smoke_config sets ``ssm`` only where the arch has one (the dense
    archs have none), as the reference's does."""
    t_cfg, j_cfg = (t_registry.smoke_config(arch),
                    j_registry.smoke_config(arch))
    for f in dataclasses.fields(j_cfg):
        assert dataclasses.asdict(t_cfg)[f.name] == \
            dataclasses.asdict(j_cfg)[f.name], f.name
    assert (t_cfg.ssm is None) == (t_registry.get_arch(arch).ssm is None)


# ------------------------------------------------------------- the models --
_MODELS = {}


def _model(arch):
    """(torch cfg, jax cfg, jax params, port params, jitted jax Model)."""
    if arch not in _MODELS:
        jcfg = j_registry.smoke_config(arch).replace(dtype="float32")
        tcfg = t_registry.smoke_config(arch).replace(dtype="float32")
        jm = j_build(jcfg)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        if jcfg.qkv_bias:   # non-zero biases, so that a dropped one shows
            jp["layers"]["attn"] = {
                k: v + 0.05 if k.startswith("b") else v
                for k, v in jp["layers"]["attn"].items()}
        jit = jm._replace(
            forward=jax.jit(lambda p, b: jm.forward(p, b,
                                                    remat_policy="none")),
            prefill=jax.jit(jm.prefill, static_argnames="kv_dtype"),
            decode=jax.jit(jm.decode))
        _MODELS[arch] = (tcfg, jcfg, jp,
                         t_tr.params_from_jax(_np(jp), device="cpu"), jit)
    return _MODELS[arch]


def _tokens(arch, b, s, seed=1):
    cfg = t_registry.smoke_config(arch)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_init_tree_matches_reference(arch):
    tcfg, _, jp, _, _ = _model(arch)
    mine = build_model(tcfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    g, w = _flat(mine), _flat(_np(jp))
    assert sorted(g) == sorted(w)
    for k in w:
        assert tuple(g[k].shape) == w[k].shape, k
        assert str(g[k].dtype).split(".")[1] == str(w[k].dtype), k
    assert count_params(mine) == sum(x.size for x in jtu.tree_leaves(jp))
    assert g["/layers/attn/wq"].shape[0] == tcfg.n_layers
    assert ("/layers/attn/bq" in g) == tcfg.qkv_bias


@pytest.mark.parametrize("arch", DENSE)
def test_dense_forward_prefill_and_decode_step_match(arch):
    tcfg, _, jp, tp, jm = _model(arch)
    tm = build_model(tcfg)
    b, s = 2, 24
    toks = _tokens(arch, b, s + 8)
    jfull, _, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tfull, _, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tfull.numpy(), np.asarray(jfull), **TOL)

    jlast, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])},
                               kv_dtype="float32")
    tlast, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])},
                               kv_dtype="float32")
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    _close_trees(tcache, jcache)
    tl1, tc1 = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])},
                          kv_dtype="float32", last_only=True)
    np.testing.assert_allclose(tl1.numpy(), tlast.numpy(), **TOL)
    _close_trees(tc1, jcache)

    # three decode steps on the grown cache, each against forward
    jc, tc = _grow(jcache, 4), grow_cache(tcache, 4)
    for i in range(3):
        db = toks[:, s + i:s + i + 1]
        jlg, jc = jm.decode(jp, jc, {"tokens": jnp.asarray(db)})
        tlg, tc = tm.decode(tp, tc, {"tokens": torch.from_numpy(db)})
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
        np.testing.assert_allclose(tlg.numpy(), tfull[:, s + i].numpy(),
                                   **TOL)
    _close_trees(tc, jc)
    assert tc["pos"].tolist() == [s + 3] * b


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen2.5-32b"])
def test_dense_int8_kv_close_and_matches_reference(arch):
    """Prefill with int8 KV (per-(token, head) scales), then decode: close
    to f32 KV as tests/test_decode_consistency.py holds it, and equal to
    the reference's int8 path; an int8 ``init_cache`` decoded into too."""
    tcfg, _, jp, tp, jm = _model(arch)
    tm = build_model(tcfg)
    b, s = 2, 16
    toks = _tokens(arch, b, s + 3, seed=5)
    db = toks[:, s:s + 1]
    res = {}
    for kv in ("float32", "int8"):
        _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])},
                           kv_dtype=kv)
        _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])},
                           kv_dtype=kv)
        _close_trees(tc, jc)
        jl, _ = jm.decode(jp, _grow(jc, 4), {"tokens": jnp.asarray(db)})
        tl, _ = tm.decode(tp, grow_cache(tc, 4),
                          {"tokens": torch.from_numpy(db)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        res[kv] = tl.numpy()
    rel = np.abs(res["int8"] - res["float32"]).max() / max(
        np.abs(res["float32"]).max(), 1e-6)
    assert rel < 0.08, rel
    jc = jm.init_cache(b, 8, "int8")
    tc = tm.init_cache(b, 8, "int8", device="cpu")
    _close_trees(tc, jc)
    for i in range(3):
        tok = toks[:, i:i + 1]
        jl, jc = jm.decode(jp, jc, {"tokens": jnp.asarray(tok)})
        tl, tc = tm.decode(tp, tc, {"tokens": torch.from_numpy(tok)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_trees(tc, jc)


@pytest.mark.parametrize("kv", ["bfloat16", "float32", "int8"])
def test_dense_init_cache_layout_matches_reference(kv):
    tcfg, jcfg, _, _, _ = _model("minitron-4b")
    _close_trees(build_model(tcfg).init_cache(3, 10, kv, device="cpu"),
                 j_build(jcfg).init_cache(3, 10, kv))


# -------------------------------------------------------------- attention --
@pytest.mark.parametrize("nq,nkv,causal,chunk", [
    (4, 4, True, 8), (6, 2, True, 4), (8, 1, False, 8), (6, 2, False, 16)])
def test_chunked_sdpa_matches_reference(nq, nkv, causal, chunk):
    rng = np.random.default_rng(nq * 10 + nkv)
    b, s, dh = 2, 32, 16
    q = rng.standard_normal((b, s, nq, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, nkv, dh)).astype(np.float32)
            for _ in range(2))
    gp = nq // nkv
    got = t_attn.chunked_sdpa(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, chunk=chunk, gp=gp)
    want = j_attn.chunked_sdpa(*map(jnp.asarray, (q, k, v)), causal=causal,
                               chunk=chunk, gp=gp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the flash wrapper's plain version on the repeated KV heads
    flash = flash_attention(
        *(torch.from_numpy(x).transpose(1, 2) for x in
          (q, np.repeat(k, gp, 2), np.repeat(v, gp, 2))),
        causal=causal).transpose(1, 2)
    np.testing.assert_allclose(flash.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError):
        t_attn.chunked_sdpa(*map(torch.from_numpy, (q, k, v)), causal=causal,
                            chunk=5, gp=gp)


@pytest.mark.parametrize("nq,nkv,pad", [(32, 32, 1), (40, 8, 16), (24, 8, 16),
                                        (48, 1, 16), (6, 6, 16), (4, 2, 1),
                                        (7, 7, 4)])
def test_q_head_is_real_matches_reference(nq, nkv, pad):
    lo, jlo = t_attn.head_layout(nq, nkv, pad), j_attn.head_layout(nq, nkv,
                                                                  pad)
    assert tuple(lo) == tuple(jlo)
    assert [lo.q_head_is_real(i) for i in range(lo.hp)] == \
        [bool(jlo.q_head_is_real(i)) for i in range(jlo.hp)]
    assert [lo.q_head_is_real(i) for i in range(lo.hp)] == \
        lo.q_mask().bool().tolist()


@pytest.mark.parametrize("causal,s,t", [(True, 64, 64), (False, 64, 64),
                                         (False, 40, 72)])
def test_flash_plain_version_at_head_width_128_matches_reference_sdpa(
        causal, s, t):
    """The wrapper on CPU tensors at D = 128, the dense archs' head width,
    against the reference's ``attn.sdpa`` (causal on S == T: both take
    positions from 0 on both axes)."""
    rng = np.random.default_rng(s + t + causal)
    q = rng.standard_normal((2, s, 4, 128)).astype(np.float32) * 0.5
    k, v = (rng.standard_normal((2, t, 4, 128)).astype(np.float32) * 0.5
            for _ in range(2))
    got = flash_attention(*(torch.from_numpy(x).transpose(1, 2)
                            for x in (q, k, v)), causal=causal)
    want = j_attn.sdpa(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               **TOL)


# ------------------------------------------------------------------- data --
@pytest.mark.parametrize("vocab,batch,seq,steps,seed", [
    (503, 4, 16, 3, 0), (102400, 2, 33, 2, 7)])
def test_lm_token_batches_equal_the_reference(vocab, batch, seq, steps,
                                              seed):
    got = list(t_synth.lm_token_batches(vocab, batch, seq, steps, seed))
    want = list(j_synth.lm_token_batches(vocab, batch, seq, steps, seed))
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_moe_and_mla_archs_still_raise():
    """The moe and MLA archs build now; a family neither package knows
    raises ValueError, as the reference's ``init_decoder`` does."""
    from repro.configs import base as j_base
    from repro.models import transformer as j_tr
    from repro_torch.configs import base as t_base
    for name in ("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"):
        cfg = t_registry.smoke_config(name)
        build_model(cfg)
        assert sorted(kvcache.init_cache(cfg, 1, 4, device="cpu")) == \
            sorted(j_build(j_registry.smoke_config(name)).init_cache(1, 4))
    args = ("x", "convolutional", 1, 8, 2, 2, 16, 32)
    with pytest.raises(ValueError, match="convolutional"):
        j_tr.init_decoder(jax.random.PRNGKey(0), j_base.ArchConfig(*args))
    with pytest.raises(ValueError, match="convolutional"):
        build_model(t_base.ArchConfig(*args))
    with pytest.raises(ValueError, match="convolutional"):
        t_tr.init_decoder(torch.Generator(), t_base.ArchConfig(*args),
                          device="cpu")
