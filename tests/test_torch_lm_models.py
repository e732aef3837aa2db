"""The port's LM modules (src/repro_torch/{configs,models,serve}) vs the
reference on the same inputs and the same weights (carried over with
``params_from_jax``), on f32 smoke configs of zamba2-1.2b (hybrid: SSM
stack + shared GQA attention/MLP block) and mamba2-130m (ssm).

Tolerances: logits, block outputs and cache leaves atol 2e-4 / rtol 2e-3
(tests/test_decode_consistency.py's own; f32 sums in another order);
elementwise pieces (norms, RoPE, activations) 1e-6; int8 KV is held the
way the reference holds it (relative logit error against f32 KV < 0.08)
and against the reference's own int8 decode at the f32 tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as j_base  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models import ffn as j_ffn  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro.models.factory import build_model as j_build  # noqa: E402
from repro.serve import kvcache as j_kv  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models import ffn as t_ffn  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.models.factory import build_model, count_params  # noqa: E402
from repro_torch.serve import kvcache as t_kv  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-3)
ARCHS = ["zamba2-1.2b", "mamba2-130m"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict of arrays/tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _close_trees(got, want):
    """Leaf for leaf, dtypes too; a bf16 leaf may differ by one bf16
    rounding (up to 2^-7 relative) where its f32 source sat near a
    rounding boundary."""
    g, w = _flat(got), _flat(_np(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert str(g[k].dtype).split(".")[1] == w[k].dtype.name, k
        tol = (dict(atol=TOL["atol"], rtol=2 ** -7)
               if g[k].dtype == torch.bfloat16 else TOL)
        np.testing.assert_allclose(
            g[k].float().numpy(), np.asarray(w[k], np.float32),
            err_msg=k, **tol)


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("name", ["SSMConfig", "MoEConfig", "MLAConfig",
                                  "EncoderConfig", "VisionConfig",
                                  "ArchConfig", "TahomaCNNConfig"])
def test_config_dataclasses_pin_the_reference(name):
    def spec(cls):
        return [(f.name, f.default, f.default_factory)
                for f in dataclasses.fields(cls)]
    assert spec(getattr(t_base, name)) == spec(getattr(j_base, name))
    props = sorted(k for k, v in vars(getattr(j_base, name)).items()
                   if isinstance(v, property))
    assert props == sorted(k for k, v in vars(getattr(t_base, name)).items()
                           if isinstance(v, property))


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_and_smoke_configs_equal_the_reference(arch):
    for t_cfg, j_cfg in ((t_registry.get_arch(arch),
                          j_registry.get_arch(arch)),
                         (t_registry.smoke_config(arch),
                          j_registry.smoke_config(arch))):
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
        for prop in ("uses_attention", "d_inner", "ssm_heads", "conv_dim",
                     "n_heads_padded", "ssm_heads_padded", "d_inner_padded",
                     "conv_dim_padded"):
            assert getattr(t_cfg, prop) == getattr(j_cfg, prop), prop
        assert t_cfg.padded_vocab() == j_cfg.padded_vocab()


def test_other_archs_wait_for_their_slice():
    """No arch waits any more: the port registers the reference's ten,
    name for name and config for config, and an unknown arch still raises
    KeyError in both."""
    assert list(t_registry.ARCHS) == list(j_registry.ARCHS)
    for name, cfg in j_registry.ARCHS.items():
        assert dataclasses.asdict(t_registry.get_arch(name)) == \
            dataclasses.asdict(cfg), name
        build_model(t_registry.smoke_config(name))
    for reg in (t_registry, j_registry):
        with pytest.raises(KeyError):
            reg.get_arch("no-such-arch")


# ------------------------------------------------------------- elementwise --
def test_norms_rope_and_activations_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    cfg = t_registry.smoke_config("zamba2-1.2b").replace(dtype="float32")
    jcfg = j_registry.smoke_config("zamba2-1.2b").replace(dtype="float32")
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for kind in ("rmsnorm", "layernorm"):
        np.testing.assert_allclose(
            t_common.apply_norm(tp, torch.from_numpy(x),
                                cfg.replace(norm=kind)).numpy(),
            np.asarray(j_common.apply_norm(p, jnp.asarray(x), jcfg, kind)),
            atol=1e-5, rtol=1e-5)
        assert sorted(t_common.init_norm(cfg.replace(norm=kind),
                                         device="cpu")) == \
            sorted(j_common.init_norm(jcfg.replace(norm=kind)))
    pos = np.arange(10, dtype=np.int32)[None].repeat(2, 0) + 3
    tc, ts = t_common.rope_for_heads(torch.from_numpy(pos), 16, 10000.0)
    jc, js = j_common.rope_for_heads(jnp.asarray(pos), 16, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    q = rng.standard_normal((2, 10, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        t_common.apply_rope(torch.from_numpy(q), tc, ts).numpy(),
        np.asarray(j_common.apply_rope(jnp.asarray(q), jc, js)), atol=1e-5)
    for name in ("silu", "gelu", "relu"):
        np.testing.assert_allclose(
            t_common.activation(name)(torch.from_numpy(x)).numpy(),
            np.asarray(j_common.activation(name)(jnp.asarray(x))),
            atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------- the models --
_MODELS = {}


def _model(arch):
    """(torch cfg, jax cfg, jax params, port params), built once."""
    if arch not in _MODELS:
        jcfg = j_registry.smoke_config(arch).replace(dtype="float32")
        tcfg = t_registry.smoke_config(arch).replace(dtype="float32")
        jp = jax.jit(j_build(jcfg).init)(jax.random.PRNGKey(0))
        _MODELS[arch] = (tcfg, jcfg, jp,
                         t_tr.params_from_jax(_np(jp), device="cpu"))
    return _MODELS[arch]


def _jitted(jcfg):
    """The reference's Model with jitted entry points (kv_dtype static)."""
    m = j_build(jcfg)
    prefill = jax.jit(m.prefill, static_argnames="kv_dtype")
    return m._replace(forward=jax.jit(
                          lambda p, b: m.forward(p, b, remat_policy="none")),
                      prefill=prefill, decode=jax.jit(m.decode))


def _tokens(arch, b, s, seed=1):
    cfg = t_registry.smoke_config(arch)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference_and_scales(arch):
    tcfg, jcfg, jp, _ = _model(arch)
    mine = build_model(tcfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    g, w = _flat(mine), _flat(_np(jp))
    assert sorted(g) == sorted(w)
    for k in w:
        assert tuple(g[k].shape) == w[k].shape, k
        assert str(g[k].dtype).split(".")[1] == str(w[k].dtype), k
    assert count_params(mine) == sum(x.size for x in jtu.tree_leaves(jp))
    # dense_init: std 1/sqrt(fan_in); embed_init 0.02
    wx = g["/layers/ssm/w_x"]
    assert abs(wx.std().item() * tcfg.d_model ** 0.5 - 1) < 0.1
    assert abs(g["/embed/embedding"].std().item() / 0.02 - 1) < 0.1


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_ssm_prefill_and_decode_match(arch):
    tcfg, jcfg, jp, tp = _model(arch)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["ssm"])
    tl = {k: v[0] for k, v in tp["layers"]["ssm"].items()}
    x = (np.random.default_rng(2).standard_normal((2, 65, 64)) * 0.5
         ).astype(np.float32)              # 2 chunks of 32, then 1 token
    jo, jc = jax.jit(lambda p, x: j_ssm.apply_ssm(
        p, x, jcfg, collect_state=True))(jl, jnp.asarray(x[:, :-1]))
    to, tc = t_ssm.apply_ssm(tl, torch.from_numpy(x[:, :-1]), tcfg,
                             collect_state=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    _close_trees(tc, jc)
    jo, jc = jax.jit(lambda p, x, c: j_ssm.apply_ssm(p, x, jcfg, cache=c))(
        jl, jnp.asarray(x[:, -1:]), jc)
    to, tc = t_ssm.apply_ssm(tl, torch.from_numpy(x[:, -1:]), tcfg, cache=tc)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    _close_trees(tc, jc)


def test_shared_attention_block_full_and_decode_match():
    """zamba2's shared block: GQA (smoke: 4 q heads on 2 kv heads) through
    the flash_attention wrapper on the full pass, sdpa over the cache in
    decode."""
    tcfg, jcfg, jp, tp = _model("zamba2-1.2b")
    b, s = 2, 24
    h = (np.random.default_rng(3).standard_normal((b, s, 64)) * 0.5
         ).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None].repeat(b, 0)
    j_rope = j_tr._make_rope(jcfg, jnp.asarray(pos))
    t_rope = t_tr._make_rope(tcfg, torch.from_numpy(pos))
    jh, _, jcoll, _ = jax.jit(lambda p, h, r: j_tr._dense_block(
        p, h, jcfg, r, chunk=0, moe_groups=1))(jp["shared"], jnp.asarray(h),
                                               j_rope)
    th, _, tcoll, _ = t_tr._dense_block(tp["shared"], torch.from_numpy(h),
                                        tcfg, t_rope)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    _close_trees(tcoll, jcoll)
    # decode one token at position s against a cache holding the first s
    for kv in ("float32", "int8"):
        jc = jax.tree.map(lambda a: a[0], j_kv.init_attn_kv(jcfg, b, s + 4, kv))
        tc = {k: v[0] for k, v in t_kv.init_attn_kv(
            tcfg, b, s + 4, kv, device="cpu").items()}
        p1 = np.full((b,), s, np.int32)
        x1 = h[:, :1] * 0.7
        jr1 = j_tr._make_rope(jcfg, jnp.asarray(p1)[:, None])
        tr1 = t_tr._make_rope(tcfg, torch.from_numpy(p1)[:, None])
        jo, _, _, jnc = jax.jit(lambda p, x, r, c, q: j_tr._dense_block(
            p, x, jcfg, r, chunk=0, moe_groups=1, cache_slice=c, pos=q))(
            jp["shared"], jnp.asarray(x1), jr1, jc, jnp.asarray(p1))
        to, _, _, tnc = t_tr._dense_block(tp["shared"], torch.from_numpy(x1),
                                          tcfg, tr1, cache_slice=tc,
                                          pos=torch.from_numpy(p1))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        if kv == "int8":   # same int8 codes, scales to f32 rounding
            assert np.abs(tnc["k"].numpy().astype(int)
                          - np.asarray(jnc["k"]).astype(int)).max() <= 1
            jnc = {k: v for k, v in jnc.items() if k in ("k_scale",
                                                         "v_scale")}
            tnc = {k: tnc[k] for k in jnc}
        _close_trees(tnc, jnc)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_step_match(arch):
    from repro_torch.launch.serve import grow_cache
    tcfg, jcfg, jp, tp = _model(arch)
    jm, tm = _jitted(jcfg), build_model(tcfg)
    b, s = 2, 64                    # prefill 2 SSD chunks of 32, forward 3
    toks = _tokens(arch, b, s + 32)
    jfull, _, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tfull, _, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tfull.numpy(), np.asarray(jfull), **TOL)

    jlast, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])},
                               kv_dtype="float32")
    tlast, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])},
                               kv_dtype="float32")
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    _close_trees(tcache, jcache)
    tl = tm.forward(tp, {"tokens": torch.from_numpy(toks[:, :s])},
                    logits_last_only=True)[0]
    np.testing.assert_allclose(tl[:, 0].numpy(), tlast.numpy(), **TOL)

    db = toks[:, s:s + 1]
    jlg, jc2 = jm.decode(jp, _grow(jcache, 4), {"tokens": jnp.asarray(db)})
    tlg, tc2 = tm.decode(tp, grow_cache(tcache, 4),
                         {"tokens": torch.from_numpy(db)})
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
    np.testing.assert_allclose(tlg.numpy(), tfull[:, s].numpy(), **TOL)
    _close_trees(tc2, jc2)
    assert tc2["pos"].tolist() == [s + 1] * b


def test_int8_kv_on_zamba2_matches_reference():
    """Prefill with kv_dtype int8 (the hybrid keeps its shared k/v in bf16,
    as the reference does), then decode; and decode from an int8
    ``init_cache`` (the int8 write/read path), three steps."""
    arch = "zamba2-1.2b"
    tcfg, jcfg, jp, tp = _model(arch)
    jm, tm = _jitted(jcfg), build_model(tcfg)
    b, s = 2, 16
    toks = _tokens(arch, b, s + 3, seed=5)
    db = {"tokens": toks[:, s:s + 1]}
    res = {}
    for kv in ("float32", "int8"):
        _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])},
                           kv_dtype=kv)
        _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])},
                           kv_dtype=kv)
        _close_trees(tc, jc)
        jl, _ = jm.decode(jp, _grow(jc, 4), {"tokens": jnp.asarray(db["tokens"])})
        from repro_torch.launch.serve import grow_cache
        tl, _ = tm.decode(tp, grow_cache(tc, 4),
                          {"tokens": torch.from_numpy(db["tokens"])})
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
    assert np.abs(tc["shared_attn"]["k"].numpy().astype(int)
                  - np.asarray(jc["shared_attn"]["k"]).astype(int)).max() <= 1
    np.testing.assert_allclose(tc["shared_attn"]["k_scale"].numpy(),
                               np.asarray(jc["shared_attn"]["k_scale"]),
                               **TOL)


def test_nongated_mlp_biased_gqa_and_masked_sdpa_match():
    """Variants no smoke config of the slice uses: the gelu MLP with
    biases, QKV biases, and sdpa over a cache with ragged valid lengths,
    against the reference on the same weights."""
    jcfg = j_registry.smoke_config("zamba2-1.2b").replace(
        dtype="float32", act="gelu", qkv_bias=True)
    tcfg = t_registry.smoke_config("zamba2-1.2b").replace(
        dtype="float32", act="gelu", qkv_bias=True)
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    jmlp = j_ffn.init_mlp(k1, jcfg)
    jmlp = {k: v + 0.1 if k.startswith("b_") else v for k, v in jmlp.items()}
    jq = j_attn.init_gqa(k2, jcfg)
    jq = {k: v + 0.1 if k.startswith("b") else v for k, v in jq.items()}
    tmlp, tq = (t_tr.params_from_jax(_np(t), device="cpu")
                for t in (jmlp, jq))
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    np.testing.assert_allclose(
        t_ffn.apply_mlp(tmlp, torch.from_numpy(x), tcfg).numpy(),
        np.asarray(j_ffn.apply_mlp(jmlp, jnp.asarray(x), jcfg)), **TOL)
    pos = np.arange(12, dtype=np.int32)[None].repeat(2, 0)
    jr = j_tr._make_rope(jcfg, jnp.asarray(pos))
    tr = t_tr._make_rope(tcfg, torch.from_numpy(pos))
    jqkv = j_attn.gqa_qkv(jq, jnp.asarray(x), jcfg, rope=jr + jr)
    tqkv = t_attn.gqa_qkv(tq, torch.from_numpy(x), tcfg, rope=tr + tr)
    for got, want in zip(tqkv, jqkv):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    lo = t_attn.layout_from_cfg(tcfg)
    valid = np.arange(12)[None] <= np.array([[4], [9]])   # (B,T) ragged
    got = t_attn.sdpa(tqkv[0][:, -1:], *tqkv[1:],
                      k_valid=torch.from_numpy(valid), gp=lo.gp)
    want = j_attn.sdpa(jqkv[0][:, -1:], *jqkv[1:], causal=False,
                       k_valid=jnp.asarray(valid), gp=lo.gp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("nq,nkv,pad", [(32, 32, 1), (40, 8, 16), (24, 8, 16),
                                        (6, 6, 16), (4, 2, 1), (7, 7, 4)])
def test_head_layout_and_mask_match(nq, nkv, pad):
    lo = t_attn.head_layout(nq, nkv, pad)
    jlo = j_attn.head_layout(nq, nkv, pad)
    assert tuple(lo) == tuple(jlo)
    np.testing.assert_array_equal(lo.q_mask().numpy(), np.asarray(jlo.q_mask))
