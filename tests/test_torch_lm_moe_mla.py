"""The port's moe family (src/repro_torch/{configs,models,serve,launch}):
phi3.5-moe (GQA attention + MoE, no shared experts) and deepseek-v2 (MLA +
MoE with shared experts), against the reference on the same inputs and the
same weights (carried over with ``params_from_jax``), on f32 smoke
configs.

Tolerances: logits, aux losses, layer outputs and cache leaves atol 2e-4 /
rtol 2e-3 (tests/test_decode_consistency.py's own; f32 sums in another
order); the MoE against a per-token float64 loop atol 1e-4 / rtol 1e-3
(tests/test_ssm_moe_attention.py's own). Routing (which expert keeps which
token) must be identical: the port breaks ties as ``jax.lax.top_k`` does.
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
from repro.models import ffn as j_ffn  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro.models.factory import build_model as j_build  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import ffn as t_ffn  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.models.factory import build_model, count_params  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-3)
LOOP_TOL = dict(atol=1e-4, rtol=1e-3)
MOE = ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"]


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
    """The reference's cache growth (launch/serve.py's ``grow``)."""
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


def _no_drops(cfg):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


_MODELS = {}


def _model(arch, capacity=None):
    """(torch cfg, jax cfg, jax params, port params, jitted jax Model) of
    the f32 smoke config; ``capacity="none"``: capacity_factor 8 (no
    token dropped), as tests/test_decode_consistency.py runs it."""
    key = (arch, capacity)
    if key not in _MODELS:
        jcfg = j_registry.smoke_config(arch).replace(dtype="float32")
        tcfg = t_registry.smoke_config(arch).replace(dtype="float32")
        if capacity == "none":
            jcfg, tcfg = _no_drops(jcfg), _no_drops(tcfg)
        jm = j_build(jcfg)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        jit = jm._replace(
            forward=jax.jit(lambda p, b: jm.forward(p, b,
                                                    remat_policy="none")),
            prefill=jax.jit(jm.prefill, static_argnames="kv_dtype"),
            decode=jax.jit(jm.decode))
        _MODELS[key] = (tcfg, jcfg, jp,
                        t_tr.params_from_jax(_np(jp), device="cpu"), jit)
    return _MODELS[key]


def _tokens(arch, b, s, seed=1):
    cfg = t_registry.smoke_config(arch)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", MOE)
def test_moe_configs_and_smoke_configs_equal_the_reference(arch):
    for t_cfg, j_cfg in ((t_registry.get_arch(arch),
                          j_registry.get_arch(arch)),
                         (t_registry.smoke_config(arch),
                          j_registry.smoke_config(arch))):
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
        assert t_cfg.padded_vocab() == j_cfg.padded_vocab()
        assert tuple(t_attn.layout_from_cfg(t_cfg)) == \
            tuple(j_attn.layout_from_cfg(j_cfg))


# ------------------------------------------------------------- the models --
@pytest.mark.parametrize("arch", MOE)
def test_moe_init_tree_matches_reference_and_scales(arch):
    tcfg, _, jp, _, _ = _model(arch)
    mine = build_model(tcfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    g, w = _flat(mine), _flat(_np(jp))
    assert sorted(g) == sorted(w)
    for k in w:
        assert tuple(g[k].shape) == w[k].shape, k
        assert str(g[k].dtype).split(".")[1] == str(w[k].dtype), k
    assert count_params(mine) == sum(x.size for x in jtu.tree_leaves(jp))
    # the stacked experts take each expert's own fan-in: std 1/sqrt(d) for
    # (L, E, d, f) gate weights, 1/sqrt(f) for the (L, E, f, d) down ones
    for name, fan_in in (("w_gate_e", tcfg.d_model),
                         ("w_down_e", tcfg.moe.d_ff_expert)):
        std = g[f"/layers/moe/{name}"].std().item()
        assert abs(std * fan_in ** 0.5 - 1) < 0.1, (name, std)
    assert ("/layers/moe/shared/w_gate" in g) == bool(
        tcfg.moe.num_shared_experts)
    assert ("/layers/attn/w_uk" in g) == (tcfg.mla is not None)


@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_aux_prefill_and_decode_step_match(arch):
    """At the smoke config's own capacity factor (1.25: tokens drop in
    prefill), logits and the aux loss, the cache, then three decode
    steps."""
    tcfg, _, jp, tp, jm = _model(arch)
    tm = build_model(tcfg)
    b, s = 2, 24
    toks = _tokens(arch, b, s + 8)
    jfull, jaux, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tfull, taux, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tfull.numpy(), np.asarray(jfull), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert float(taux) > 0

    jlast, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])},
                               kv_dtype="float32")
    tlast, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])},
                               kv_dtype="float32")
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    _close_trees(tcache, jcache)
    assert ("mla" in tcache) == (tcfg.mla is not None)
    jc, tc = _grow(jcache, 4), t_serve.grow_cache(tcache, 4)
    for i in range(3):
        db = toks[:, s + i:s + i + 1]
        jlg, jc = jm.decode(jp, jc, {"tokens": jnp.asarray(db)})
        tlg, tc = tm.decode(tp, tc, {"tokens": torch.from_numpy(db)})
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
    _close_trees(tc, jc)
    assert tc["pos"].tolist() == [s + 3] * b


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_decode_matches_forward(arch):
    """tests/test_decode_consistency.py's check on the port (capacity 8:
    no token dropped): prefill's last logits and one decode step equal
    forward's at those positions."""
    tcfg, _, _, tp, _ = _model(arch, capacity="none")
    tm = build_model(tcfg)
    b, s = 2, 16
    toks = torch.from_numpy(_tokens(arch, b, s + 1, seed=3))
    full, _, _ = tm.forward(tp, {"tokens": toks})
    last, cache = tm.prefill(tp, {"tokens": toks[:, :s]}, kv_dtype="float32")
    np.testing.assert_allclose(last.numpy(), full[:, s - 1].numpy(), **TOL)
    lg, cache = tm.decode(tp, t_serve.grow_cache(cache, 4),
                          {"tokens": toks[:, s:s + 1]})
    np.testing.assert_allclose(lg.numpy(), full[:, s].numpy(), **TOL)
    assert int(cache["pos"][0]) == s + 1


def _reference_greedy(jm, jp, tokens, gen):
    prefill = jax.jit(lambda p, bt: jm.prefill(p, bt, kv_dtype="float32"))
    decode = jax.jit(lambda p, c, bt: jm.decode(p, c, bt))
    logits, cache = prefill(jp, {"tokens": jnp.asarray(tokens)})
    cache = _grow(cache, gen)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, seen = [tok], [logits]
    for _ in range(gen):
        logits, cache = decode(jp, cache, {"tokens": tok})
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(tok)
        seen.append(logits)
    return (np.asarray(jnp.concatenate(toks, 1)),
            np.stack([np.asarray(x) for x in seen]))


@pytest.mark.parametrize("arch", MOE)
def test_serve_matches_a_reference_greedy_loop(arch):
    """``launch.serve.serve`` (f32 KV) against a jitted greedy loop over
    the reference's prefill and decode_step with the same weights:
    logits within tolerance at every step, greedy tokens identical (a
    reference near-tie is named in the failure, never skipped)."""
    tcfg, _, jp, tp, jm = _model(arch)
    b, s, gen = 2, 24, 5
    prompts = _tokens(arch, b, s, seed=11)
    want_toks, want_logits = _reference_greedy(jm, jp, prompts, gen)
    ops.reset_launch_counts()
    res = t_serve.serve(build_model(tcfg), tp, prompts, gen, "float32",
                        device="cpu")
    assert all(n == 0 for n in ops.LAUNCHES.values())   # plain versions
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    ties = np.argwhere(gap <= 2 * (TOL["atol"]
                                   + TOL["rtol"] * np.abs(top2[..., 1])))
    assert np.array_equal(res.tokens.numpy(), want_toks), (
        f"greedy tokens differ; near-ties (step, row): {ties.tolist()}")
    np.testing.assert_allclose(res.logits.numpy(), want_logits, **TOL)


def test_serve_cli_runs_the_moe_smoke_config_on_the_cpu(capsys):
    res = t_serve.main(["--arch", "deepseek-v2-236b", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "16", "--gen", "2"])
    assert "arch=deepseek-v2-236b params=" in capsys.readouterr().out
    assert tuple(res.tokens.shape) == (2, 3)


# -------------------------------------------------------------------- MoE --
def _moe_cfgs(num_experts=4, top_k=2, shared=0, factor=1.25, d=16):
    """The same small MoE config in both packages."""
    def one(base):
        return base.ArchConfig(
            name="t", family="moe", n_layers=1, d_model=d, n_heads=2,
            n_kv_heads=2, d_ff=32, vocab_size=64, head_dim=8,
            dtype="float32",
            moe=base.MoEConfig(num_experts=num_experts, top_k=top_k,
                               d_ff_expert=32, num_shared_experts=shared,
                               d_ff_shared=16, capacity_factor=factor))
    return one(t_base), one(j_base)


def _moe_case(seed=0, b=2, s=8, **kw):
    tcfg, jcfg = _moe_cfgs(**kw)
    jp = j_ffn.init_moe(jax.random.PRNGKey(seed), jcfg)
    x = (np.random.default_rng(seed).standard_normal(
        (b, s, tcfg.d_model))).astype(np.float32)
    return tcfg, jcfg, jp, t_tr.params_from_jax(_np(jp), device="cpu"), x


@pytest.mark.parametrize("n_groups,shared,factor,top_k,experts", [
    (1, 0, 1.25, 2, 4), (2, 0, 1.25, 2, 4), (1, 2, 1.25, 2, 4),
    (2, 2, 0.5, 2, 4), (1, 0, 0.5, 2, 4), (3, 1, 1.0, 2, 4),
    (1, 0, 0.5, 1, 2)])
def test_apply_moe_matches_reference(n_groups, shared, factor, top_k,
                                     experts):
    """Output and aux loss against the reference's ``apply_moe``: routing
    groups, shared experts, capacity drops (factor 0.5), a group count
    that does not divide the tokens (3 of 16 -> 2), and a top-1 router
    (every routed token's gate is 1.0: the capacity edge is one long tie,
    broken by token index as ``jax.lax.top_k`` breaks it)."""
    tcfg, jcfg, jp, tp, x = _moe_case(shared=shared, factor=factor,
                                      top_k=top_k, num_experts=experts)
    jout, jaux = jax.jit(lambda p, x: j_ffn.apply_moe(p, x, jcfg, n_groups))(
        jp, jnp.asarray(x))
    tout, taux = t_ffn.apply_moe(tp, torch.from_numpy(x), tcfg, n_groups)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    if factor < 1:    # some token lost an expert
        g = t_ffn.moe_groups(16, n_groups)
        r = t_ffn.route(tp, torch.from_numpy(x).reshape(g, 16 // g, -1),
                        tcfg, t_ffn.moe_capacity(16 // g, tcfg))
        assert (r.slot < 0).any()


@pytest.mark.parametrize("tokens,experts,top_k,factor", [
    (t, e, k, f) for t in (1, 7, 16, 100, 4096) for e, k in
    ((4, 2), (16, 2), (160, 6), (2, 1)) for f in (0.5, 1.0, 1.25, 8.0)])
def test_moe_capacity_equals_reference(tokens, experts, top_k, factor):
    tcfg, jcfg = _moe_cfgs(num_experts=experts, top_k=top_k, factor=factor)
    assert t_ffn.moe_capacity(tokens, tcfg) == \
        j_ffn.moe_capacity(tokens, jcfg)


def _per_token_loop(p, x, cfg):
    """Each token through its top-k experts, float64, no capacity
    (tests/test_ssm_moe_attention.py's ``_dense_moe_ref`` on the port's
    weights; the shared experts as a float64 gated MLP)."""
    moe = cfg.moe
    w = {k: v.double().numpy() for k, v in _flat(p).items()}
    xt = x.reshape(-1, x.shape[-1]).astype(np.float64)

    def silu_mlp(v, g, u, dn):
        a, b = v @ g, v @ u
        return (a / (1 + np.exp(-a)) * b) @ dn

    logits = xt @ w["/w_router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(xt)
    for t in range(len(xt)):
        top = np.argsort(-probs[t], kind="stable")[:moe.top_k]
        for e, wi in zip(top, probs[t][top] / probs[t][top].sum()):
            out[t] += wi * silu_mlp(xt[t], w["/w_gate_e"][e],
                                    w["/w_up_e"][e], w["/w_down_e"][e])
    if "/shared/w_gate" in w:
        out += silu_mlp(xt, w["/shared/w_gate"], w["/shared/w_up"],
                        w["/shared/w_down"])
    return out.reshape(x.shape)


@pytest.mark.parametrize("shared,n_groups", [(0, 1), (2, 1), (2, 2)])
def test_apply_moe_equals_a_per_token_loop_without_drops(shared, n_groups):
    tcfg, _, _, tp, x = _moe_case(seed=3, shared=shared, factor=8.0)
    out, aux = t_ffn.apply_moe(tp, torch.from_numpy(x), tcfg, n_groups)
    np.testing.assert_allclose(out.numpy(), _per_token_loop(tp, x, tcfg),
                               **LOOP_TOL)
    assert float(aux) >= 0.99      # the balance loss is >= 1 at balance


@pytest.mark.parametrize("shared", [0, 2])
def test_experts_keep_min_of_routed_and_capacity_and_drops_get_shared(
        shared):
    """At capacity factor 0.5 each expert keeps min(its routed tokens,
    capacity) tokens, those with the largest gates; a token every one of
    its experts dropped gets exactly the shared experts' output (zero
    without shared experts)."""
    tcfg, _, _, tp, x = _moe_case(seed=5, b=2, s=16, shared=shared,
                                  factor=0.5)
    xt = torch.from_numpy(x)
    cap = t_ffn.moe_capacity(32, tcfg)
    r = t_ffn.route(tp, xt.reshape(1, 32, -1), tcfg, cap)
    routed = torch.zeros(4, dtype=torch.long).scatter_add_(
        0, r.topi.reshape(-1), torch.ones(r.topi.numel(), dtype=torch.long))
    kept = (r.sel_gate > 0).sum(-1)[0]
    assert kept.tolist() == torch.clamp(routed, max=cap).tolist()
    assert ((r.slot >= 0).sum() == kept.sum()).item()
    dropped = (r.slot < 0).all(-1)[0]
    assert dropped.any()
    out, _ = t_ffn.apply_moe(tp, xt, tcfg)
    out = out.reshape(32, -1)[dropped]
    want = (t_ffn.apply_mlp(tp["shared"], xt.reshape(1, 32, -1), tcfg)
            [0][dropped] if shared else torch.zeros_like(out))
    assert torch.equal(out, want)


# -------------------------------------------------------------------- MLA --
def _mla_layer():
    tcfg, jcfg, jp, tp, _ = _model("deepseek-v2-236b")
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tl = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    return tcfg, jcfg, jl, tl


def test_mla_projections_full_attention_and_absorbed_decode_match():
    tcfg, jcfg, jl, tl = _mla_layer()
    b, s = 2, 12
    x = (np.random.default_rng(7).standard_normal((b, s, tcfg.d_model))
         * 0.5).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None].repeat(b, 0)
    jc, js = j_tr._make_rope(jcfg, jnp.asarray(pos))
    tc, ts = t_tr._make_rope(tcfg, torch.from_numpy(pos))
    assert tc.shape[-1] == tcfg.mla.qk_rope_head_dim // 2
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for fn in ("mla_q", "mla_latent_kv"):
        got = getattr(t_attn, fn)(tl, tx, tcfg, tc, ts)
        want = getattr(j_attn, fn)(jl, jx, jcfg, jc, js)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    tout, (tckv, tkr) = t_attn.mla_attention_full(tl, tx, tcfg, tc, ts)
    jout, (jckv, jkr) = j_attn.mla_attention_full(jl, jx, jcfg, jc, js)
    for g, w in ((tout, jout), (tckv, jckv), (tkr, jkr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the absorbed decode of the last token over the latent cache of all
    # s tokens (ragged valid lengths), and against the full path's row
    valid = np.arange(s)[None] <= np.array([[s - 1], [6]])
    got = t_attn.mla_attention_decode(
        tl, tx[:, -1:], tcfg, tc[:, -1:], ts[:, -1:], tckv, tkr,
        torch.from_numpy(valid))
    want = j_attn.mla_attention_decode(
        jl, jx[:, -1:], jcfg, jc[:, -1:], js[:, -1:], jckv, jkr,
        jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got[0, 0].numpy(), tout[0, -1].numpy(), **TOL)


@pytest.mark.parametrize("kv", ["bfloat16", "float32", "int8"])
def test_mla_init_cache_matches_reference(kv):
    """``init_mla_kv`` / ``init_cache``: the latent cache is bf16 when
    int8 is asked, as in the reference; an int8 prefill keeps bf16 too."""
    tcfg, jcfg, jp, tp, jm = _model("deepseek-v2-236b")
    from repro.serve import kvcache as j_kv
    from repro_torch.serve import kvcache as t_kv
    _close_trees(t_kv.init_mla_kv(tcfg, 3, 10, kv, device="cpu"),
                 j_kv.init_mla_kv(jcfg, 3, 10, kv))
    _close_trees(build_model(tcfg).init_cache(3, 10, kv, device="cpu"),
                 j_build(jcfg).init_cache(3, 10, kv))
    toks = _tokens("deepseek-v2-236b", 2, 8)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, kv_dtype=kv)
    _, tc = build_model(tcfg).prefill(tp, {"tokens": torch.from_numpy(toks)},
                                      kv_dtype=kv)
    g, w = _flat(tc), _flat(_np(jc))
    assert {k: str(v.dtype).split(".")[1] for k, v in g.items()} == \
        {k: v.dtype.name for k, v in w.items()}


@pytest.mark.parametrize("causal,gp", [(True, 1), (False, 1), (True, 2)])
def test_sdpa_with_v_heads_of_another_width_matches_reference(causal, gp):
    rng = np.random.default_rng(gp + 2 * causal)
    b, s, kh, dh, dv = 2, 10, 2, 24, 16
    q = rng.standard_normal((b, s, kh * gp, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, dv)).astype(np.float32)
    got = t_attn.sdpa(*map(torch.from_numpy, (q, k, v)), causal=causal,
                      gp=gp)
    want = j_attn.sdpa(*map(jnp.asarray, (q, k, v)), causal=causal, gp=gp)
    assert tuple(got.shape) == (b, s, kh * gp, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
