"""The port's LM serving modules (src/repro_torch/serve/{speculative,
continuous_batching}, src/repro_torch/core/lm_cascade) vs the reference's
on the reference tests' smoke pairs (f32 deepseek-7b as the trusted
model, minitron-4b as the draft or the cheap level), the same weights
carried over with ``params_from_jax``, and the same prompts.

Greedy tokens are held equal token for token; scores and logits within
atol 2e-4 / rtol 2e-3 (tests/test_decode_consistency.py's tolerance);
calibrated thresholds, cascade labels and levels, engine steps and slot
occupancy equal. The cascade's levels are untrained (the reference's
training steps are too slow for this suite): the calibration truth is
drawn from the cheap level's own scores with noise, so that Algorithm 1
finds thresholds that route some rows early.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import smoke_config as j_smoke  # noqa: E402
from repro.core import lm_cascade as j_lmc  # noqa: E402
from repro.models.factory import build_model as j_build  # noqa: E402
from repro.serve import continuous_batching as j_cb  # noqa: E402
from repro.serve import speculative as j_spec  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.core import lm_cascade as t_lmc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.serve import continuous_batching as t_cb  # noqa: E402
from repro_torch.serve import speculative as t_spec  # noqa: E402

ATOL, RTOL = 2e-4, 2e-3
YES, NO = 7, 13


def _pair(arch, seed, **replace):
    """(reference Model, its params, port Model, the same params)."""
    jcfg = j_smoke(arch).replace(dtype="float32", **replace)
    jm = j_build(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = build_model(smoke_config(arch).replace(dtype="float32", **replace))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


@pytest.fixture(scope="module")
def models():
    """tests/test_speculative.py's pair: deepseek-7b seed 0 as the
    target, minitron-4b seed 1 with the target's vocabulary as the
    draft."""
    target = _pair("deepseek-7b", 0)
    draft = _pair("minitron-4b", 1,
                  vocab_size=j_smoke("deepseek-7b").vocab_size)
    return target, draft


def test_generate_greedy_matches_reference(models):
    (jm, jp, tm, tp), _ = models
    prompt = np.array([5, 9, 2, 17, 33, 8], np.int32)
    want = j_spec.generate_greedy(jm, jp, prompt, 12)
    got = t_spec.generate_greedy(tm, tp, prompt, 12, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_speculative_equals_target_greedy_with_the_reference_stats(models):
    (jm, jp, tm, tp), (jdm, jdp, tdm, tdp) = models
    prompt = np.array([5, 9, 2, 17, 33, 8], np.int32)
    ops.reset_launch_counts()
    out, stats = t_spec.generate_speculative(tdm, tdp, tm, tp, prompt,
                                             n_tokens=12, gamma=3,
                                             device="cpu")
    assert all(n == 0 for n in ops.LAUNCHES.values())   # plain versions
    np.testing.assert_array_equal(
        out, t_spec.generate_greedy(tm, tp, prompt, 12, device="cpu"))
    jout, jstats = j_spec.generate_speculative(jdm, jdp, jm, jp, prompt,
                                               n_tokens=12, gamma=3)
    np.testing.assert_array_equal(out, jout)
    assert vars(stats) == vars(jstats) and stats.proposed > 0
    assert stats.acceptance_rate == jstats.acceptance_rate


def test_speculative_self_draft_accepts_everything(models):
    (jm, jp, tm, tp), _ = models
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    out, stats = t_spec.generate_speculative(tm, tp, tm, tp, prompt,
                                             n_tokens=8, gamma=4,
                                             device="cpu")
    np.testing.assert_array_equal(
        out, t_spec.generate_greedy(tm, tp, prompt, 8, device="cpu"))
    assert stats.acceptance_rate == 1.0
    assert stats.target_calls <= 1 + 8 // 4
    _, jstats = j_spec.generate_speculative(jm, jp, jm, jp, prompt,
                                            n_tokens=8, gamma=4)
    assert vars(stats) == vars(jstats)


def test_speculative_refuses_a_draft_with_a_larger_vocabulary(models):
    (_, _, tm, tp), _ = models
    big = build_model(smoke_config("minitron-4b").replace(
        dtype="float32", vocab_size=1000))
    bp = big.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="embedding table"):
        t_spec.generate_speculative(big, bp, tm, tp, np.array([1, 2]), 4,
                                    device="cpu")


def _requests(cls, cfg, lengths, budgets, seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]
    return [cls(i, p, b) for i, (p, b) in enumerate(zip(prompts, budgets))]


@pytest.mark.parametrize("slots,cap,lengths,budgets,seed", [
    (2, 24, (5, 8, 6, 9, 7), (4, 3, 5, 2, 4), 0),     # the reference test's
    (2, 16, (6,) * 6, (3,) * 6, 1),                   # its refill test's
    (3, 20, (4, 11, 7, 9, 5, 12, 3), (6, 2, 8, 1, 5, 3, 7), 2)])
def test_continuous_batcher_matches_reference_and_sequential_greedy(
        models, slots, cap, lengths, budgets, seed):
    (jm, jp, tm, tp), _ = models
    cfg = tm.cfg
    jreqs = _requests(j_cb.GenRequest, cfg, lengths, budgets, seed)
    treqs = _requests(t_cb.GenRequest, cfg, lengths, budgets, seed)
    jeng = j_cb.ContinuousBatcher(jm, jp, n_slots=slots, capacity=cap)
    teng = t_cb.ContinuousBatcher(tm, tp, n_slots=slots, capacity=cap,
                                  device="cpu")
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jst, tst = jeng.run_to_completion(), teng.run_to_completion()
    assert tst.finished == jst.finished == len(treqs)
    assert tst.steps == jst.steps
    np.testing.assert_array_equal(tst.slot_occupancy, jst.slot_occupancy)
    assert tst.mean_occupancy == pytest.approx(jst.mean_occupancy)
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.out == [int(t) for t in jr.out], tr.rid
        np.testing.assert_array_equal(
            tr.out, t_spec.generate_greedy(tm, tp, tr.prompt, tr.max_new,
                                           device="cpu"), err_msg=tr.rid)
    if seed == 1:   # 6 requests x 3 tokens on 2 slots: ~9 full steps
        assert tst.steps <= 12 and tst.mean_occupancy > 0.9


def test_continuous_batcher_splices_in_place_and_idles_at_position_0(
        models):
    (_, _, tm, tp), _ = models
    eng = t_cb.ContinuousBatcher(tm, tp, n_slots=2, capacity=12,
                                 device="cpu")
    k = eng.cache["kv"]["k"]
    k.fill_(7.0)                                    # stale rows
    req = t_cb.GenRequest(0, np.arange(1, 6, dtype=np.int32), 2)
    eng.submit(req)
    eng._refill()
    _, one = tm.prefill(tp, {"tokens": torch.arange(1, 6)[None]})
    assert eng.cache["kv"]["k"] is k                # the same storage
    assert torch.equal(k[:, 0, :5], one["kv"]["k"][:, 0])
    assert not k[:, 0, 5:].any()                    # zeros past the prompt
    assert (k[:, 1] == 7.0).all()                   # the other slot as it was
    assert eng.cache["pos"].tolist() == [5, 0]
    eng.step()
    assert eng.cache["pos"].tolist() == [6, 0]      # slot 1 idles at 0
    eng.run_to_completion()
    assert req.done and eng.cache["pos"].tolist() == [0, 0]
    for _ in range(30):                             # idle far past capacity
        eng.submit(t_cb.GenRequest(1, np.array([3], np.int32), 1))
        eng.run_to_completion()
    assert int(eng.cache["pos"].max()) == 0


@pytest.fixture(scope="module")
def cascade(models):
    """An untrained cheap level (minitron-4b, 12-token context) and
    trusted level (deepseek-7b) in both packages, the reference test's
    task, and calibration truth drawn from the cheap level's scores."""
    (jm, jp, tm, tp), _ = models
    jsm, jsp, tsm, tsp = _pair("minitron-4b", 2)
    vocab = j_smoke("deepseek-7b").vocab_size
    rng = np.random.default_rng(0)
    toks = rng.integers(0, vocab, (160, 24)).astype(np.int32)
    toks[toks == YES] = YES + 1
    jl = [j_lmc.LMLevel(jsm, jsp, YES, NO, max_context=12),
          j_lmc.LMLevel(jm, jp, YES, NO)]
    tl = [t_lmc.LMLevel(tsm, tsp, YES, NO, max_context=12),
          t_lmc.LMLevel(tm, tp, YES, NO)]
    s0 = j_lmc.lm_predicate_score(jl[0], toks[:80])
    truth = (s0 + rng.normal(0, 0.05, 80) > np.median(s0)).astype(np.int32)
    return jl, tl, toks, truth


def test_lm_predicate_scores_match_reference(cascade):
    jl, tl, toks, _ = cascade
    for j, t in zip(jl, tl):
        got = t_lmc.lm_predicate_score(t, toks, device="cpu")
        assert got.dtype == np.float32 and got.shape == (len(toks),)
        np.testing.assert_allclose(got, j_lmc.lm_predicate_score(j, toks),
                                   atol=ATOL, rtol=RTOL)


def test_calibrate_and_run_lm_cascade_match_reference(cascade):
    jl, tl, toks, truth = cascade
    j_lmc.calibrate(jl, toks[:80], truth, prec_target=0.8)
    t_lmc.calibrate(tl, toks[:80], truth, prec_target=0.8, device="cpu")
    assert (tl[0].p_low, tl[0].p_high) == (jl[0].p_low, jl[0].p_high)
    assert tl[1].p_low is None and tl[1].p_high is None
    assert 0.0 < tl[0].p_low < tl[0].p_high < 1.0
    ev = toks[80:]
    # no eval score sits within the tolerance of a threshold
    s0 = t_lmc.lm_predicate_score(tl[0], ev, device="cpu")
    assert np.abs(s0[:, None] - np.array([tl[0].p_low, tl[0].p_high])
                  ).min() > ATOL + RTOL
    labels, used = t_lmc.run_lm_cascade(tl, ev, device="cpu")
    jlabels, jused = j_lmc.run_lm_cascade(jl, ev)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(used, jused)
    assert 0 < (used == 0).sum() < len(ev)        # some rows exit early
    early = used == 0
    assert np.all((s0[early] <= tl[0].p_low) | (s0[early] >= tl[0].p_high))
    for cost in ([1.0, 10.0], [0.25, 30.0]):
        assert t_lmc.expected_cost(tl, used, cost) == \
            j_lmc.expected_cost(jl, jused, cost)


def test_lm_serving_entry_points_default_to_cuda_and_raise_without_a_card(
        models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    (_, _, tm, tp), _ = models
    prompt = np.array([1, 2, 3], np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_spec.generate_greedy(tm, tp, prompt, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_spec.generate_speculative(tm, tp, tm, tp, prompt, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cb.ContinuousBatcher(tm, tp, n_slots=2, capacity=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_lmc.lm_predicate_score(t_lmc.LMLevel(tm, tp, YES, NO),
                                 prompt[None])


def test_lm_cascade_example_trains_both_levels_on_the_cpu(capsys):
    """examples/lm_cascade_torch.py: both smoke levels trained by the
    port's AdamW through the model's forward; the trusted level learns the
    task (tests/test_lm_cascade.py's floor) and the cascade runs."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "lm_cascade_torch.py"
    spec = importlib.util.spec_from_file_location("lm_cascade_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    acc, acc_trusted, used = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "calibrated thresholds" in out and "expected cost" in out
    assert acc_trusted > 0.8 and acc > 0.6, (acc, acc_trusted)
    assert used.shape == (80,) and set(used.tolist()) <= {0, 1}
