"""The port's system initialization end to end on the CPU
(core/pipeline.initialize_system with ``device="cpu"``): the mirror of
tests/test_system.py, on its corpus, splits, grid and steps, with the
end-to-end query through the port's core/query.run_query.

Inference costs are pinned (each model's ``cnn_flops`` at 1 GFLOP/s),
so no result here depends on this machine's clock.

Whole training is held to the reference behaviourally, not parameter
for parameter (tests/test_torch_train.py says why): the same splits
through the reference's ``initialize_system`` give eval accuracies with
bank means 0.6607 (reference) and 0.6962 (port), best models 0.9714
and 1.0000, and trusted models 0.9714 and 0.9905, measured on the CPU;
the test allows each of mean and best twice its gap, and at least 0.05.

Also runs examples/quickstart_torch.py at its tiny size on the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import TahomaCNNConfig as JCfg  # noqa: E402
from repro.core.pipeline import initialize_system as jinit  # noqa: E402
from repro.core.transforms import representation_space as jreps  # noqa
from repro_torch.configs.base import TahomaCNNConfig  # noqa: E402
from repro_torch.core.alc import best_matching  # noqa: E402
from repro_torch.core.cascade import spec_levels  # noqa: E402
from repro_torch.core.pipeline import initialize_system  # noqa: E402
from repro_torch.core.query import (BinaryPredicate, Corpus,  # noqa: E402
                                    run_query)
from repro_torch.core.selector import pareto_set, select  # noqa: E402
from repro_torch.core.transforms import (apply_transform,  # noqa: E402
                                         representation_space)
from repro_torch.data.synthetic import (DEFAULT_PREDICATES,  # noqa: E402
                                        make_corpus, three_way_split)
from repro_torch.models.cnn import cnn_flops, cnn_predict_proba  # noqa

ROOT = Path(__file__).resolve().parents[1]
ARCHS = [(1, 8, 16), (2, 16, 16)]
RESOLUTIONS, COLORS = [8, 16, 32], ("rgb", "g", "gray")
STEPS = 150
# bank-mean and best eval accuracy, reference vs port, on these splits
# (measured on the CPU; the module docstring)
MEASURED = {"mean": (0.6607, 0.6962), "best": (0.9714, 1.0000)}


def _flops_costs(reps, base_hw):
    """{entry name: s/image}, each model's FLOPs at 1 GFLOP/s, for the
    names ``train_model_grid`` gives."""
    out = {}
    for a in ARCHS:
        for rep in reps:
            c = TahomaCNNConfig(*a, input_hw=rep.resolution,
                                input_channels=rep.channels)
            out[f"{c.arch_id}_{rep.name}"] = cnn_flops(c) / 1e9
    t = TahomaCNNConfig(3, 48, 64, input_hw=base_hw, input_channels=3)
    out[f"trusted_{t.arch_id}"] = cnn_flops(t) / 1e9
    return out


@pytest.fixture(scope="module")
def system():
    spec = DEFAULT_PREDICATES[1]  # ferret: needs resolution, gray-friendly
    x, y = make_corpus(spec, 420, hw=32, seed=0)
    splits = three_way_split(x, y, seed=1)
    reps = representation_space(RESOLUTIONS, COLORS)
    # one intra-op thread: these models are tiny, and beside the suite's
    # other workers torch's one thread per core oversubscribes the CPU
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sys_ = initialize_system(*splits,
                                 [TahomaCNNConfig(*a) for a in ARCHS], reps,
                                 steps=STEPS, infer_s=_flops_costs(reps, 32),
                                 device="cpu")
    finally:
        torch.set_num_threads(threads)
    return sys_, splits, spec


def _accuracies(scores, truth):
    return ((np.asarray(scores) >= 0.5) == np.asarray(truth)[None]).mean(1)


# -------------------------------------------- tests/test_system.py mirror --
def test_models_learn(system):
    sys_, splits, spec = system
    accs = _accuracies(sys_.eval_scores, sys_.eval_truth)
    assert accs.max() > 0.85, accs.max()
    # trusted model is competitive
    assert accs[sys_.bank.trusted_index] > 0.8


def test_pareto_and_selection(system):
    sys_, _, _ = system
    space = sys_.cascade_space("CAMERA")
    par = pareto_set(space)
    assert 1 <= len(par) <= 200
    sel = select(space, min_accuracy=0.8)
    assert sel.accuracy >= 0.8
    # fastest-qualifying semantics: no Pareto point with acc>=0.8 is faster
    for i in par:
        if space.acc[i] >= 0.8:
            assert space.throughput[i] <= sel.throughput + 1e-9


def test_cascades_beat_trusted_model(system):
    """Paper Fig. 6: at the trusted model's accuracy, an optimal cascade is
    faster than the trusted model alone (INFER_ONLY)."""
    sys_, _, _ = system
    space = sys_.cascade_space("INFER_ONLY")
    ti = sys_.bank.trusted_index
    t_acc = space.acc[ti]
    t_thr = space.throughput[ti]
    j = best_matching(space.acc, space.throughput, t_acc)
    assert j is not None
    assert space.throughput[j] > t_thr  # strictly faster at >= accuracy


def test_scenario_awareness_never_hurts(system):
    """Table III's property: cascades chosen with scenario-aware costs give
    >= throughput than cascades chosen obliviously then deployed in the
    scenario."""
    sys_, _, _ = system
    oblivious = sys_.cascade_space("INFER_ONLY")
    for scen in ("CAMERA", "ARCHIVE", "ONGOING"):
        aware = sys_.cascade_space(scen)
        for floor in (0.75, 0.85):
            if aware.acc.max() < floor:
                continue
            aw = select(aware, min_accuracy=floor)
            ob = select(oblivious, min_accuracy=floor)
            # deploy the obliviously-chosen cascade under the true scenario
            ob_true_thr = aware.throughput[ob.index]
            assert aw.throughput >= ob_true_thr - 1e-9


def test_end_to_end_query(system):
    sys_, splits, spec = system
    (_, _), (_, _), (ev_x, ev_y) = splits
    space = sys_.cascade_space("CAMERA")
    sel = select(space, min_accuracy=0.85) if space.acc.max() >= 0.85 \
        else select(space)
    levels = spec_levels(space, sel.index, sys_.p_low, sys_.p_high)

    @torch.no_grad()
    def executor(imgs):
        x = torch.as_tensor(imgs)
        out = np.full(len(imgs), -1, np.int32)
        active = np.ones(len(imgs), bool)
        for m, lo, hi in levels:
            e = sys_.bank.entries[m]
            scores = cnn_predict_proba(e.params,
                                       apply_transform(x, e.rep)).numpy()
            if lo is None:
                out[active] = (scores >= 0.5)[active]
                active[:] = False
            else:
                dec = active & ((scores <= lo) | (scores >= hi))
                out[dec] = (scores >= hi)[dec]
                active &= ~dec
        return out

    corpus = Corpus(images=ev_x,
                    metadata={"cam": np.arange(len(ev_x)) % 3})
    ids = run_query(corpus, metadata_eq={"cam": 0},
                    binary_preds=[BinaryPredicate(spec.name, executor)])
    # query respects metadata filter
    assert all(i % 3 == 0 for i in ids)
    # and the returned set is mostly true positives
    if len(ids):
        assert ev_y[ids].mean() > 0.7


# ------------------------------------------------- against the reference --
def test_the_bank_learns_as_the_reference_does(system):
    sys_, splits, _ = system
    ref = jinit(*splits, [JCfg(*a) for a in ARCHS],
                jreps(RESOLUTIONS, COLORS), steps=STEPS)
    assert sys_.bank.names == ref.bank.names
    assert sys_.bank.trusted_index == ref.bank.trusted_index
    np.testing.assert_array_equal(sys_.eval_truth, ref.eval_truth)
    port = _accuracies(sys_.eval_scores, sys_.eval_truth)
    want = _accuracies(ref.eval_scores, ref.eval_truth)
    for name, stat in (("mean", np.mean), ("best", np.max)):
        ref_m, port_m = MEASURED[name]
        margin = max(0.05, 2 * abs(ref_m - port_m))
        assert abs(stat(port) - stat(want)) <= margin, \
            (name, stat(port), stat(want))


def test_quickstart_twin_runs_on_the_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "examples/quickstart_torch.py", "--tiny",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Pareto frontier" in out.stdout
    assert "precision vs ground truth" in out.stdout
