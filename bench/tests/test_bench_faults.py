"""A whole run on the CPU at a tiny size, without the look for a card:
sound, it is correct; with the timed path broken underneath, it is not;
with the JAX package loaded, it prints no result."""
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

from bench import harness, spec

TINY = json.loads((Path(__file__).parent / "tiny.json").read_text())


@pytest.fixture(autouse=True)
def without_jax(monkeypatch):
    """The run's guard reads the whole process: hide the JAX modules that
    other test files of this process loaded."""
    for name in harness.forbidden_modules():
        monkeypatch.delitem(sys.modules, name)


def tiny_cell():
    cell = spec.cell(spec.load_benchmark(), "scan3.cold")
    cell["config"] = TINY
    cell["traffic"] = dict(cell["traffic"], trace_queries=4)
    return cell


def run_tiny(trace=False, system=None):
    return harness.execute(tiny_cell(), seed=2 ** 31 + 3, seconds=0.3,
                           trace=trace, device="cpu", t_start=time.time(),
                           system=system)


def break_execute(monkeypatch, fault):
    from repro_torch.engine import scan
    real = scan.ScanEngine.execute

    def execute(self, cascades, metadata_eq=None, **kw):
        return fault(self, real, cascades, metadata_eq, **kw)
    monkeypatch.setattr(scan.ScanEngine, "execute", execute)


def half_the_rows(self, real, cascades, metadata_eq, **kw):
    ids = np.flatnonzero(self.metadata_mask(metadata_eq))
    return self.scan_rows(cascades, ids[: len(ids) // 2], **kw)


def filter_unchanged(self, real, cascades, metadata_eq, **kw):
    return real(self, [], metadata_eq, **kw)


def one_answer_altered(self, real, cascades, metadata_eq, **kw):
    res = real(self, cascades, metadata_eq, **kw)
    ids = np.flatnonzero(self.metadata_mask(metadata_eq))
    extra = np.setdiff1d(ids, res.indices)[:1]
    res.indices = np.sort(np.concatenate([res.indices, extra]))
    return res


def raises(self, real, cascades, metadata_eq, **kw):
    raise RuntimeError("planted")


def test_a_sound_run_is_correct():
    code, result, lines = run_tiny()
    assert code == 0 and result["correct"] is True
    assert result["failed"] == 0
    assert result["attempted"] >= TINY["recordings"]
    assert list(result)[-1] == "checks"
    assert lines[-2].startswith("check wrong_rows: 0 ")
    assert lines[-1] == "check failed_queries: 0 (limit 0)"
    assert set(result["metrics"]) == {"scan_rows_per_s", "query_p95_ms",
                                      "setup_s"}


@pytest.mark.parametrize("fault", [half_the_rows, filter_unchanged,
                                   one_answer_altered])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    break_execute(monkeypatch, fault)
    code, result, _ = run_tiny()
    assert code == 0 and result["correct"] is False
    assert result["failed"] == 0          # every query answered, wrongly
    assert result["checks"]["wrong_rows"]["value"] > \
        result["checks"]["wrong_rows"]["limit"]


def test_a_query_that_raises_is_failed_and_not_correct(monkeypatch):
    break_execute(monkeypatch, raises)
    code, result, lines = run_tiny()
    assert code == 0 and result["correct"] is False
    assert result["failed"] == result["attempted"] >= TINY["recordings"]
    assert result["checks"]["failed_queries"] == {
        "value": result["failed"], "limit": 0}
    assert any("RuntimeError: planted" in ln for ln in lines)


def test_the_reference_in_the_programs_place_runs_the_same_comparison():
    from bench.control import Reference
    code, result, _ = run_tiny(system=Reference(TINY["reference_block"],
                                                "f32"))
    assert code == 0 and result["correct"] is True
    assert result["checks"]["wrong_rows"]["value"] == 0


def test_a_traced_run_reports_per_layer_metrics_only():
    code, result, _ = run_tiny(trace=True)
    assert code == 0 and result["correct"] is True
    assert set(result["metrics"]) <= {
        m["name"] for m in spec.load_benchmark()["per_layer"]}


def test_the_jax_package_loaded_gives_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    code, result, lines = run_tiny()
    assert code != 0 and result is None
    assert "repro" in lines[0]
