"""Where the benchmark finds each piece, by the names in BENCHMARK.json:

* a cell (``workloads`` entry) names its configuration and its traffic;
* a configuration's file is the ``file`` its ``configs`` entry gives;
* a traffic mix is ``bench/traffic/<traffic>.json``, and names the loop
  that drives it, ``bench/loops/<loop>.py``;
* a metric is read by ``bench/metrics/<metric name>.py``.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bm: dict, workload: str, root: Path = ROOT) -> dict:
    """{"workload", "config", "traffic", "chips", "metrics": the cell's
    end-to-end metric entries, "per_layer": its per-layer entries}."""
    wl = {w["name"]: w for w in bm["workloads"]}.get(workload)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cf = {c["name"]: c for c in bm["configs"]}[wl["config"]]

    def here(m):
        return "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in bm["end_to_end"] if here(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bm["per_layer"]
             if m["moves"] in names and here(m)]
    return {"workload": workload, "chips": int(wl["chips"]),
            "config": json.loads((root / cf["file"]).read_text()),
            "traffic": json.loads((BENCH / "traffic"
                                   / f"{wl['traffic']}.json").read_text()),
            "metrics": e2e, "per_layer": layer}


def module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` loaded as a module (metric names hold
    dots, so they are loaded by path)."""
    key = f"bench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, BENCH / kind / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]
