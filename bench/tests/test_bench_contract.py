"""BENCHMARK.json against its format's rules: names,
units, keys, files, and a reader for every metric."""
import json
import re

import pytest

from bench import spec

BM = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|per_tok)")


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BM["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in BM["paths"])
    assert len(BM["command"]) <= 32 and all(line(w) for w in BM["command"])
    assert 1 <= BM["run_seconds"] <= 51 and isinstance(BM["run_seconds"],
                                                        int)
    assert len(json.dumps(BM)) <= 64 * 1024


def test_configs():
    assert 1 <= len(BM["configs"]) <= 24
    files = [c["file"] for c in BM["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BM["workloads"]}
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BM["paths"])
        assert (spec.ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
    sources = [c["source"] for c in BM["configs"]]
    assert len(set(sources)) == len(sources)


def test_workloads():
    assert 1 <= len(BM["workloads"]) <= 24
    pairs = {(w["config"], w["traffic"]) for w in BM["workloads"]}
    assert len(pairs) == len(BM["workloads"])
    four = sum(w["chips"] == 4 for w in BM["workloads"])
    assert four <= max(1, len(BM["workloads"]) // 4)
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        traffic = spec.cell(BM, w["name"])["traffic"]
        assert (spec.BENCH / "loops" / f"{traffic['loop']}.py").is_file()


def test_metrics():
    e2e, layer = BM["end_to_end"], BM["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    assert "setup_s" in names
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {x["name"] for x in e2e} and line(m["layer"])
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (spec.BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert callable(spec.module("metrics", m["name"]).read)


@pytest.mark.parametrize("w", [w["name"] for w in BM["workloads"]])
def test_every_cell_reports_setup_another_metric_and_a_layer(w):
    cell = spec.cell(BM, w)
    names = {m["name"] for m in cell["metrics"]}
    assert "setup_s" in names and len(names) >= 2
    assert cell["per_layer"]


def test_files_under_paths_are_named_from_name_characters():
    for p in BM["paths"]:
        for f in (spec.ROOT / p).rglob("*"):
            if f.is_file() and "__pycache__" not in f.parts \
                    and not {"out", ".cache"} & set(f.parts):
                rel = f.relative_to(spec.ROOT).as_posix()
                assert PATH.match(rel), rel
