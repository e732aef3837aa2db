"""The benchmark's arithmetic: FLOPs, bytes, percentiles, idle shares."""
from types import SimpleNamespace

import numpy as np
import pytest

from bench import spec, yardstick
from bench.trace import Trace


def test_cnn_flops_by_hand():
    # the trusted 224 px model: three 3x3 convolutions, 48 wide, dense 64
    want = (2 * 224 * 224 * 9 * 3 * 48 + 2 * 112 * 112 * 9 * 48 * 48
            + 2 * 56 * 56 * 9 * 48 * 48 + 2 * 28 * 28 * 48 * 64 + 2 * 64)
    assert yardstick.cnn_flops((3, 48, 64), 224, 3) == want
    assert want == pytest.approx(0.785e9, rel=0.01)
    assert yardstick.cnn_weight_count((1, 16, 32), 28, 1) == \
        9 * 16 + 16 + 14 * 14 * 16 * 32 + 32 + 32 + 1


def test_stage0_bound_of_the_main_path_chunk():
    # 256 frames of 224 px, the 28 px level handed on, stage-0 model
    # cnn_l1_c16_d32 at 28 px blue: bound by bytes at 0.0469 ms
    nbytes, ops = yardstick.stage0_work(256, 224, [28],
                                        ((1, 16, 32), 28, "b"))
    pk = yardstick.peaks("NVIDIA H100 80GB HBM3")
    assert nbytes == (256 * 224 * 224 * 3 * 4 + 100577 * 4 + 256 * 4
                      + 256 * 28 * 28 * 3 * 4)
    assert ops == 256 * (224 * 224 * 3 + 5 * 28 * 28
                         + yardstick.cnn_flops((1, 16, 32), 28, 1))
    assert yardstick.bound_s(nbytes, ops, pk) * 1e3 == pytest.approx(
        0.0469, abs=5e-5)
    assert yardstick.peaks("NVIDIA H100 PCIe").hbm_bw == 2.0e12
    assert yardstick.peaks("cpu") is None


def test_percentile():
    xs = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 8.0]
    for q in (0, 50, 95, 100):
        assert yardstick.percentile(xs, q) == pytest.approx(
            np.percentile(xs, q))


def test_busy_union_and_idle_gaps():
    assert yardstick.busy_union([(0, 2), (1, 3), (5, 6)]) == 4
    assert yardstick.busy_union([(0, 2), (1, 3), (5, 6)], 1, 5.5) == 2.5
    tr = Trace(kernels=[(10, 20, "k1"), (15, 30, "ps0_pool_kernel"),
                        (50, 60, "k1")],
               spans=[(0, 40), (40, 100)],
               host=[(30, 50, "aten::nonzero"), (70, 90, "cudaMemcpy")])
    assert tr.window_s == 100e-9
    assert tr.busy_s == pytest.approx(30e-9)
    assert tr.idle_gaps() == [(0, 10), (30, 50), (60, 100)]
    gaps = dict(tr.gaps_by_host())
    assert gaps["aten::nonzero"] == pytest.approx(20e-9)
    assert gaps["python inside a query"] == pytest.approx(10e-9)
    assert gaps["cudaMemcpy"] == pytest.approx(40e-9)
    assert tr.time_by_name()["k1"] == [2, pytest.approx(20e-9)]


def fake_run(kernels, spans, rows=1000):
    cfg = {"base": 224, "chunk": 256, "predicates": [
        {"levels": [{"arch": [1, 16, 32], "res": 28, "color": "b"}]},
        {"levels": [{"arch": [1, 16, 32], "res": 28, "color": "g"}]}]}
    tr = Trace(kernels=kernels, spans=spans, rows_scanned=rows)
    q = SimpleNamespace(cam=0, ms=10.0, rows_scanned=rows,
                        rows_evaluated=rows * 3 // 2)
    return SimpleNamespace(trace=tr, queries=[q], window_s=1.0, setup_s=1.0,
                           device_kind="NVIDIA H100 80GB HBM3",
                           data={"config": cfg, "reach": {0: [[rows], [0]]}})


def test_readers_on_a_made_up_trace():
    pk = yardstick.peaks("NVIDIA H100 80GB HBM3")
    nbytes, ops = yardstick.stage0_work(256, 224, [28],
                                        ((1, 16, 32), 28, "b"))
    t = yardstick.bound_s(nbytes, ops, pk) * 2e9       # half the roofline
    run = fake_run([(0, t / 2, "ps0_pool_kernel"), (t / 2, t, "ps0_cnn"),
                    (t, t + 1e6, "sm90_xmma_fprop_implicit_gemm")],
                   [(0, 4e6)])

    def read(name):
        return spec.module("metrics", name).read(run)
    assert read("fused_pyramid_stage0_roofline") == pytest.approx(50.0)
    assert read("scan.device_idle") == pytest.approx(
        100 * (1 - (t + 1e6) / 4e6))
    assert read("scan.host_exposed_ms") == pytest.approx(
        4.0 - (t + 1e6) / 1e6)
    assert read("levels.device_ms_per_krow") == pytest.approx(1.0)
    assert read("scan.rows_evaluated_per_row") == 1.5
    flops = 1000 * yardstick.cnn_flops((1, 16, 32), 28, 1)
    assert read("scan_mfu") == pytest.approx(100 * max(
        flops / pk.f32_flops, 1000 * 224 * 224 * 12 / pk.hbm_bw))
    assert read("scan_rows_per_s") == 1000.0
    run.trace = None
    assert read("scan.device_idle") is None
    assert read("fused_pyramid_stage0_roofline") is None
