"""The fleet tooling's process-level pieces on the CPU:

* ``train/pipeline_parallel.pipeline_forward`` on four gloo ranks, a
  (pod 2, data 2) mesh, spawned once with ``torch.multiprocessing`` (as
  tests/test_torch_train_distributed.py): every rank's outputs within
  1e-6 of the stack run without a pipeline and of the reference's
  ``pipeline_forward`` on four forced host devices at the same numpy
  inputs (tests/test_distributed.py::test_pipeline_parallel_exact's
  bound), for 4 micro-batches and for 1 (fewer than the stages); the
  P2P receives and the final all-reduce counted by ``costing.OpCounter``;
* ``launch/devsim.force_host_devices``: the first setting wins,
  ``when_flag`` in both spellings, and ``mesh.shard_devices(None)`` on
  the CPU;
* ``launch/hw``: an unknown card raises, and ``chip_smoke.py`` keeps no
  peak table of its own.
"""
import os
import pickle
import re
import socket
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_subprocess_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD, STAGES, N_MICRO, MB, D = 4, 2, 4, 8, 16


def _inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((STAGES, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    return w, x


def _stage_fn(w, h):
    return torch.tanh(h @ w)


def _worker(rank, port, tmp):
    import torch.distributed as dist

    from repro_torch.launch.costing import OpCounter
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.train.pipeline_parallel import pipeline_forward

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_mesh_compat((STAGES, WORLD // STAGES), ("pod", "data"),
                                device="cpu")
        w, x = (torch.from_numpy(a) for a in _inputs())
        got = {}
        for name, xs in (("full", x), ("short", x[:1])):
            with OpCounter() as c:
                out = pipeline_forward(_stage_fn, w, xs, mesh=mesh)
            got[name] = (out.numpy(), c.collectives())
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump((mesh.get_coordinate(), got), f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _reference(tmp_path):
    """The reference's pipeline_forward on a (2, 2) mesh of forced host
    devices, for both micro-batch counts."""
    w, x = _inputs()
    np.savez(tmp_path / "in.npz", w=w, x=x)
    run_subprocess_jax(f"""
import jax.numpy as jnp, numpy as np
from repro.train.pipeline_parallel import pipeline_forward
from repro.launch.mesh import make_mesh_compat
mesh = make_mesh_compat((2, 2), ("pod", "data"))
d = np.load({str(tmp_path / "in.npz")!r})
W, x = jnp.asarray(d["w"]), jnp.asarray(d["x"])
f = lambda w, h: jnp.tanh(h @ w)
with mesh:
    full = pipeline_forward(f, W, x, mesh=mesh)
    short = pipeline_forward(f, W, x[:1], mesh=mesh)
np.savez({str(tmp_path / "ref.npz")!r}, full=np.asarray(full),
         short=np.asarray(short))
""", devices=4)
    ref = np.load(tmp_path / "ref.npz")
    return {"full": ref["full"], "short": ref["short"]}


def test_pipeline_forward_on_four_gloo_ranks_equals_the_stack_and_reference(
        tmp_path):
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_worker, args=(_free_port(), str(tmp_path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    ref = _reference(tmp_path)
    for _ in range(180):                    # at most 180 s
        if ctx.join(timeout=1):
            break
    else:
        for proc in ctx.processes:
            proc.kill()
        pytest.fail("the four ranks did not finish in 180 s")

    w, x = (torch.from_numpy(a) for a in _inputs())
    stack = torch.stack([_stage_fn(w[1], _stage_fn(w[0], x[i]))
                         for i in range(N_MICRO)]).numpy()
    want = {"full": stack, "short": stack[:1]}
    for rank in range(WORLD):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            (pod, _), got = pickle.load(f)
        for name, (out, coll) in got.items():
            n = want[name].shape[0]
            assert out.shape == want[name].shape
            assert np.max(np.abs(out - want[name])) < 1e-6, (rank, name)
            assert np.max(np.abs(out - ref[name])) < 1e-6, (rank, name)
            # stage 1 receives each micro-batch's activations once;
            # every rank all-reduces the outputs once
            recv = coll["count_by_type"].get("collective-permute", 0)
            assert recv == (n if pod == 1 else 0), (rank, name, coll)
            assert coll["bytes_by_type"].get("collective-permute", 0) == \
                recv * MB * D * 4
            assert coll["count_by_type"]["all-reduce"] == 1
            assert coll["bytes_by_type"]["all-reduce"] == n * MB * D * 4


# ------------------------------------------------------------- devsim ---
@pytest.fixture
def devsim(monkeypatch):
    from repro_torch.launch import devsim
    monkeypatch.setattr(devsim, "_lanes", None)
    return devsim


def test_force_host_devices_first_setting_wins(devsim, monkeypatch):
    assert devsim.forced_lanes() is None
    devsim.force_host_devices(4)
    devsim.force_host_devices(8)
    assert devsim.forced_lanes() == 4
    monkeypatch.setattr(devsim, "_lanes", None)
    with pytest.raises(ValueError):
        devsim.force_host_devices(0)


@pytest.mark.parametrize("argv,lanes", [
    (["prog", "--shards", "3"], 6), (["prog", "--shards=3"], 6),
    (["prog", "--shardsX=3"], None), (["prog"], None)])
def test_force_host_devices_when_flag(devsim, monkeypatch, argv, lanes):
    monkeypatch.setattr("sys.argv", argv)
    devsim.force_host_devices(6, when_flag="--shards")
    assert devsim.forced_lanes() == lanes


def test_shard_devices_takes_the_forced_lane_count_on_the_cpu(devsim):
    from repro_torch.launch.mesh import shard_devices
    assert shard_devices(None, device="cpu") == [torch.device("cpu")]
    devsim.force_host_devices(5)
    assert shard_devices(None, device="cpu") == [torch.device("cpu")] * 5
    # a count the caller names is kept
    assert shard_devices(2, device="cpu") == [torch.device("cpu")] * 2


def test_devsim_imports_nothing_heavy():
    import subprocess
    import sys
    code = ("import sys\nimport repro_torch.launch.devsim\n"
            "print(sorted(m for m in ('torch', 'numpy', 'jax') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ----------------------------------------------------------------- hw ---
@pytest.mark.parametrize("name,part", [
    ("NVIDIA H100 80GB HBM3", "H100"), ("NVIDIA H100 PCIe", "H100 PCIe"),
    ("NVIDIA H100 NVL", "H100 NVL")])
def test_hw_peaks_by_device_name(name, part):
    from repro_torch.launch import hw
    row = hw.peaks(name)
    assert row.part == part
    assert row.bf16_flops > row.f32_flops > 0 and row.hbm_bw > 0


def test_hw_unknown_card_raises_and_holds_no_tpu_figure():
    from repro_torch.launch import hw
    for name in ("NVIDIA A100-SXM4-80GB", "TPU v5 lite", ""):
        with pytest.raises(KeyError):
            hw.peaks(name)
    assert (hw.PEAK_FLOPS_BF16, hw.HBM_BW, hw.NVLINK_BW) == \
        (989e12, 3.35e12, 900e9)
    assert (hw.CHIPS_SINGLE_POD, hw.CHIPS_MULTI_POD) == (256, 512)
    text = (ROOT / "src" / "repro_torch" / "launch" / "hw.py").read_text()
    for tpu in ("197e12", "819e9", "ICI_BW", "v5e"):
        assert tpu not in text


def test_chip_smoke_keeps_no_peak_table_of_its_own():
    text = (ROOT / "chip_smoke.py").read_text()
    assert "PEAKS" not in text
    for figure in ("3.35e12", "989e12", "67e12", "756e12", "835e12"):
        assert figure not in text
    assert re.search(r"from repro_torch\.launch import hw|"
                     r"repro_torch\.launch\.hw", text)
