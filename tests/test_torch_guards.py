"""Boundary guards of the PyTorch/CUDA port (src/repro_torch):

* the package imports neither ``jax``, the reference package nor
  ``ml_dtypes``;
* ``chip_smoke.py`` imports neither;
* entry points (the training ones too) default to ``cuda`` and raise
  without a card instead of carrying on quietly on the CPU, and the
  kernel wrappers never run a CUDA request on the CPU;
* on the card, ``ssd_scan`` under grad takes its autograd route
  (``_SSD``: the kernel's forward, the plain version's backward).
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _is_forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25     # every module was imported


@pytest.mark.parametrize("path", ["chip_smoke.py"] + sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "src" / "repro_torch")
    .rglob("*.py")))
def test_no_jax_or_reference_import_statements(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_is_forbidden(n) for n in names), (path, names)


def test_the_walk_covers_the_serving_modules():
    """The import-statement walk above is over every file of the package;
    the serving layer's modules are among them (and the module import
    check imports each)."""
    walked = {str(p.relative_to(ROOT)) for p in
              (ROOT / "src" / "repro_torch").rglob("*.py")}
    for name in ("faults", "scheduler", "batcher", "repcache", "service",
                 "host", "kvcache", "speculative", "continuous_batching"):
        assert f"src/repro_torch/serve/{name}.py" in walked, name
    assert "src/repro_torch/core/lm_cascade.py" in walked
    assert "examples/serve_cascade_torch.py" not in walked
    test_no_jax_or_reference_import_statements(
        "examples/serve_cascade_torch.py")


def test_the_walk_covers_the_lm_family_modules():
    """The moe, MLA, vlm and audio families' modules and configs are
    among the walked (and imported) files."""
    walked = {str(p.relative_to(ROOT)) for p in
              (ROOT / "src" / "repro_torch").rglob("*.py")}
    for name in ("models/encdec", "models/ffn", "models/attention",
                 "models/transformer", "models/factory", "serve/kvcache",
                 "launch/serve", "configs/phi3_5_moe",
                 "configs/deepseek_v2_236b", "configs/qwen2_vl_72b",
                 "configs/whisper_tiny", "configs/registry"):
        assert f"src/repro_torch/{name}.py" in walked, name


def test_the_walk_covers_the_training_modules():
    """The training and launch substrate's modules are among the walked
    (and imported) files; the training example imports neither JAX nor
    the reference."""
    walked = {str(p.relative_to(ROOT)) for p in
              (ROOT / "src" / "repro_torch").rglob("*.py")}
    for name in ("configs/base", "configs/shapes", "configs/deployment",
                 "sharding/policy", "launch/mesh", "launch/steps",
                 "launch/train", "train/compression", "train/checkpoint",
                 "train/runtime", "data/pipeline"):
        assert f"src/repro_torch/{name}.py" in walked, name
    test_no_jax_or_reference_import_statements("examples/train_lm_torch.py")


def test_the_walk_covers_the_fleet_modules():
    """The fleet tooling's modules are among the walked (and imported)
    files, and every file of the reference has a counterpart in the
    port."""
    walked = {str(p.relative_to(ROOT)) for p in
              (ROOT / "src" / "repro_torch").rglob("*.py")}
    for name in ("launch/hw", "launch/costing", "launch/dryrun",
                 "launch/devsim", "train/pipeline_parallel"):
        assert f"src/repro_torch/{name}.py" in walked, name
    ref = {str(p.relative_to(ROOT / "src" / "repro")) for p in
           (ROOT / "src" / "repro").rglob("*.py")}
    port = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in
            (ROOT / "src" / "repro_torch").rglob("*.py")}
    assert sorted(ref - port) == []


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    _no_card()
    from repro_torch.configs.base import TahomaCNNConfig
    from repro_torch.core.cascade import evaluate_cascades_streaming
    from repro_torch.core.costs import CostProfile
    from repro_torch.core.pipeline import ModelBank, build_scan_engine
    from repro_torch.core.transforms import Representation
    from repro_torch.engine.scan import ScanEngine, naive_scan
    from repro_torch.models.cnn import init_cnn, params_from_jax

    images = np.zeros((4, 8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ScanEngine(images)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_scan_engine(images)
    with pytest.raises(RuntimeError, match="CUDA"):
        naive_scan(images, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelBank()
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cnn(torch.Generator(), TahomaCNNConfig(input_hw=8))
    reps = [Representation(8, "rgb"), Representation(4, "gray")]
    prof = CostProfile.modeled({"a": 1e-4, "b": 1e-4}, reps, base_hw=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_cascades_streaming(
            np.full((2, 6), 0.5, np.float32), np.array([0, 1] * 3),
            np.zeros((2, 1)), np.ones((2, 1)), reps, [1e-4, 1e-4], prof,
            "CAMERA", trusted=1)
    # the LM serving path
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer
    from repro_torch.models.factory import build_model
    model = build_model(smoke_config("zamba2-1.2b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.params_from_jax({"embed": {"embedding": np.zeros(
            (4, 2), np.float32)}})
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(2, 8)
    cpu_params = model.init(torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(model, cpu_params, np.zeros((1, 4), np.int64), 1)
    # asking for the CPU explicitly works
    assert ScanEngine(images, device="cpu").n_rows == 4
    assert serve(model, cpu_params, np.zeros((1, 4), np.int64), 1,
                 device="cpu").tokens.shape == (1, 2)


def test_training_entry_points_default_to_cuda_and_raise_without_a_card():
    _no_card()
    from repro_torch.configs.base import TahomaCNNConfig
    from repro_torch.core.pipeline import (fit_cnn, initialize_system,
                                           train_cnn, train_model_grid)
    from repro_torch.core.transforms import Representation
    from repro_torch.models.cnn import init_cnn

    rng = np.random.default_rng(0)
    x = rng.random((8, 8, 8, 3)).astype(np.float32)
    y = np.arange(8) % 2
    cfg = TahomaCNNConfig(1, 4, 4, input_hw=8, input_channels=3)
    params = init_cnn(torch.Generator(), cfg, device="cpu")
    archs, reps = [TahomaCNNConfig(1, 4, 4)], [Representation(4, "gray")]
    splits = ((x, y),) * 3
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_cnn(params, x, y, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cnn(cfg, x, y, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_model_grid(x, y, archs, reps, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize_system(*splits, archs, reps, steps=1)
    # asking for the CPU explicitly works
    assert fit_cnn(params, x, y, steps=1, device="cpu")["dense_w"].device \
        == torch.device("cpu")
    assert train_cnn(cfg, x, y, steps=1, device="cpu")["out_b"].shape == (1,)
    bank = train_model_grid(x, y, archs, reps, steps=1, device="cpu")
    assert bank.names == ["cnn_l1_c4_d4_4x4_gray", "trusted_cnn_l3_c48_d64"]
    system = initialize_system(*splits, archs, reps, steps=1,
                               infer_s={n: 1e-6 for n in bank.names},
                               device="cpu")
    assert system.device.type == "cpu" and system.eval_scores.shape == (2, 8)


def test_lm_training_entry_points_default_to_cuda_and_raise_without_a_card(
        tmp_path):
    _no_card()
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import train as t_train
    from repro_torch.launch.mesh import (make_host_mesh, make_mesh_compat,
                                         make_production_mesh)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.factory import build_model
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.runtime import RuntimeConfig, TrainRuntime

    model = build_model(smoke_config("mamba2-130m"))
    shape = ShapeConfig("t", "train", 16, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train.main(["--arch", "mamba2-130m", "--steps", "1",
                      "--ckpt-dir", str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(model, None, shape)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh_compat((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainRuntime(lambda p, o, b: (p, o, {}), RuntimeConfig(
            str(tmp_path / "b")))
    tree = {"w": torch.ones(3)}
    ck.save(tmp_path / "c", 1, tree)
    with pytest.raises(RuntimeError, match="CUDA"):
        ck.restore(tmp_path / "c", 1, tree)
    # asking for the CPU explicitly works; the production mesh wants its
    # 256 ranks
    assert torch.equal(ck.restore(tmp_path / "c", 1, tree,
                                  device="cpu")["w"], tree["w"])
    mesh = make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    fn, info = make_train_step(model, mesh, shape)
    assert info["n_micro"] == 2
    with pytest.raises(ValueError, match="256"):
        make_production_mesh(device="cpu")


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes a wrapper's CUDA
    route up to the launch, which the test stubs."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _ssd_args(requires_grad):
    g = torch.Generator().manual_seed(3)
    args = (torch.randn(1, 8, 2, 4, generator=g),
            torch.rand(1, 8, 2, generator=g),
            -torch.rand(2, generator=g), torch.randn(1, 8, 3, generator=g),
            torch.randn(1, 8, 3, generator=g))
    return [a.requires_grad_(requires_grad) for a in args]


def test_ssd_scan_on_the_card_under_grad_goes_through_ssd_autograd(
        monkeypatch):
    """The wrapper's CUDA route: with grad enabled and an operand that
    requires grad it returns y and the final state from ``_SSD`` (the
    launch stubbed); otherwise it launches directly, with no graph."""
    from repro_torch.kernels import ssd_scan as mod
    from repro_torch.kernels.ref import ssd_scan_ref

    launched = []

    def stub(x, dt, a, bmat, cmat):
        launched.append(True)
        plain = [torch.Tensor(t.detach().as_subclass(torch.Tensor))
                 for t in (x, dt, a, bmat, cmat)]
        return ssd_scan_ref(*plain, chunk=4)
    monkeypatch.setattr(mod, "_launch", stub)
    on_card = [t.as_subclass(_OnCard) for t in _ssd_args(True)]
    y, final = mod.ssd_scan(*on_card, chunk=4)
    assert type(y.grad_fn).__name__ == "_SSDBackward"
    assert final.grad_fn is y.grad_fn and len(launched) == 1
    with torch.no_grad():
        y, _ = mod.ssd_scan(*on_card, chunk=4)
    assert y.grad_fn is None and len(launched) == 2
    y, _ = mod.ssd_scan(*[t.detach() for t in on_card], chunk=4)
    assert y.grad_fn is None and len(launched) == 3


def test_ssd_autograd_forward_launches_and_backward_is_the_plain_versions(
        monkeypatch):
    """``_SSD`` on CPU tensors with the launch stubbed (it writes the
    plain version's outputs and counts): one launch in the forward, none
    in the backward, and the gradients of all five operands for both
    outputs equal ``ssd_scan_ref``'s."""
    from repro_torch.kernels import bindings, ops
    from repro_torch.kernels import ssd_scan as mod
    from repro_torch.kernels.ref import ssd_scan_ref

    def stub(x, dt, a, bmat, cmat, y, final):
        yr, fr = ssd_scan_ref(x, dt, a, bmat, cmat, chunk=4)
        y.copy_(yr)
        final.copy_(fr)
        ops.LAUNCHES["ssd_scan"] += 1
    monkeypatch.setattr(bindings, "launch_ssd_scan", stub)
    ops.reset_launch_counts()
    args = _ssd_args(True)
    y, final = mod._SSD.apply(*args, 4)
    assert ops.LAUNCHES["ssd_scan"] == 1
    g = torch.Generator().manual_seed(4)
    wy, wf = torch.randn(y.shape, generator=g), torch.randn(final.shape,
                                                            generator=g)
    got = torch.autograd.grad((y * wy).sum() + (final * wf).sum(), args)
    assert ops.LAUNCHES["ssd_scan"] == 1
    yr, fr = ssd_scan_ref(*args, chunk=4)
    want = torch.autograd.grad((yr * wy).sum() + (fr * wf).sum(), args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # a gradient of y alone (the model's use: the final state unused)
    got = torch.autograd.grad((mod._SSD.apply(*args, 4)[0] * wy).sum(),
                              args)
    want = torch.autograd.grad((ssd_scan_ref(*args, chunk=4)[0] * wy).sum(),
                               args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    ops.reset_launch_counts()


def test_kernel_wrappers_never_run_a_cuda_request_on_the_cpu():
    _no_card()
    from repro_torch.core.transforms import Representation
    from repro_torch.kernels import bindings, build, ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.image_transform import (fused_pyramid_stage0,
                                                     fused_pyramid_transform,
                                                     fused_transform)
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.ssd_scan import ssd_scan

    # a CUDA operand cannot even be made without a card (a CPU-only torch
    # raises AssertionError, a CUDA build without a device RuntimeError)
    with pytest.raises((AssertionError, RuntimeError)):
        matmul(torch.zeros(2, 2, device="cuda"), torch.zeros(2, 2,
                                                             device="cuda"))
    # any other device is refused by the wrapper itself, not computed on
    # the CPU
    meta = torch.zeros(2, 2, device="meta")
    with pytest.raises(ValueError):
        matmul(meta, meta)
    with pytest.raises(ValueError):
        fused_pyramid_stage0(torch.zeros(1, 8, 8, 3, device="meta"), [4],
                             {}, Representation(4, "rgb"))
    meta_images = torch.zeros(1, 8, 8, 3, device="meta")
    with pytest.raises(ValueError):
        fused_transform(meta_images, ops.COLOR_WEIGHTS["gray"], 4)
    with pytest.raises(ValueError):
        fused_pyramid_transform(meta_images,
                                [(4, ops.COLOR_WEIGHTS["rgb"])])
    with pytest.raises(ValueError):
        ops.transform_op(meta_images, res=4)
    with pytest.raises(ValueError):
        flash_attention(*(torch.zeros(1, 2, 8, 16, device="meta"),) * 3)
    with pytest.raises(ValueError):
        ssd_scan(torch.zeros(1, 8, 2, 4, device="meta"),
                 torch.zeros(1, 8, 2, device="meta"),
                 torch.zeros(2, device="meta"),
                 torch.zeros(1, 8, 4, device="meta"),
                 torch.zeros(1, 8, 4, device="meta"))
    # a CPU tensor beside a CUDA request is refused too, not computed
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 2, 8, 16), torch.zeros(
            1, 2, 8, 16, device="meta"), torch.zeros(1, 2, 8, 16))
    # the launch path needs the built kernel: without nvcc it raises,
    # and it counts no launch
    if build._LIBS:
        pytest.skip("kernels already loaded in this process")
    before = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        bindings.launch_matmul(torch.zeros(2, 2), torch.zeros(2, 2),
                               torch.zeros(2, 2))
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(RuntimeError, match="nvcc"):
        bindings.launch_flash_attention(q, q, q, q, True)
    with pytest.raises(RuntimeError, match="nvcc"):
        bindings.launch_ssd_scan(torch.zeros(1, 4, 1, 2),
                                 torch.zeros(1, 4, 1), torch.zeros(1),
                                 torch.zeros(1, 4, 2), torch.zeros(1, 4, 2),
                                 torch.zeros(1, 4, 1, 2),
                                 torch.zeros(1, 1, 2, 2))
    with pytest.raises(RuntimeError, match="nvcc"):
        bindings.launch_fused_transform(bindings.ITParams())
    with pytest.raises(RuntimeError, match="nvcc"):
        bindings.launch_fused_pyramid_transform(bindings.ITParams())
    assert ops.LAUNCHES == before


def test_cpu_tensors_use_the_plain_versions():
    from repro_torch.kernels import ops
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.ref import matmul_ref

    ops.reset_launch_counts()
    a = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    b = torch.randn(7, 3, generator=torch.Generator().manual_seed(1))
    assert torch.equal(matmul(a, b), matmul_ref(a, b))
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref, ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, 2, 8, 16, generator=g) for _ in range(3))
    assert torch.equal(flash_attention(q, k, v),
                       flash_attention_ref(q, k, v))
    args = (torch.randn(1, 8, 2, 4, generator=g), torch.rand(1, 8, 2,
                                                               generator=g),
            -torch.rand(2, generator=g), torch.randn(1, 8, 3, generator=g),
            torch.randn(1, 8, 3, generator=g))
    for got, want in zip(ssd_scan(*args, chunk=4),
                         ssd_scan_ref(*args, chunk=4)):
        assert torch.equal(got, want)
    from repro_torch.kernels.ref import (fused_pyramid_transform_ref,
                                         fused_transform_ref)
    images = torch.rand(2, 16, 16, 3, generator=g)
    assert torch.equal(ops.transform_op(images, res=4, color="gray"),
                       fused_transform_ref(images,
                                           ops.COLOR_WEIGHTS["gray"], 4))
    specs = ((8, "rgb"), (4, "b"), (16, "gray"))
    for got, want in zip(
            ops.pyramid_transform_op(images, specs=specs),
            fused_pyramid_transform_ref(
                images, [(r, ops.COLOR_WEIGHTS[c]) for r, c in specs])):
        assert torch.equal(got, want)
    assert ops.LAUNCHES == {"fused_pyramid_stage0": 0, "matmul": 0,
                            "flash_attention": 0, "ssd_scan": 0,
                            "fused_transform": 0,
                            "fused_pyramid_transform": 0}


def _smoke(args, cwd):
    # one intra-op thread: beside the suite's other workers, torch's
    # default of one thread per core oversubscribes the CPU many times
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_chip_smoke_refuses_without_a_card_or_a_checkout(tmp_path):
    _no_card()
    out = _smoke([], ROOT)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = _smoke([], tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_chip_smoke_rehearsal_runs_every_phase_on_the_cpu():
    out = _smoke(["--rehearse"], ROOT)
    assert out.returncode == 3, out.stderr[-2000:]
    assert '"ok"' not in out.stdout
    assert "identical rows: True" in out.stdout
    kernels = [ln for ln in out.stdout.splitlines()
               if ln.startswith('{"kernels"')]
    assert len(kernels) == 1
    names = [k["name"] for k in json.loads(kernels[0])["kernels"]]
    assert names == ["fused_pyramid_stage0", "matmul", "flash_attention",
                     "ssd_scan", "fused_transform", "fused_pyramid_transform"]
    assert "prefill + decode_step == forward" in out.stdout
    assert "== serving" in out.stdout and "failed_devices [3, 5]" in \
        out.stdout and "labels equal the unfaulted run's: True" in out.stdout
    assert "== dense LM path" in out.stdout and "labels and levels equal " \
        "the host oracle's: True" in out.stdout
    assert "== moe, MLA, vlm and audio LM paths" in out.stdout
    assert out.stdout.count("prefill + decode_step == forward") >= 7
    assert "== LM training" in out.stdout
    assert "gradients of x, dt, a, B, C equal the plain version's: True" \
        in out.stdout
    assert "params and optimizer state torch.equal to the uninterrupted " \
        "run's: True" in out.stdout
    assert "byte for byte the synchronous one of run a: True" in out.stdout
    assert "restores as it was at save: True" in out.stdout
    assert out.stdout.count("compressed step (") == 2
    assert "== fleet tooling" in out.stdout
    assert "costing, zamba2-1.2b train step" in out.stdout
    assert "analytic_bytes('train')" in out.stdout
    assert "dryrun mamba2-130m x decode_32k x single (256 fake ranks)" \
        in out.stdout
    assert "pipeline_forward, 2 gloo ranks" in out.stdout and \
        "torch.equal to the stack: True" in out.stdout
    assert "== tensor parallel" in out.stdout
    tp, cp = out.stdout.split("== tensor parallel")[1].split(
        "== context parallel")
    cp, zero = cp.split("== ZeRO layers")
    # zamba2-1.2b, deepseek-7b, phi3.5-moe, deepseek-v2 and whisper-tiny
    assert tp.count("float32 against the one-rank path") == 5
    assert out.stdout.count("routing at capacity factor 1.25 (apply_moe "
                            "on the first layer's experts") == 2
    assert "train step zamba2-1.2b f32" in out.stdout
    assert "train step phi3.5-moe-42b-a6.6b f32" in out.stdout
    # zamba2-1.2b on (data 2, model 1), bf16 then f32
    assert "2 ranks on a (data 2, model 1) mesh" in cp
    assert cp.count("every rank's tokens and logits equal: True") == 2
    assert cp.count("against the one-rank path (mesh (1, 1)") == 2
    # zamba2-1.2b's ZeRO train steps on (data 2, model 1), bf16 then f32:
    # each rank's collectives beside the count from the specs
    assert "2 ranks on a (data 2, model 1) mesh" in zero
    assert zero.count("collectives a micro-batch") == 4
    assert "float32 step against the one-rank path" in zero


def _c_struct_fields(source: str, struct: str) -> list[str]:
    """The field names of ``struct`` in a csrc source, in order."""
    import re
    text = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" /
            source).read_text()
    body = text[text.index(f"struct {struct} {{"):]
    body = body[body.index("{") + 1:body.index("};")]
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):       # "const float* img", "int B, H"
        for part in re.sub(r"\[[^\]]*\]", "", decl).split(","):
            words = re.findall(r"\w+", part)
            if words:
                names.append(words[-1])
    return names


@pytest.mark.parametrize("source,struct", [
    ("pyramid_stage0.cu", "PS0Params"), ("image_transform.cu", "ITParams")])
def test_ctypes_launch_structs_mirror_the_c_structs(source, struct):
    """The ctypes mirrors in kernels/bindings.py name the C fields in the
    C order (the card checks the sizes at first use; a swapped pair of
    same-sized fields only shows here)."""
    from repro_torch.kernels import bindings
    mirror = [f[0] for f in getattr(bindings, struct)._fields_]
    assert _c_struct_fields(source, struct) == mirror
