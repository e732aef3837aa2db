#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # from the root of a checkout

1. Setup: prints the card's name and power limit (nvidia-smi), builds the
   hand-written kernels from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels/`` and prints the build time and, per kernel, ptxas's
   registers, static shared memory and spills.
2. Kernels vs plain versions on the card: ``fused_pyramid_stage0`` (base
   224, chunk 256, levels {112, 56, 28}; grid extremes, the 56 px rgb 2x32
   case and the planned stage-0s, each f32 and int8: levels ``torch.equal``,
   scores within SCORE_TOL) and ``matmul`` (random f32/bf16 at ragged
   shapes and both evaluator shapes, within the reference test's
   tolerances, each rerun bit-identical: split-K adds in a fixed order),
   with kernel, plain, bound and library times.
3. Query path: three predicates, each with a 361-model bank over the paper
   grid (random weights from a seeded generator), ``system_from_bank`` on
   512-frame splits, the streaming cascade-space evaluator through the
   matmul kernel (checked against the dense evaluator), a joint plan, and
   ``ScanEngine`` over 8192 dyadic 224 px frames resident on the card,
   fused through the pyramid+stage-0 kernel, f32 and int8, each held
   against ``naive_scan``. Launch counts are reset just before this phase
   and read just after it; a kernel of the path with 0 launches fails.
   The f32 scan is then rerun under ``torch.profiler``: device time by
   kernel and the device's idle share. The evaluator's two products,
   (128, 512) @ (512, A) and (128, 512) @ (512, M) on its 0/1 matrices,
   are exact; kernel and ``torch.matmul`` in alternating order, each on
   two clocks (CUDA events around back-to-back calls, the clock of every
   ``ms`` in the kernels line, and profiler device time, per launch too;
   median and spread), plain and bound; a 2048^3 probe compares the
   kernel's inner loop with cuBLAS's.
4. LM serve path: zamba2-1.2b at full width (38 Mamba-2 layers, the shared
   attention+MLP block after every 6th; random bf16 weights from a seeded
   generator) serves 8 prompts of 512 tokens with 32 greedy decode steps
   and bf16 KV through ``launch.serve.serve``. Launch counts are reset just
   before the timed serve and read just after it: one prefill must launch
   ``flash_attention`` 6 times and ``ssd_scan`` 38 times. Both kernels are
   then held against their plain versions on the card at the path's shapes
   and at the reference tests' shapes, flash on contiguous (B,H,S,D) inputs
   and on the (B,S,H,D).transpose(1, 2) views the model passes (its output
   laid out like q); kernel, plain, bound and library times (flash on the
   model's views, beside SDPA on the same views, on both clocks). The prefill is profiled
   (its copy kernels listed), one prefill under an operator hook must make
   no (B,S,H,D) <-> (B,H,S,D) copy, a decode step is profiled, and an f32
   copy of the model must give the same logits from
   ``prefill`` on the first 256 tokens + one ``decode_step`` as from
   ``forward`` over all 512 tokens at that position (the kernel path
   against the plain decode recurrences).
5. Kernel entry points (``kernels/ops``), the twin of the reference's
   ``bench_transform_kernel`` at the query path's width: a chunk of 256
   dyadic 224 px frames through ``pyramid_transform_op`` with all 20
   (resolution, color) specs of the bank's representation space in one
   launch, and through ``transform_op`` once per spec. Launch counts are
   reset just before and read just after: 20 ``fused_transform`` and 1
   ``fused_pyramid_transform``. Every output is held against its plain
   version (rgb/r/g/b ``torch.equal``, gray within TRANSFORM_GRAY_TOL), and
   again on ``torch.rand`` frames within TRANSFORM_TOL; then kernel, plain,
   bound and library (``F.conv2d``) times.
6. The card's name and power limit again, one ``{"kernels": [...]}``
   line, then the result line ``{"ok": true, "device": {...}}``.

Any failed check raises and the run exits non-zero. Without a CUDA device,
or outside a checkout of the repo, it exits non-zero and prints no result.
``--rehearse`` runs the same phases at toy sizes on the CPU (plain
versions only; exits 3 and never prints a result).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Per-card peaks for the bounds (NVIDIA data sheets): memory bytes/s, f32
# FLOP/s outside the tensor cores (f32 FFMA), and dense bf16 tensor-core
# FLOP/s (the least time attention's bf16 products could take).
PEAKS = (("H100 PCIe", 2.0e12, 51e12, 756e12),
         ("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H100", 3.35e12, 67e12, 989e12))
SCORE_TOL = 1e-4   # |kernel - plain| on sigmoid scores: f32 sums in another
#                    order (conv dot products of up to 9*48 terms, dense of up
#                    to 6272); an indexing fault shows as O(0.1)
MM_TOL = {"float32": 1e-3, "bfloat16": 3e-2}   # tests/test_kernels.py
FLASH_TOL = 2e-3    # f32 kernel vs f32 plain, atol = rtol: same tests
# bf16 kernel vs the plain version on the same inputs widened to f32, atol
# and rtol. The kernel's scores are f32 sums of exact bf16 products; what
# it rounds is P to bf16 before P V and the output to bf16. The first adds
# at most 2^-9 * sum_j p_j |v_j| / l over the keys whose p is not exactly
# 1: 2^-10 max|v| (~2.6e-3 for the 0.5-scaled inputs below) on a row of
# two keys, less over many. The second is half an ulp, <= 2^-8 of |out|.
# A KV tile dropped or rescaled wrongly moves the later rows by ~1e-2.
FLASH_BF16_TOL = (4e-3, 2.0 ** -8)
SSD_TOL = (5e-4, 5e-3)       # atol, rtol: tests/test_kernels.py::test_ssd_*
# prefill + decode_step vs forward, f32 at full width: max |diff| over the
# largest |logit|. f32 sums run in other orders (the chunked SSD kernel vs
# the decode recurrence through 38 layers, the flash kernel vs sdpa over
# the cache); a state, position or mask fault moves logits by O(1).
CONSIST_TOL = 1e-3
# transform kernels vs plain versions. On dyadic (k/256) pixels the pooled
# sums are exact and x1/x0 projections too, so rgb/r/g/b must be equal;
# gray sums three products in another order (|err| <= ~2 ulp of 1, x4 by
# the normalization); on torch.rand pixels, tests/test_kernels.py's atol.
TRANSFORM_GRAY_TOL = 1e-6
TRANSFORM_TOL = 1e-5
FLASH_TEST_SHAPES = ((1, 2, 64, 32), (2, 3, 128, 64), (1, 1, 256, 16))
SSD_TEST_SHAPES = ((1, 64, 2, 8, 16), (2, 128, 3, 16, 32))
PROFILER_SESSIONS = 3   # device_ms: sessions tried before it gives up

FULL = dict(base=224, chunk=256, out_res=(112, 56, 28), split=512,
            corpus=8192, gen_batch=512, resolutions=(28, 56, 112, 224),
            small_grid=False, mm_shapes=((33, 17, 65), (256, 64, 130),
                                         (128, 512, 1805), (128, 512, 361)),
            mm_probe=2048, iters=10,
            lm=dict(arch="zamba2-1.2b", full=True, batch=8, prompt=512,
                    gen=32, check_at=256))
REHEARSE = dict(base=32, chunk=32, out_res=(16, 8, 4), split=48, corpus=96,
                gen_batch=48, resolutions=(4, 8, 16, 32), small_grid=True,
                mm_shapes=((33, 17, 65),), mm_probe=64, iters=1,
                lm=dict(arch="zamba2-1.2b", full=False, batch=2, prompt=64,
                        gen=4, check_at=32))


def log(msg: str) -> None:
    print(msg, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repo "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    if not args.rehearse and not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    cfg = REHEARSE if args.rehearse else FULL
    dev = torch.device("cpu" if args.rehearse else "cuda")

    card = setup(dev)
    kern = check_kernels(dev, cfg, card, args.seed)
    launches = query_path(dev, cfg, card, kern, args.seed)
    launches.update(lm_path(dev, cfg, card, kern, args.seed))
    launches.update(ops_path(dev, cfg, card, kern, args.seed))
    if "smi" in card:    # again near the end: the card beside the numbers
        log(card["smi"])
    kernels_line(kern, launches)
    if args.rehearse:
        log("rehearsal on the CPU: plain versions only, no result")
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ------------------------------------------------------------ phase 1 --
def setup(dev):
    import torch

    from repro_torch.device import resolve_device
    resolve_device(dev)                 # TF32 off, cudnn.benchmark off
    if dev.type != "cuda":
        return {"name": "cpu", "bw": 1.0, "flops": 1.0, "bf16": 1.0}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    bw, flops, bf16 = next((b, f, h) for key, b, f, h in PEAKS
                           if key in name)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; peaks used "
        f"for bounds: {bw / 1e12:.2f} TB/s, {flops / 1e12:.0f} TFLOP/s f32, "
        f"{bf16 / 1e12:.0f} TFLOP/s bf16 tensor cores")
    from repro_torch.kernels import build
    build.build_all()
    info = build.BUILD_INFO
    log(f"kernel build: {info['seconds']:.1f} s into {info['dir']} "
        f"(built {info['built']})")
    for stem, text in info["logs"].items():
        for fn, props in ptxas_by_function(text):
            log(f"  ptxas {stem}: {fn}: {props}")
    return {"name": name, "smi": smi, "bw": bw, "flops": flops, "bf16": bf16}


def ptxas_by_function(text):
    """[(kernel, "R registers, S bytes smem, spill stores/loads")] from
    nvcc's -Xptxas -v output, kernel names demangled where c++filt is
    installed (dynamic shared memory is not in ptxas's count)."""
    import re
    import shutil
    rows, fn, props = [], None, {}
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, props = m.group(1), {}
            rows.append((fn, props))
        elif fn and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            props["spills"] = f"spills {m.group(1)}/{m.group(2)} bytes"
        elif fn and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            props["regs"] = (f"{regs} registers, "
                             f"{smem.group(1) if smem else 0} bytes smem")
    names = [f for f, _ in rows]
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True
                               ).stdout.splitlines() or names
    return [(n, ", ".join(p[k] for k in ("regs", "spills") if k in p))
            for n, (_, p) in zip(names, rows)]


# ------------------------------------------------------------ phase 2 --
def time_ms(fn, dev, iters: int) -> float:
    import torch
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, dev, iters: int, launches=None) -> float:
    """Device time of one ``fn()``: the durations of the kernels (and
    memsets) it launches, summed over ``iters`` calls by torch.profiler,
    over ``iters``. Host time between launches is not in it, so a call
    whose host work outlasts its kernels is not host-bound here (time_ms
    shows that). With a dict ``launches``, each launch's duration (us) is
    appended to ``launches[kernel name]``. A profiler session that
    records no device event at all (CUPTI tracing, rarely, returns none)
    is opened again, at most PROFILER_SESSIONS times in all. On
    the CPU (rehearsal) it is time_ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if dev.type != "cuda":
        return time_ms(fn, dev, iters)
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [(e.name, e.time_range.end - e.time_range.start)
                 for e in prof.events() if e.device_type == DeviceType.CUDA]
        if spans:
            break
        log(f"    (profiler session {attempt + 1} recorded no device event)")
    else:
        raise AssertionError(f"the profiler saw no device time in "
                             f"{PROFILER_SESSIONS} sessions")
    for name, us in spans if launches is not None else ():
        launches.setdefault(name, []).append(us)
    return sum(us for _, us in spans) / 1e3 / iters


def alternating(label, fns, dev, iters, reps=3):
    """Two functions timed in the order a, b, b, a (``reps`` times) on two
    clocks: CUDA events around ``iters`` back-to-back calls (time_ms, the
    host included where it is the slower side: the clock of every ``ms``
    in the kernels line) and device time (device_ms). Prints each clock's
    runs in order with median and spread, and each kernel's per-launch
    device time. -> {name: {"ms": (median, spread), "device_ms": (median,
    spread)}}."""
    import statistics
    got = {name: {"ms": [], "device_ms": [], "launches": {}}
           for name, _ in fns}
    for _ in range(reps):
        for name, fn in (fns[0], fns[1], fns[1], fns[0]):
            g = got[name]
            g["ms"].append(time_ms(fn, dev, iters))
            g["device_ms"].append(device_ms(fn, dev, iters, g["launches"]))
    out = {}
    log(f"  {label} ({reps} x kernel, library, library, kernel):")
    for name, g in got.items():
        out[name] = {c: (statistics.median(g[c]), max(g[c]) - min(g[c]))
                     for c in ("ms", "device_ms")}
        for c, what in (("ms", "CUDA events, host included"
                         if dev.type == "cuda" else "host time"),
                        ("device_ms", "device time" if dev.type == "cuda"
                         else "host time, rehearsal")):
            m, sp = out[name][c]
            log(f"    {name} {what}: median {m:.4f} ms, spread {sp:.4f} "
                f"(runs {' '.join(f'{x:.4f}' for x in g[c])})")
        for kname, us in g["launches"].items():
            us = sorted(us)
            log(f"      {name} launch {kname[:70]}: {len(us)}x, min "
                f"{us[0]:.2f} us, p10 {us[len(us) // 10]:.2f}, median "
                f"{statistics.median(us):.2f}, p90 "
                f"{us[len(us) * 9 // 10]:.2f}, max {us[-1]:.2f}")
    return out


def stage0_for(arch, rep, gen, dev):
    from repro_torch.configs.base import TahomaCNNConfig
    from repro_torch.core.executor import Stage0
    from repro_torch.models.cnn import init_cnn, quantize_cnn
    cfg = TahomaCNNConfig(arch[0], arch[1], arch[2], input_hw=rep.resolution,
                          input_channels=rep.channels)
    params = init_cnn(gen, cfg, device=dev)
    return Stage0(params, rep, quantize_cnn(params)), cfg


def dyadic(n, hw, gen, dev):
    import torch
    return torch.randint(0, 256, (n, hw, hw, 3), generator=gen,
                         device=gen.device).to(dev).float() / 256.0


def check_stage0(imgs, out_res, s0, label) -> float:
    """Kernel vs plain version, f32 and int8: levels torch.equal, scores
    within SCORE_TOL. Returns the largest score deviation."""
    import torch

    from repro_torch.kernels.image_transform import fused_pyramid_stage0
    from repro_torch.kernels.ref import fused_pyramid_stage0_ref
    worst = 0.0
    for qp, kind in ((None, "f32"), (s0.qparams, "int8")):
        lv, sc = fused_pyramid_stage0(imgs, out_res, s0.params, s0.rep,
                                      qparams=qp)
        rl, rs = fused_pyramid_stage0_ref(imgs, out_res, s0.params, s0.rep,
                                          qparams=qp)
        for r in out_res:
            if not torch.equal(lv[r], rl[r]):
                raise AssertionError(f"{label} {kind}: level {r} differs "
                                     f"from the plain version")
        if sc.shape != rs.shape or not torch.isfinite(sc).all():
            raise AssertionError(f"{label} {kind}: bad scores")
        err = float((sc - rs).abs().max())
        log(f"  fused_pyramid_stage0 {label} {kind}: levels equal, "
            f"max |score err| {err:.3g}")
        if err > SCORE_TOL:
            raise AssertionError(f"{label} {kind}: score error {err} > "
                                 f"{SCORE_TOL}")
        worst = max(worst, err)
    return worst


def stage0_bound_ms(card, b, base, out_res, s0, cfg) -> tuple[float, str]:
    """Least time for one chunk: each input byte read once (frames and
    weights), each output written once, vs the f32 FLOPs of the pooling
    adds, color projection and CNN."""
    from repro_torch.core.transforms import plan_pyramid
    from repro_torch.models.cnn import cnn_flops
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(s0.params))
    nbytes = (b * base * base * 3 * 4 + wbytes + b * 4
              + sum(b * r * r * 3 * 4 for r in out_res))
    steps = plan_pyramid(set(out_res) | {s0.rep.resolution}, base)
    ops = b * (sum(st.source ** 2 * 3 for st in steps)
               + 5 * s0.rep.resolution ** 2 + cnn_flops(cfg))
    t_mem, t_ops = nbytes / card["bw"], ops / card["flops"]
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem > t_ops else "operations"


def _leaves(tree):
    import torch
    if torch.is_tensor(tree):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [t for v in vals for t in _leaves(v)]


def check_kernels(dev, cfg, card, seed):
    import torch

    from repro_torch.core.transforms import Representation
    from repro_torch.kernels.bindings import matmul_plan
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.ref import matmul_ref
    log("== kernels vs plain versions")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    b, base = cfg["chunk"], cfg["base"]
    res = cfg["resolutions"]
    imgs = dyadic(b, base, gen, dev)
    out_res = list(cfg["out_res"])
    # grid extremes, the main-path-sized case, and the trusted model
    cases = [((1, 16, 16), Representation(res[0], "gray")),
             ((4, 32, 64), Representation(res[3], "rgb")),
             ((2, 32, 64), Representation(res[1], "rgb")),
             ((3, 48, 64), Representation(res[3], "rgb"))]
    from repro_torch.kernels.image_transform import fused_pyramid_stage0
    from repro_torch.kernels.ref import fused_pyramid_stage0_ref
    worst = 0.0
    for arch, rep in cases:
        s0, s0cfg = stage0_for(arch, rep, gen, dev)
        worst = max(worst, check_stage0(imgs, out_res, s0,
                                        f"{rep.name} {arch}"))
        ms = time_ms(lambda: fused_pyramid_stage0(imgs, out_res, s0.params,
                                                  s0.rep), dev, cfg["iters"])
        plain = time_ms(lambda: fused_pyramid_stage0_ref(imgs, out_res,
                                                         s0.params, s0.rep),
                        dev, cfg["iters"])
        bound, by = stage0_bound_ms(card, b, base, out_res, s0, s0cfg)
        log(f"  fused_pyramid_stage0 {rep.name} {arch} chunk {b} f32: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} "
            f"ms ({by})")

    mm = {"max_abs_err": 0.0}
    for m, k, n in cfg["mm_shapes"]:
        for dt, out_dt in ((torch.float32, torch.float32),
                           (torch.bfloat16, torch.bfloat16),
                           (torch.bfloat16, torch.float32)):
            a = torch.randn((m, k), generator=gen, device=dev).to(dt)
            bm = torch.randn((k, n), generator=gen, device=dev).to(dt)
            got = matmul(a, bm, out_dtype=out_dt).float()
            again = matmul(a, bm, out_dtype=out_dt).float()
            want = matmul_ref(a, bm, out_dt).float()
            tol = MM_TOL[str(dt).split(".")[1]]
            bad = (got - want).abs() > tol + tol * want.abs()
            err = float((got - want).abs().max())
            log(f"  matmul ({m},{k})@({k},{n}) {dt}->{out_dt}: max |err| "
                f"{err:.3g} (tol {tol}), plan {matmul_plan(m, n, k)}, rerun "
                f"bit-identical: {torch.equal(got, again)}")
            if bad.any():
                raise AssertionError(f"matmul {m},{k},{n} {dt}: {err}")
            if not torch.equal(got, again):
                raise AssertionError(f"matmul {m},{k},{n} {dt}: a rerun "
                                     f"differs (split-K order not fixed)")
    return {"stage0": {"worst": worst}, "matmul": mm}


# ------------------------------------------------------------ phase 3 --
def build_bank(gen, dev, cfg):
    from repro_torch.configs.base import TahomaCNNConfig
    from repro_torch.configs.tahoma_cnn import architecture_space
    from repro_torch.core.pipeline import ModelBank, ModelEntry
    from repro_torch.core.transforms import Representation, COLOR_REPS
    from repro_torch.models.cnn import init_cnn
    archs = architecture_space(small=cfg["small_grid"])
    reps = [Representation(r, c) for r in cfg["resolutions"]
            for c in COLOR_REPS]
    entries = []
    for a in archs:
        for rep in reps:
            c = TahomaCNNConfig(a.n_conv_layers, a.conv_nodes, a.dense_nodes,
                                input_hw=rep.resolution,
                                input_channels=rep.channels)
            entries.append(ModelEntry(f"{c.arch_id}_{rep.name}", c, rep,
                                      init_cnn(gen, c, device=dev)))
    t = TahomaCNNConfig(3, 48, 64, input_hw=cfg["base"], input_channels=3)
    entries.append(ModelEntry(f"trusted_{t.arch_id}", t,
                              Representation(cfg["base"], "rgb"),
                              init_cnn(gen, t, device=dev), trusted=True))
    return ModelBank(entries, device=dev)


def make_corpus_on(dev, cfg, specs, seed):
    """Dyadic multi-predicate corpus, generated in batches on the host and
    kept on the device as one tensor."""
    import torch

    from repro_torch.data.synthetic import make_multi_corpus
    n, hw, gb = cfg["corpus"], cfg["base"], cfg["gen_batch"]
    corpus = torch.empty((n, hw, hw, 3), device=dev)
    for i, lo in enumerate(range(0, n, gb)):
        x, _ = make_multi_corpus(specs, min(gb, n - lo), hw=hw,
                                 seed=seed + 100 + i, positive_rate=0.4)
        corpus[lo:lo + len(x)] = torch.from_numpy(x).to(dev)
    return corpus


def check_stream_vs_dense(name, system):
    """The streaming frontier (kernel path) against the dense evaluator:
    every dense-frontier cascade is in the streaming survivor set (or
    tied with one to 1e-6), and matched cascades agree to f32 tolerance
    (the reference's test_streaming_matches_dense)."""
    from repro_torch.core.pareto import pareto_indices
    st = system.space_cache[("CAMERA", 3, True)]
    sp = system.cascade_space("CAMERA")
    if st.evaluated != len(sp):
        raise AssertionError(f"{name}: streaming scored {st.evaluated} "
                             f"cascades, dense {len(sp)}")
    lookup = {(int(k), int(a), int(b)): j for j, (k, a, b) in
              enumerate(zip(sp.kind, sp.i1, sp.i2))}
    for j in range(len(st)):
        d = lookup[(int(st.kind[j]), int(st.i1[j]), int(st.i2[j]))]
        if abs(st.acc[j] - sp.acc[d]) > 1e-5 or \
                abs(st.time_s[j] - sp.time_s[d]) > 2e-5 * sp.time_s[d]:
            raise AssertionError(f"{name}: cascade {d} differs")
    ids = {(int(k), int(a), int(b)) for k, a, b in
           zip(st.kind, st.i1, st.i2)}
    for i in pareto_indices(sp.acc, sp.throughput):
        ident = (int(sp.kind[i]), int(sp.i1[i]), int(sp.i2[i]))
        if ident not in ids and not any(
                abs(sp.acc[i] - st.acc[j]) < 1e-6
                and abs(sp.time_s[i] - st.time_s[j]) < 1e-6 * sp.time_s[i]
                for j in range(len(st))):
            raise AssertionError(f"{name}: frontier cascade {ident} lost")
    log(f"  {name}: streaming frontier ({len(st)} of {st.evaluated} "
        f"cascades) == dense frontier")


def boundary_rows(corpus, casc0, rows, int8, chunk):
    """Of ``rows`` (where engine and naive scan disagree), those whose
    first-cascade level-0 scores from the kernel and from the plain
    version (at the scan's batch width) fall on opposite sides of one of
    that level's f32 thresholds: a flip explained by the stated f32 score
    tolerance. Raises on any other row."""
    import numpy as np
    import torch

    from repro_torch.kernels.image_transform import fused_pyramid_stage0
    from repro_torch.kernels.ref import fused_pyramid_stage0_ref
    out = []
    s0 = casc0.stage0
    qp = s0.qparams if int8 else None
    lo, hi = casc0.thresholds[0]
    ts = [float(np.float32(t)) for t in ([0.5] if lo is None else [lo, hi])]
    for at in range(0, len(rows), chunk):
        part = np.asarray(rows[at:at + chunk], np.int64)
        idx = np.concatenate([part, np.repeat(part[-1:],
                                              chunk - len(part))])
        imgs = corpus[torch.as_tensor(idx, device=corpus.device)]
        _, sk = fused_pyramid_stage0(imgs, [], s0.params, s0.rep,
                                     qparams=qp)
        _, sp = fused_pyramid_stage0_ref(imgs, [], s0.params, s0.rep,
                                         qparams=qp)
        for r, a, b in zip(part, sk.tolist(), sp.tolist()):
            flips = any((a >= t) != (b >= t) or (a <= t) != (b <= t)
                        for t in ts)
            if abs(a - b) > SCORE_TOL or not flips:
                raise AssertionError(
                    f"row {r}: engine and naive_scan differ (kernel {a!r}, "
                    f"plain {b!r}, thresholds {ts})")
            out.append((int(r), a, b))
    return out


def query_path(dev, cfg, card, kern, seed):
    import numpy as np
    import torch

    from repro_torch.core.pipeline import system_from_bank
    from repro_torch.data.synthetic import DEFAULT_PREDICATES, make_corpus
    from repro_torch.engine.planner import (PredicateClause, QuerySpec,
                                            plan_query)
    from repro_torch.engine.scan import ScanEngine, level_schedule, naive_scan
    from repro_torch.kernels import ops

    log("== query path")
    specs = DEFAULT_PREDICATES[:3]
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    t0 = time.perf_counter()
    systems = {}
    for k, spec in enumerate(specs):
        bank = build_bank(gen, dev, cfg)
        cf = make_corpus(spec, cfg["split"], hw=cfg["base"], seed=seed + 10)
        ev = make_corpus(spec, cfg["split"], hw=cfg["base"], seed=seed + 20)
        systems[spec.name] = system_from_bank(bank, cf, ev)
        log(f"  {spec.name}: bank of {len(bank.entries)} models, system "
            f"from {cfg['split']}-frame splits")
    log(f"  banks + systems: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    corpus = make_corpus_on(dev, cfg, specs, seed)
    log(f"  corpus {tuple(corpus.shape)} on {corpus.device}: "
        f"{corpus.numel() * 4 / 1e9:.2f} GB, {time.perf_counter() - t0:.1f} s")
    query = QuerySpec(predicates=[PredicateClause(s.name) for s in specs])

    # ---- the main path, with the launch counts read around it
    ops.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    for system in systems.values():      # the matmul kernel's caller
        system.cascade_space("CAMERA", streaming=True)
    _sync(dev)
    t_eval = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = plan_query(systems, query, scenario="CAMERA", joint=True)
    t_plan = time.perf_counter() - t0
    runs = {}
    for int8 in (False, True):
        # a cold scan, then the timed one on a fresh store (same work; the
        # first also pays one-time allocator and library set-up)
        eng = ScanEngine(corpus, chunk=cfg["chunk"], int8=int8, device=dev)
        cold = eng.execute(plan.cascades)
        eng.reset_cache()
        _sync(dev)
        t0 = time.perf_counter()
        res = eng.execute(plan.cascades)
        _sync(dev)
        runs[int8] = (res, time.perf_counter() - t0, eng)
        if not np.array_equal(cold.indices, res.indices):
            raise AssertionError("a re-run on a fresh store differs")
    launches = dict(ops.LAUNCHES)
    log(f"  streaming evaluation (3 concepts): {t_eval:.3f} s; joint plan "
        f"(dense numpy spaces): {t_plan:.2f} s")
    log(plan.explain(n_rows=cfg["corpus"], base_hw=cfg["base"],
                     actual=runs[False][0].stats))
    launches = {k: launches[k] for k in ("fused_pyramid_stage0", "matmul")}
    log(f"  launches on the main path: {launches}")
    if dev.type == "cuda":
        for name, n in launches.items():
            if n == 0:
                raise AssertionError(f"{name} was not launched on the path")

    for name, system in systems.items():
        check_stream_vs_dense(name, system)
    casc0 = plan.cascades[0]
    for int8, (res, secs, _) in runs.items():
        st = res.stats
        kind = "int8" if int8 else "f32"
        log(f"  scan {kind}: {len(res.indices)} rows of {cfg['corpus']}, "
            f"{st.chunks} chunks, {secs * 1e3 / st.chunks:.3f} ms/chunk, "
            f"{cfg['corpus'] / secs:.0f} rows/s, rows evaluated per stage "
            f"{[s.rows_evaluated for s in st.stages]}, level rows "
            f"{st.level_rows}")
        t0 = time.perf_counter()
        ref = naive_scan(corpus, plan.cascades, chunk=cfg["chunk"],
                         int8=int8, device=dev)
        t_naive = time.perf_counter() - t0
        diff = np.setxor1d(res.indices, ref)
        exempt = boundary_rows(corpus, casc0, diff, int8, cfg["chunk"])
        log(f"  naive_scan {kind}: {len(ref)} rows in {t_naive:.2f} s; "
            f"identical rows: {not len(diff)}"
            + (f" except {len(exempt)} threshold-boundary rows "
               f"{exempt}" if exempt else ""))
    if dev.type == "cuda":
        _, secs, eng = runs[False]
        eng.reset_cache()      # rerun the timed scan: fresh store, same work
        device_profile(lambda: eng.execute(plan.cascades), dev, secs,
                       "scan profile (f32)")

    # the kernel's time and bound at the main path's own stage-0 shapes
    from repro_torch.kernels.image_transform import fused_pyramid_stage0
    from repro_torch.kernels.ref import fused_pyramid_stage0_ref
    base = cfg["base"]
    _, carry, _ = level_schedule(plan.cascades, base, True)
    out_res = sorted(({r.resolution for r in casc0.reps}
                      | set(carry[1] if len(carry) > 1 else ())) - {base},
                     reverse=True)
    imgs = corpus[:cfg["chunk"]]
    s0 = casc0.stage0
    worst = check_stage0(imgs, out_res, s0, f"main path {s0.rep.name}")
    k0 = next(e for e in systems[casc0.concept].bank.entries
              if e.params is s0.params)
    ms = time_ms(lambda: fused_pyramid_stage0(imgs, out_res, s0.params,
                                              s0.rep), dev, cfg["iters"])
    plain = time_ms(lambda: fused_pyramid_stage0_ref(imgs, out_res,
                                                     s0.params, s0.rep),
                    dev, cfg["iters"])
    bound, by = stage0_bound_ms(card, cfg["chunk"], base, out_res, s0,
                                k0.arch)
    kern["stage0"].update(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                          max_abs_err=max(worst, kern["stage0"]["worst"]),
                          shape=f"{k0.name} chunk {cfg['chunk']} base {base} "
                                f"levels {out_res}")
    log(f"  fused_pyramid_stage0 main path ({k0.name}, levels {out_res}): "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms "
        f"({by})")
    matmul_main_path(dev, cfg, card, kern, systems[casc0.concept])
    return launches


def device_profile(run, dev, wall_s, label, top=12):
    """Where ``run()``'s device time goes: torch.profiler over it, device
    time summed by kernel name, and the device's idle share against the
    unprofiled run's wall time ``wall_s`` (the profiler slows the host, not
    the kernels). Returns {kernel name: [launches, us]}, or None when the
    profiler saw no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        _sync(dev)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        log(f"  {label}: the profiler saw no device events; the breakdown "
            f"and idle share are not measured")
        return
    busy, end = 0.0, float("-inf")
    by_name: dict[str, list] = {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))   # union of device intervals
        end = max(end, e)
        acc = by_name.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += e - s
    log(f"  {label}: device busy {busy / 1e3:.3f} ms of the unprofiled "
        f"run's {wall_s * 1e3:.3f} ms wall; device idle share "
        f"{1 - busy / (wall_s * 1e6):.3f}")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]
                                )[:top]:
        log(f"    {us / 1e3:9.3f} ms {100 * us / busy:5.1f}% {n:6d}x "
            f"{name[:90]}")
    return by_name


def matmul_main_path(dev, cfg, card, kern, system):
    """The evaluator's own products: (128, I) @ (I, M) and (128, I) @
    (I, A) on its 0/1 indicator matrices, exact against the plain version;
    at both, kernel and torch.matmul in alternating order on both clocks,
    the plain version's time and the bound; then a large square product that
    shows the kernel's inner loop against cuBLAS's."""
    import numpy as np
    import torch

    from repro_torch.core.cascade import _certainty_stats
    from repro_torch.kernels.bindings import matmul_plan
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.ref import matmul_ref
    st = _certainty_stats(system.eval_scores, system.eval_truth,
                          system.p_low, system.p_high)
    c = torch.as_tensor(st["c"], device=dev)
    ca = c[:128].contiguous()
    c_t = c.T.contiguous()
    cf_t = torch.as_tensor(np.ascontiguousarray(st["corr_final"].T),
                           device=dev)
    err = 0.0
    for b in (cf_t, c_t):
        got, want = matmul(ca, b, out_dtype=torch.float32), matmul_ref(ca, b)
        e = float((got - want).abs().max())
        log(f"  matmul evaluator {tuple(ca.shape)}@{tuple(b.shape)} 0/1: "
            f"max |err| {e}")
        if e != 0.0:
            raise AssertionError("matmul on 0/1 indicators is not exact")
        err = max(err, e)
    it = max(cfg["iters"], 1) * 10
    rows = []
    for b in (c_t, cf_t):
        m, k = ca.shape
        n = b.shape[1]
        t = alternating(
            f"matmul ({m},{k})@({k},{n}) f32",
            (("kernel", lambda: matmul(ca, b, out_dtype=torch.float32)),
             ("torch.matmul", lambda: torch.matmul(ca, b))), dev, it)
        plain = time_ms(lambda: matmul_ref(ca, b), dev, it)
        t_mem = (m * k + k * n + m * n) * 4 / card["bw"]
        t_ops = 2.0 * m * n * k / card["flops"]
        row = {"ms": t["kernel"]["ms"][0], "plain_ms": plain,
               "library_ms": t["torch.matmul"]["ms"][0],
               "device_ms": t["kernel"]["device_ms"][0],
               "library_device_ms": t["torch.matmul"]["device_ms"][0],
               "bound_ms": max(t_mem, t_ops) * 1e3,
               "bound_by": "bytes" if t_mem > t_ops else "operations",
               "shape": f"({m},{k})@({k},{n}) f32, plan "
                        f"{matmul_plan(m, n, k)}"}
        rows.append(row)
        log(f"  matmul {row['shape']}: kernel {row['ms']:.4f} ms, plain "
            f"{plain:.4f} ms, torch.matmul {row['library_ms']:.4f} ms "
            f"(CUDA events); device time kernel {row['device_ms']:.4f} ms, "
            f"torch.matmul {row['library_device_ms']:.4f} ms; bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    kern["matmul"].update(rows[0], max_abs_err=err, other_shapes=rows[1:])
    s = cfg["mm_probe"]
    gen = torch.Generator(device=dev).manual_seed(5)
    a, b = (torch.randn((s, s), generator=gen, device=dev) for _ in "ab")
    ms = device_ms(lambda: matmul(a, b), dev, 3)
    lib = device_ms(lambda: torch.matmul(a, b), dev, 3)
    log(f"  matmul inner-loop probe ({s},{s})@({s},{s}) f32: kernel {ms:.4f} "
        f"ms ({2 * s ** 3 / ms / 1e9:.1f} TFLOP/s), torch.matmul {lib:.4f} "
        f"ms ({2 * s ** 3 / lib / 1e9:.1f} TFLOP/s)")


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


# ------------------------------------------------------------ phase 4 --
def lm_path(dev, cfg, card, kern, seed):
    """zamba2-1.2b prefill + greedy decode through ``launch.serve.serve``;
    returns the launch counts of the timed serve."""
    import torch

    from repro_torch.configs.registry import get_arch, smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.factory import build_model, count_params
    lm = cfg["lm"]
    log("== LM serve path")
    arch = get_arch(lm["arch"]) if lm["full"] else smoke_config(lm["arch"])
    model = build_model(arch)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    _sync(dev)
    log(f"  {arch.name}: {count_params(params):,} parameters ({arch.dtype}), "
        f"d_model {arch.d_model}, {arch.n_layers} Mamba-2 layers, the shared "
        f"attention block after every {arch.hybrid_attn_every}; random "
        f"weights in {time.perf_counter() - t0:.3f} s")
    b, s, n_gen = lm["batch"], lm["prompt"], lm["gen"]
    prompts = torch.randint(0, arch.vocab_size, (b, s), generator=gen,
                            device=dev)
    serve(model, params, prompts, 2, "bfloat16", device=dev)   # warm-up

    # ---- the main path, with the launch counts read around it
    ops.reset_launch_counts()
    res = serve(model, params, prompts, n_gen, "bfloat16", device=dev)
    launches = {k: ops.LAUNCHES[k] for k in ("flash_attention", "ssd_scan")}
    expect = {"flash_attention": arch.n_layers // arch.hybrid_attn_every,
              "ssd_scan": arch.n_layers}
    log(f"  served {b} prompts x {s} tokens + {n_gen} greedy decode steps, "
        f"bf16 KV: prefill {res.prefill_s * 1e3:.3f} ms "
        f"({b * s / res.prefill_s:.0f} prompt tok/s), decode "
        f"{res.decode_s * 1e3 / n_gen:.3f} ms/step "
        f"({b * n_gen / res.decode_s:.1f} tok/s)")
    log(f"  launches on the serve path: {launches} (one prefill; expected "
        f"{expect})")
    if dev.type == "cuda" and launches != expect:
        raise AssertionError(f"serve path launches {launches} != {expect}")
    toks, lg = res.tokens, res.logits
    if tuple(toks.shape) != (b, n_gen + 1) or not torch.isfinite(lg).all() \
            or int(toks.max()) >= arch.vocab_size or int(toks.min()) < 0:
        raise AssertionError("serve produced bad tokens or logits")
    log(f"  sample tokens: {toks[0, :8].tolist()}")
    check_lm_kernels(dev, cfg, card, kern, arch, gen)
    def prefill():
        return serve(model, params, prompts, 0, "bfloat16", device=dev)

    if dev.type == "cuda":
        kernels = device_profile(prefill, dev, res.prefill_s,
                                 "prefill profile (bf16)") or {}
        for name, (n, us) in sorted(kernels.items(), key=lambda kv:
                                    -kv[1][1]):
            if "copy" in name.lower():
                log(f"    copy kernel in prefill: {us / 1e3:9.3f} ms {n:6d}x "
                    f"{name[:90]}")
    perms = permute_copies(prefill, (b, arch.n_heads, s, arch.head_dim))
    log(f"  (B,S,H,D) <-> (B,H,S,D) copies in one prefill: {perms} (the "
        f"flash kernel takes the model's views and returns its layout; "
        f"{expect['flash_attention']} flash calls)")
    if dev.type == "cuda" and perms:
        raise AssertionError(f"prefill made {perms} permute copies around "
                             f"the flash kernel")
    if dev.type == "cuda":
        steps = 4
        t0 = time.perf_counter()
        serve(model, params, prompts[:, :8], steps, device=dev)
        log(f"  (decode profile: {steps} steps after an 8-token prefill)")
        device_profile(lambda: serve(model, params, prompts[:, :8], steps,
                                     device=dev), dev,
                       time.perf_counter() - t0, "prefill(8) + decode profile")
    consistency(lm, arch, params, prompts)
    return launches


def permute_copies(run, bhsd):
    """How many copies ``run()`` makes of a non-contiguous tensor shaped
    like the attention's (B,H,S,D) or (B,S,H,D) operands: the permutes a
    layout change around the flash kernel costs. Counted at the operator
    level (clone, copy_, _to_copy), through a dispatch mode."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    b, h, s, d = bhsd
    shapes = {(b, h, s, d), (b, s, h, d)}
    aten = torch.ops.aten
    copies = {aten.clone.default, aten.copy_.default, aten._to_copy.default}
    count = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in copies:
                src = args[1] if func is aten.copy_.default else args[0]
                if torch.is_tensor(src) and tuple(src.shape) in shapes \
                        and not src.is_contiguous():
                    count[0] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        run()
    return count[0]


def _close(got, want, atol, rtol):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
    return err, ok


def check_lm_kernels(dev, cfg, card, kern, arch, gen):
    """Both LM kernels against their plain versions at the serve path's
    shapes and at the reference tests' shapes, and their times."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref, ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    lm = cfg["lm"]
    b, s = lm["batch"], lm["prompt"]
    bf = torch.bfloat16

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    fl = {"max_abs_err": 0.0}
    path = (b, arch.n_heads, s, arch.head_dim)
    cases = [(shp, c, dt) for shp, c in [(path, True)] + [
        (shp, c) for shp in FLASH_TEST_SHAPES for c in (True, False)]
        for dt in (torch.float32, bf)]
    for (bb, h, sl, d), causal, dt in cases:
        for layout in ("(B,H,S,D)", "(B,S,H,D).transpose(1, 2)"):
            if layout == "(B,H,S,D)":
                q, k, v = (randn(bb, h, sl, d, dtype=dt, scale=0.5)
                           for _ in range(3))
            else:      # the strided views the model passes
                q, k, v = (randn(bb, sl, h, d, dtype=dt, scale=0.5
                                 ).transpose(1, 2) for _ in range(3))
            # bf16 is held against the plain version in f32, which rounds
            # neither the scores nor P: see FLASH_BF16_TOL
            tol = FLASH_BF16_TOL if dt == bf else (FLASH_TOL, FLASH_TOL)
            want = flash_attention_ref(q.float(), k.float(), v.float(),
                                       causal=causal)
            out = flash_attention(q, k, v, causal=causal)
            err, ok = _close(out, want, *tol)
            same = (out.is_contiguous() if layout == "(B,H,S,D)"
                    else out.transpose(1, 2).is_contiguous())
            log(f"  flash_attention {(bb, h, sl, d)} {layout} {dt} "
                f"causal={causal}: max |err| {err:.3g} (atol, rtol "
                f"{tol[0]:.3g}, {tol[1]:.3g}; mean |out| "
                f"{float(want.abs().mean()):.3g}); output in q's layout: "
                f"{same}")
            if not ok:
                raise AssertionError(f"flash_attention {path} {layout} {dt}: "
                                     f"{err}")
            if dev.type == "cuda" and not same:
                raise AssertionError(f"flash_attention {layout}: the output "
                                     f"is not laid out like q")
            fl["max_abs_err"] = max(fl["max_abs_err"], err)
    # the main path's input: (B,S,H,D) tensors seen as (B,H,S,D)
    q, k, v = (randn(b, s, arch.n_heads, arch.head_dim, dtype=bf
                     ).transpose(1, 2) for _ in range(3))
    it = cfg["iters"]
    t = alternating(
        f"flash_attention {path} bf16 causal on (B,S,H,D) views",
        (("kernel", lambda: flash_attention(q, k, v)),
         ("sdpa", lambda: F.scaled_dot_product_attention(q, k, v,
                                                          is_causal=True))),
        dev, it)
    fl.update(ms=t["kernel"]["ms"][0], library_ms=t["sdpa"]["ms"][0],
              device_ms=t["kernel"]["device_ms"][0],
              library_device_ms=t["sdpa"]["device_ms"][0],
              plain_ms=time_ms(lambda: flash_attention_ref(q, k, v), dev, it))
    bb, h, _, d = path
    t_ops = 4.0 * bb * h * d * s * (s + 1) / 2 / card["bf16"]
    t_mem = 4.0 * bb * h * s * d * 2 / card["bw"]
    fl.update(bound_ms=max(t_ops, t_mem) * 1e3,
              bound_by="operations" if t_ops > t_mem else "bytes",
              shape=f"q,k,v {path} bf16 causal, (B,S,H,D).transpose(1, 2) "
                    f"views")
    log(f"  flash_attention {path} bf16 causal: kernel {fl['ms']:.4f} ms, "
        f"plain {fl['plain_ms']:.4f} ms, sdpa {fl['library_ms']:.4f} ms "
        f"(CUDA events); device time kernel {fl['device_ms']:.4f} ms, sdpa "
        f"{fl['library_device_ms']:.4f} ms; bound {fl['bound_ms']:.4f} ms "
        f"({fl['bound_by']})")

    ss = {"max_abs_err": 0.0}
    h, p, n = arch.ssm_heads, arch.ssm.head_dim, arch.ssm.d_state
    chunk = arch.ssm.chunk_size

    def ssd_inputs(bb, sl, hh, pp, nn, dt):
        return (randn(bb, sl, hh, pp, dtype=dt, scale=0.5),
                torch.rand((bb, sl, hh), generator=gen, device=dev) * 0.1,
                -torch.rand((hh,), generator=gen, device=dev) * 2,
                randn(bb, sl, nn, dtype=dt, scale=0.3),
                randn(bb, sl, nn, dtype=dt, scale=0.3))

    cases = [((b, s, h, p, n), chunk, bf)] + [
        (shp, c, torch.float32) for shp in SSD_TEST_SHAPES
        for c in (16, 32, 64)]
    for shp, c, dt in cases:
        args = ssd_inputs(*shp, dt)
        (y, fin), (yr, fr) = (ssd_scan(*args, chunk=c),
                              ssd_scan_ref(*args, chunk=c))
        ey, oky = _close(y, yr, *SSD_TOL)
        ef, okf = _close(fin, fr, *SSD_TOL)
        log(f"  ssd_scan x {shp[:4]} N {shp[4]} {dt} chunk {c}: max |err| "
            f"y {ey:.3g}, final state {ef:.3g} (tol {SSD_TOL})")
        if not (oky and okf):
            raise AssertionError(f"ssd_scan {shp} chunk {c}: {ey}, {ef}")
        ss["max_abs_err"] = max(ss["max_abs_err"], ey, ef)
    args = ssd_inputs(b, s, h, p, n, bf)
    ss["ms"] = time_ms(lambda: ssd_scan(*args, chunk=chunk), dev, it)
    ss["plain_ms"] = time_ms(lambda: ssd_scan_ref(*args, chunk=chunk), dev,
                             it)
    t_ops = 4.0 * b * s * h * p * n / card["flops"]
    nbytes = (b * s * h * p * 2 + b * s * h * 4 + h * 4 + 2 * b * s * n * 2
              + b * s * h * p * 4 + b * h * p * n * 4)
    t_mem = nbytes / card["bw"]
    ss.update(bound_ms=max(t_ops, t_mem) * 1e3,
              bound_by="operations" if t_ops > t_mem else "bytes",
              library_ms=None,
              shape=f"x ({b},{s},{h},{p}) bf16, N {n}, chunk {chunk}")
    log(f"  ssd_scan x ({b},{s},{h},{p}) bf16 N {n}: kernel {ss['ms']:.4f} "
        f"ms, plain {ss['plain_ms']:.4f} ms, bound {ss['bound_ms']:.4f} ms "
        f"({ss['bound_by']}); no single PyTorch call computes it")
    kern["flash_attention"], kern["ssd_scan"] = fl, ss


def consistency(lm, arch, params, prompts):
    """In an f32 copy of the model: ``prefill`` on the first ``check_at``
    tokens, then one ``decode_step``, against ``forward`` over all of them
    at those positions (the kernel path vs the plain decode recurrences)."""
    import torch

    from repro_torch.launch.serve import grow_cache
    from repro_torch.models.factory import build_model
    c = lm["check_at"]
    m32 = build_model(arch.replace(dtype="float32"))

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        return tree.float()

    p32 = f32(params)
    full, _, _ = m32.forward(p32, {"tokens": prompts})
    last, cache = m32.prefill(p32, {"tokens": prompts[:, :c]},
                              kv_dtype="float32")
    step, _ = m32.decode(p32, grow_cache(cache, 1),
                         {"tokens": prompts[:, c:c + 1]})
    for name, got, want in (("prefill", last, full[:, c - 1]),
                            ("decode_step", step, full[:, c])):
        rel = float((got - want).abs().max() / want.abs().max())
        same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
        log(f"  f32 {name} at position {c - (name == 'prefill')} vs "
            f"forward over {prompts.shape[1]} tokens: max |diff| / max "
            f"|logit| {rel:.3g} (tol {CONSIST_TOL}), argmax identical: {same}")
        if rel > CONSIST_TOL or not same or not torch.isfinite(got).all():
            raise AssertionError(f"{name} disagrees with forward: {rel}")
    log("  prefill + decode_step == forward (f32, kernel path vs the plain "
        "decode recurrences)")


# ------------------------------------------------------------ phase 5 --
def ops_path(dev, cfg, card, kern, seed):
    """The two transform kernels through the ``kernels/ops`` entry points
    at the query path's chunk and base; returns their launch counts."""
    import torch

    from repro_torch.core.transforms import COLOR_REPS
    from repro_torch.kernels import ops
    log("== kernel entry points (kernels/ops)")
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    b, base = cfg["chunk"], cfg["base"]
    specs = tuple((r, c) for r in cfg["resolutions"] for c in COLOR_REPS)
    imgs = dyadic(b, base, gen, dev)

    def run(x):
        return {"fused_pyramid_transform": ops.pyramid_transform_op(
                    x, specs=specs),
                "fused_transform": [ops.transform_op(x, res=r, color=c)
                                    for r, c in specs]}

    # ---- the main path, with the launch counts read around it
    ops.reset_launch_counts()
    outs = run(imgs)
    _sync(dev)
    names = ("fused_transform", "fused_pyramid_transform")
    launches = {k: ops.LAUNCHES[k] for k in names}
    expect = {"fused_transform": len(specs), "fused_pyramid_transform": 1}
    log(f"  {len(specs)} specs {specs[0]}..{specs[-1]} on {b} x {base} px "
        f"frames; launches on the entry points: {launches} (expected "
        f"{expect})")
    if dev.type == "cuda" and launches != expect:
        raise AssertionError(f"entry-point launches {launches} != {expect}")

    worst = dict.fromkeys(names, 0.0)

    def hold(label, x, got):
        exact_input = label == "dyadic"
        wants = [_transform_ref(x, r, c) for r, c in specs]
        for name in names:
            err_by = {"gray": 0.0, "other": 0.0}
            for o, want, (r, c) in zip(got[name], wants, specs):
                if o.shape != want.shape or not torch.isfinite(o).all():
                    raise AssertionError(f"{name} ({r}, {c}): bad output")
                err = float((o - want).abs().max())
                if exact_input and c != "gray":
                    ok = torch.equal(o, want)
                else:
                    ok = err <= (TRANSFORM_GRAY_TOL if exact_input
                                 else TRANSFORM_TOL)
                if not ok:
                    raise AssertionError(f"{name} ({r}, {c}) on {label} "
                                         f"frames: max |err| {err}")
                key = "gray" if c == "gray" else "other"
                err_by[key] = max(err_by[key], err)
            worst[name] = max(worst[name], *err_by.values())
            log(f"  {name} on {label} frames, all {len(specs)} outputs: "
                + (f"rgb/r/g/b equal, gray max |err| {err_by['gray']:.3g} "
                   f"(tol {TRANSFORM_GRAY_TOL})" if exact_input else
                   f"max |err| {max(err_by.values()):.3g} (tol "
                   f"{TRANSFORM_TOL})"))

    hold("dyadic", imgs, outs)
    del outs
    x = torch.rand((b, base, base, 3), generator=gen, device=dev)
    hold("torch.rand", x, run(x))
    transform_times(dev, cfg, card, kern, imgs, specs, worst)
    return launches


def _transform_ref(x, res, color):
    from repro_torch.kernels.ops import COLOR_WEIGHTS
    from repro_torch.kernels.ref import fused_transform_ref
    return fused_transform_ref(x, COLOR_WEIGHTS[color], res)


def transform_times(dev, cfg, card, kern, imgs, specs, worst):
    """Each transform kernel's time at one stated shape: the kernel alone
    (a prepared launch; through the entry point on the CPU), the entry
    point, the plain version, one F.conv2d where one computes the same
    function, and the bytes/operations bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.transforms import plan_pyramid
    from repro_torch.kernels import bindings, ops
    from repro_torch.kernels.image_transform import transform_params
    from repro_torch.kernels.ref import fused_pyramid_transform_ref
    b, base = imgs.shape[0], imgs.shape[1]
    it = cfg["iters"] * 10
    r1, c1 = cfg["resolutions"][1], "gray"    # 224 -> 56: factor 4
    cases = (("fused_transform", ((r1, c1),), bindings.launch_fused_transform,
              lambda: ops.transform_op(imgs, res=r1, color=c1)),
             ("fused_pyramid_transform", specs,
              bindings.launch_fused_pyramid_transform,
              lambda: ops.pyramid_transform_op(imgs, specs=specs)))
    for name, sp, launch, entry in cases:
        cws = [(r, ops.COLOR_WEIGHTS[c]) for r, c in sp]
        entry_ms = time_ms(entry, dev, it)
        if dev.type == "cuda":
            prm, _outs = transform_params(imgs, cws)   # outputs kept alive
            ms = time_ms(lambda: launch(prm), dev, it)
        else:
            ms = entry_ms
        plain = time_ms(lambda: fused_pyramid_transform_ref(imgs, cws), dev,
                        it)
        nbytes = 4 * b * (base * base * 3 + sum(
            r * r * ops.COLOR_WEIGHTS[c].shape[1] for r, c in sp))
        # pooling adds along the plan, then 3 products + 2 adds per output
        # value and its normalization (2)
        nops = b * (sum(st.source ** 2 * 3 for st in plan_pyramid(
            [r for r, _ in sp], base)) + sum(
                r * r * ops.COLOR_WEIGHTS[c].shape[1] * 7 for r, c in sp))
        t_mem, t_ops = nbytes / card["bw"], nops / card["flops"]
        k = {"max_abs_err": worst[name], "ms": ms, "plain_ms": plain,
             "bound_ms": max(t_mem, t_ops) * 1e3,
             "bound_by": "bytes" if t_mem > t_ops else "operations",
             "library_ms": None,
             "shape": f"{b} x {base} px -> " + (
                 f"{sp[0]}" if len(sp) == 1 else f"all {len(sp)} specs")}
        lib = ""
        if name == "fused_transform":
            r, c = sp[0]
            f = base // r
            cw = torch.as_tensor(ops.COLOR_WEIGHTS[c], device=dev)
            w = (cw.T / (f * f * 0.25)).reshape(-1, 3, 1, 1).expand(
                -1, 3, f, f).contiguous()
            bias = torch.full((cw.shape[1],), -0.5 / 0.25, device=dev)
            nchw = imgs.permute(0, 3, 1, 2)      # channels-last view
            k["library_ms"] = time_ms(
                lambda: F.conv2d(nchw, w, bias, stride=f), dev, it)
            got = F.conv2d(nchw, w, bias, stride=f).permute(0, 2, 3, 1)
            lib_err = float((got - _transform_ref(imgs, r, c)).abs().max())
            lib = (f", F.conv2d {k['library_ms']:.4f} ms (max |diff| "
                   f"{lib_err:.3g})")
        kern[name] = k
        log(f"  {name} {k['shape']}: kernel {ms:.4f} ms (entry point "
            f"{entry_ms:.4f} ms), plain {plain:.4f} ms{lib}, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']})")


# ------------------------------------------------------------ phase 6 --
def kernels_line(kern, launches):
    meta = {
        "fused_pyramid_stage0": (
            "src/repro_torch/kernels/csrc/pyramid_stage0.cu",
            "src/repro/kernels/image_transform.py:280", kern["stage0"]),
        "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                   "src/repro/kernels/matmul.py:46", kern["matmul"]),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:78",
                            kern["flash_attention"]),
        "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:81", kern["ssd_scan"]),
        "fused_transform": ("src/repro_torch/kernels/csrc/image_transform.cu",
                            "src/repro/kernels/image_transform.py:73",
                            kern["fused_transform"]),
        "fused_pyramid_transform": (
            "src/repro_torch/kernels/csrc/image_transform.cu",
            "src/repro/kernels/image_transform.py:125",
            kern["fused_pyramid_transform"]),
    }
    out = []
    for name, (src, replaces, k) in meta.items():
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                    "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                    "bound_by": k["bound_by"],
                    "library_ms": k.get("library_ms"),
                    "shape": k["shape"],
                    **{key: k[key] for key in ("device_ms",
                                               "library_device_ms",
                                               "other_shapes") if key in k}})
    print(json.dumps({"kernels": out}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
