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
   scores within SCORE_TOL; each timed on both clocks) and ``matmul`` (random f32/bf16 at ragged
   shapes and both evaluator shapes, within the reference test's
   tolerances, each rerun bit-identical: split-K adds in a fixed order),
   with kernel, plain, bound and library times.
3. Query path: three predicates, each initialized on the card by
   ``initialize_system``: a 361-model bank over the paper grid (18
   architectures x {28, 56, 112, 224} px x 5 colors, plus the trusted
   model) trained with BCE + AdamW (120 steps, batch 16, lr 3e-3; the
   trusted model 360) on 1024 frames, thresholds from a 512-frame config
   split, scores on a 512-frame eval split, and the per-model inference
   costs pinned in COSTS (measured again and printed beside them). Each
   bank is held to the learning floors (best model and trusted model
   eval accuracy); the streaming cascade-space evaluator runs through the
   matmul kernel (checked against the dense evaluator), then a joint
   plan and ``ScanEngine`` over 8192 dyadic 224 px frames resident on
   the card, fused through the pyramid+stage-0 kernel, f32 and int8,
   each held against ``naive_scan``. Launch counts are reset just before
   training and read just after the scans; a kernel of the path with 0
   launches fails. Per predicate: training time and steps/s,
   accuracies, the Pareto frontier's size and the paper's Fig. 6/7
   speedups over the trusted model (core/alc, INFER_ONLY and CAMERA,
   modeled from the pinned costs). The dense evaluator's acc and time of
   every planned and frontier cascade are held to the per-image oracles
   (``simulate_cascade``, ``cascade_time_naive``). The f32 scan is then
   rerun under ``torch.profiler``: device time by kernel and the device's
   idle share. ``fit_cnn``'s loop (a CUDA graph on the card) must equal
   its step run eagerly, and the planned stage-0 model and the trusted
   model, trained again from the same seed, the bank's, bit for bit; a
   short training run of each is profiled. The evaluator's two products,
   (128, 512) @ (512, A) and (128, 512) @ (512, M) on its 0/1 matrices,
   are exact; kernel and ``torch.matmul`` in alternating order, each on
   two clocks (CUDA events around back-to-back calls, the clock of every
   ``ms`` in the kernels line, and profiler device time, per launch too;
   median and spread), plain and bound; a 2048^3 probe compares the
   kernel's inner loop with cuBLAS's.
   Ingest and algebra, on the same trained systems, plan and corpus
   (nothing trained again): a 4096-frame 224 px camera stream (scenes
   held 1-4 frames, +-1/256 sensor jitter) arrives on the host in batches
   of 512 and goes through ``build_ingest_pipeline(plan.cascades, chunk
   256, skip_threshold=None)``: the skip detector on the host, the
   references' stage 0 through the pyramid+stage-0 kernel (the anchor
   concept) and ``models/cnn`` (the others). Launch counts are reset
   just before and read just after: one kernel launch per scored chunk.
   Aliases stay inside their scene, one reference per scene after
   calibration, and the anchor's ingest scores equal the kernel's on
   the same padded chunk. Re-planned with ``index=``, the stream (on the
   card) is scanned by ``indexed_execute`` (exact), cold, by
   ``naive_scan`` and in approx mode (measured recall per concept); three
   expression trees over the 8192-frame corpus run through
   ``execute_tree`` optimized and not, against ``naive_tree_rows``; a
   ``Join(a, a, delta_t=2)`` over two 2048-frame cameras runs through
   ``execute_join`` against ``naive_join_pairs``. Row sets and pairs
   must be equal apart from counted threshold-boundary rows (two routes'
   level-0 scores within SCORE_TOL across a threshold). The kernels
   line's stage-0 launches add the phase's (``ingest_launches`` names the
   ingest path's).
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
   against the plain decode recurrences). ``ssd_scan`` is also held
   against its plain version at mamba2-130m's shape (24 heads, N 128) and
   at the reference tests' shapes in bf16 (the tensor-core kernel) as well
   as f32 (the FFMA kernel), and timed at both model shapes.
5. Kernel entry points (``kernels/ops``), the twin of the reference's
   ``bench_transform_kernel`` at the query path's width: a chunk of 256
   dyadic 224 px frames through ``pyramid_transform_op`` with all 20
   (resolution, color) specs of the bank's representation space in one
   launch, and through ``transform_op`` once per spec. Launch counts are
   reset just before and read just after: 20 ``fused_transform`` and 1
   ``fused_pyramid_transform``. Every output is held against its plain
   version (rgb/r/g/b ``torch.equal``, gray within TRANSFORM_GRAY_TOL), and
   again on ``torch.rand`` frames within TRANSFORM_TOL; then kernel (on
   two clocks: CUDA events and profiler device time), plain, bound and
   library (``F.conv2d``) times and the pyramid kernel's TB/s. Then
   ``fused_pyramid_transform``'s other paths (``pyramid_cases``: a plan
   that is no chain, a (3, 3) projection that is no identity, a chain at
   a base no multiple of 16, frames off 16-byte alignment, B = 1, B =
   chunk + 1), each held against the plain
   version the same way on dyadic frames and timed.
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
# per-model inference costs the query phase plans with (measured on the
# card by benchmarks/torch_infer_costs.py)
COSTS = SRC / "repro_torch" / "configs" / "infer_costs_h100.json"

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

# floors: the least eval accuracy of the best model and of the trusted
# model (tests/test_system.py's)
FULL = dict(base=224, chunk=256, out_res=(112, 56, 28), split=512,
            train=1024, steps=120, floors=(0.85, 0.80), pinned=True,
            profile_steps=10, corpus=8192, gen_batch=512, stream=4096,
            stream_batch=512, join=2048,
            resolutions=(28, 56, 112, 224),
            small_grid=False, mm_shapes=((33, 17, 65), (256, 64, 130),
                                         (128, 512, 1805), (128, 512, 361)),
            mm_probe=2048, iters=10,
            lm=dict(arch="zamba2-1.2b", full=True, batch=8, prompt=512,
                    gen=32, check_at=256))
# the rehearsal's few steps teach its toy models little: no learning floor
REHEARSE = dict(base=32, chunk=32, out_res=(16, 8, 4), split=48, train=48,
                steps=3, floors=(0.0, 0.0), pinned=False, corpus=96,
                gen_batch=48, stream=96, stream_batch=40, join=48,
                resolutions=(4, 8, 16, 32), small_grid=True,
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
    launches, query = query_path(dev, cfg, card, kern, args.seed)
    ingest = ingest_algebra_path(dev, cfg, kern, args.seed, query)
    del query
    launches["fused_pyramid_stage0"] += ingest
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


def device_ms(fn, dev, iters: int, launches=None):
    """Device time of one ``fn()``: for each kernel (or memset) it
    launches, the median duration of its launches times its launches per
    call, from torch.profiler over ``iters`` calls. Host time between
    launches is not in it, so a call whose host work outlasts its kernels
    is not host-bound here (time_ms shows that). CUPTI tracing, at times,
    loses device events: the medians and the rounded launches per call
    stand up to a lost part; a session that recorded no event at all is
    opened again, at most PROFILER_SESSIONS in all, and then the device
    time is None (not measured: the CUDA-event clock, time_ms, still is).
    With a dict ``launches``, each launch's duration (us) is appended to
    ``launches[kernel name]``. On the CPU (rehearsal) it is time_ms."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if dev.type != "cuda":
        return time_ms(fn, dev, iters)
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(
                    e.time_range.end - e.time_range.start)
        if by_name:
            break
    else:
        log(f"    (device time not measured: {PROFILER_SESSIONS} profiler "
            f"sessions recorded no device event)")
        return None
    if any(len(us) % iters for us in by_name.values()):
        log(f"    (the profiler lost device events: "
            f"{sum(map(len, by_name.values()))} for {iters} calls of "
            f"{len(by_name)} kernels; per-launch medians used)")
    for name, us in by_name.items() if launches is not None else ():
        launches.setdefault(name, []).extend(us)
    return sum(statistics.median(us) * max(1, round(len(us) / iters))
               for us in by_name.values()) / 1e3


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


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
        out[name] = {}
        for c, what in (("ms", "CUDA events, host included"
                         if dev.type == "cuda" else "host time"),
                        ("device_ms", "device time" if dev.type == "cuda"
                         else "host time, rehearsal")):
            runs = [x for x in g[c] if x is not None]
            m, sp = ((statistics.median(runs), max(runs) - min(runs))
                     if runs else (None, None))
            out[name][c] = (m, sp)
            log(f"    {name} {what}: median {_ms(m)} ms, spread {_ms(sp)} "
                f"(runs {' '.join(_ms(x) for x in g[c])})")
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
    # grid extremes, the main-path-sized case, the trusted model, and
    # widths that are no multiple of 4 (the one-channel conv and the
    # unvectorized dense pass)
    cases = [((1, 16, 16), Representation(res[0], "gray")),
             ((4, 32, 64), Representation(res[3], "rgb")),
             ((2, 32, 64), Representation(res[1], "rgb")),
             ((3, 48, 64), Representation(res[3], "rgb")),
             ((1, 15, 13), Representation(res[0], "rgb"))]
    from repro_torch.kernels.image_transform import fused_pyramid_stage0
    from repro_torch.kernels.ref import fused_pyramid_stage0_ref
    worst = 0.0
    for arch, rep in cases:
        s0, s0cfg = stage0_for(arch, rep, gen, dev)
        worst = max(worst, check_stage0(imgs, out_res, s0,
                                        f"{rep.name} {arch}"))
        ms = time_ms(lambda: fused_pyramid_stage0(imgs, out_res, s0.params,
                                                  s0.rep), dev, cfg["iters"])
        dms = device_ms(lambda: fused_pyramid_stage0(imgs, out_res,
                                                     s0.params, s0.rep),
                        dev, cfg["iters"])
        plain = time_ms(lambda: fused_pyramid_stage0_ref(imgs, out_res,
                                                         s0.params, s0.rep),
                        dev, cfg["iters"])
        bound, by = stage0_bound_ms(card, b, base, out_res, s0, s0cfg)
        log(f"  fused_pyramid_stage0 {rep.name} {arch} chunk {b} f32: "
            f"kernel {ms:.4f} ms (device {_ms(dms)}), plain {plain:.4f} ms, "
            f"bound {bound:.4f} ms ({by})")

    # the pooling kernel's other paths: levels that are no chain 2, 4, 8
    # times smaller than the base (pooled in shared memory, tiles narrower
    # than a row), and frames whose rows are not 16-byte aligned (loaded
    # without the bulk-copy ring)
    s0, _ = stage0_for((1, 16, 16), Representation(res[0], "gray"), gen, dev)
    worst = max(worst, check_stage0(imgs, [res[2], base // 16], s0,
                                    "levels no chain"))
    shifted = torch.empty(imgs.numel() + 1, device=dev)[1:].view_as(imgs)
    shifted.copy_(imgs)
    worst = max(worst, check_stage0(shifted, out_res, s0,
                                    "frames 4 bytes off 16-byte alignment"))

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
def grid(cfg):
    """The query phase's model grid: its architectures, its
    representations ({resolutions} x five colors), and {entry name: sized
    config} in ``train_model_grid``'s order, the trusted model last."""
    from repro_torch.configs.base import TahomaCNNConfig
    from repro_torch.configs.tahoma_cnn import architecture_space
    from repro_torch.core.transforms import COLOR_REPS, Representation
    archs = architecture_space(small=cfg["small_grid"])
    reps = [Representation(r, c) for r in cfg["resolutions"]
            for c in COLOR_REPS]
    sized = {}
    for a in archs:
        for rep in reps:
            c = TahomaCNNConfig(a.n_conv_layers, a.conv_nodes, a.dense_nodes,
                                input_hw=rep.resolution,
                                input_channels=rep.channels)
            sized[f"{c.arch_id}_{rep.name}"] = c
    t = TahomaCNNConfig(3, 48, 64, input_hw=cfg["base"], input_channels=3)
    sized[f"trusted_{t.arch_id}"] = t
    return archs, reps, sized


def pinned_costs(cfg, sized):
    """The per-model inference costs (s/image) the query phase plans with:
    COSTS (measured by benchmarks/torch_infer_costs.py on the card named
    in it) at full size, raising on a name missing or extra; at the
    rehearsal's toy grid, each model's FLOPs at 1 TFLOP/s."""
    from repro_torch.models.cnn import cnn_flops
    if not cfg["pinned"]:
        log("  pinned inference costs: rehearsal grid, FLOPs at 1 TFLOP/s")
        return {n: cnn_flops(c) / 1e12 for n, c in sized.items()}, "toy"
    data = json.loads(COSTS.read_text())
    missing = sorted(set(sized) - set(data["infer_s"]))
    extra = sorted(set(data["infer_s"]) - set(sized))
    if missing or extra:
        raise AssertionError(f"{COSTS.name}: missing {missing}, extra "
                             f"{extra}")
    label = f"{data['card']}, {data['power_limit']}"
    log(f"  pinned inference costs: {COSTS.relative_to(ROOT)} ({label}; "
        f"{data['method']})")
    return {n: float(data["infer_s"][n]) for n in sized}, label


def train_systems(dev, cfg, seed, specs, archs, reps, sized, infer_s):
    """``initialize_system`` per predicate on the card: the grid and the
    trusted model trained on a ``cfg["train"]``-frame split, thresholds
    from the config split, eval scores, costs pinned to ``infer_s``. Prints
    training time, steps/s and accuracies and holds them to the learning
    floors (check a); also measures the costs once more and prints them
    against the pinned ones. -> ({name: system}, {name: host train
    split})."""
    import numpy as np

    from repro_torch.core.pipeline import (initialize_system,
                                           profile_infer_costs)
    from repro_torch.data.synthetic import make_corpus
    base, steps = cfg["base"], cfg["steps"]
    n_steps = len(archs) * len(reps) * steps + 3 * steps
    floor_best, floor_trusted = cfg["floors"]
    systems, train = {}, {}
    for spec in specs:
        t0 = time.perf_counter()
        tr = make_corpus(spec, cfg["train"], hw=base, seed=seed + 30)
        cf = make_corpus(spec, cfg["split"], hw=base, seed=seed + 10)
        ev = make_corpus(spec, cfg["split"], hw=base, seed=seed + 20)
        t_data = time.perf_counter() - t0
        marks = []

        def mark(_msg):
            _sync(dev)      # each model's steps end on the card, not the host
            marks.append(time.perf_counter())

        _sync(dev)
        t0 = time.perf_counter()
        system = initialize_system(tr, cf, ev, archs, reps, steps=steps,
                                   seed=seed, log=mark, infer_s=infer_s,
                                   device=dev)
        t_all = time.perf_counter() - t0
        t_train = marks[-1] - t0
        if system.bank.names != list(sized):
            raise AssertionError(f"{spec.name}: bank names differ from the "
                                 f"grid's")
        secs = np.diff([t0] + marks)
        by_res = {r: float(sum(d for d, e in zip(secs, system.bank.entries)
                               if e.rep.resolution == r and not e.trusted))
                  for r in cfg["resolutions"]}
        acc = ((system.eval_scores >= 0.5)
               == system.eval_truth[None].astype(bool)).mean(1)
        ti = system.bank.trusted_index
        best = int(np.argmax(acc))
        log(f"  {spec.name}: {len(system.bank.entries)} models trained on "
            f"{cfg['train']} frames ({cfg['split']}-frame config and eval "
            f"splits, made in {t_data:.1f} s): {n_steps} steps in "
            f"{t_train:.2f} s ({n_steps / t_train:.0f} steps/s), then "
            f"thresholds and eval scores in {t_all - t_train:.2f} s; "
            f"training seconds by input size "
            f"{ {r: round(d, 2) for r, d in by_res.items()} }, trusted "
            f"{secs[-1]:.2f}")
        log(f"  {spec.name}: eval accuracy best {acc[best]:.4f} "
            f"({system.bank.names[best]}), trusted {acc[ti]:.4f}, bank mean "
            f"{acc.mean():.4f} (floors: best > {floor_best}, trusted > "
            f"{floor_trusted})")
        if not (acc[best] > floor_best and acc[ti] > floor_trusted):
            raise AssertionError(f"{spec.name}: the models did not learn")
        measured = profile_infer_costs(system.bank, ev[0])
        ratio = sorted(measured[n] / infer_s[n] for n in sized)
        log(f"  {spec.name}: inference costs measured in this run / pinned: "
            f"min {ratio[0]:.3f}, median {ratio[len(ratio) // 2]:.3f}, max "
            f"{ratio[-1]:.3f} (the plan uses the pinned ones)")
        systems[spec.name] = system
        train[spec.name] = tr
    return systems, train


def paper_figures(name, system, cost_label):
    """The paper's Fig. 6 and Fig. 7 figures of one predicate's trained
    system through core/alc: the cascade that best matches the trusted
    model's accuracy, and the fastest cascade, each over the trusted
    model alone, under INFER_ONLY and CAMERA (dense spaces), and the
    CAMERA Pareto frontier's size."""
    import numpy as np

    from repro_torch.core.alc import best_matching
    from repro_torch.core.selector import pareto_set
    ti = system.bank.trusted_index
    log(f"  {name}: Pareto frontier (CAMERA) "
        f"{len(pareto_set(system.cascade_space('CAMERA')))} cascades")
    for scen in ("INFER_ONLY", "CAMERA"):
        sp = system.cascade_space(scen)
        j = best_matching(sp.acc, sp.throughput, sp.acc[ti])
        f = int(np.argmax(sp.throughput))
        log(f"  {name} {scen}, modeled from the pinned costs ({cost_label}): "
            f"Fig. 6 best match at the trusted model's accuracy "
            f"{sp.acc[ti]:.4f}: {sp.throughput[j] / sp.throughput[ti]:.2f}x "
            f"the trusted model (acc {sp.acc[j]:.4f}, "
            f"{sp.describe(j, system.bank.names, system.targets)}); Fig. 7 "
            f"fastest cascade {sp.throughput[f] / sp.throughput[ti]:.2f}x "
            f"(acc {sp.acc[f]:.4f})")


def check_oracles(plan, systems):
    """Check c: for every cascade of the plan and of each predicate's CAMERA
    Pareto frontier, the dense evaluator's acc and time on the trained
    eval scores equal the per-image oracles ``simulate_cascade`` and
    ``cascade_time_naive`` (abs 1e-5 on acc, rel 1e-5 on time:
    tests/test_cascade.py's tolerances)."""
    import numpy as np

    from repro_torch.core.cascade import (cascade_time_naive,
                                          simulate_cascade, spec_levels)
    from repro_torch.core.selector import pareto_set
    worst = [0.0, 0.0]
    n = 0
    for name, system in systems.items():
        sp = system.cascade_space(plan.scenario)
        picks = {int(p.selection.index) for p in plan.predicates
                 if p.cascade.concept == name}
        infer = np.array([system.infer_s[m] for m in system.bank.names])
        for i in sorted(picks | {int(i) for i in pareto_set(sp)}):
            levels = spec_levels(sp, i, system.p_low, system.p_high)
            acc, _ = simulate_cascade(levels, system.eval_scores,
                                      system.eval_truth)
            t = cascade_time_naive(levels, system.eval_scores,
                                   system.bank.reps, infer, system.profile,
                                   plan.scenario)
            e_acc, e_t = abs(sp.acc[i] - acc), abs(sp.time_s[i] - t) / t
            if e_acc > 1e-5 or e_t > 1e-5:
                raise AssertionError(f"{name}: cascade {i} acc {sp.acc[i]} "
                                     f"vs {acc}, time {sp.time_s[i]} vs {t}")
            worst = [max(worst[0], e_acc), max(worst[1], e_t)]
            n += 1
    log(f"  per-image oracles: {n} cascades (the plan's and every CAMERA "
        f"frontier's): dense evaluator == simulate_cascade / "
        f"cascade_time_naive, max |acc err| {worst[0]:.3g}, max rel time "
        f"err {worst[1]:.3g}")


def check_retrain(dev, cfg, seed, system, train_split, casc0, reps):
    """Check b: the planned stage-0 model and the trusted model of the first
    planned predicate, trained again from the same seed on the same
    split, are bit for bit the bank's; then one of their training runs is
    profiled (idle share, top kernels)."""
    import torch

    from repro_torch.core.pipeline import train_cnn
    from repro_torch.core.transforms import materialize_representations
    from repro_torch.train.optimizer import tree_leaves
    bank = system.bank
    x, y = train_split
    raw = torch.as_tensor(x, device=dev)
    loop_check(dev, raw, y, reps, cfg["steps"])
    reps_x = materialize_representations(raw, reps)
    m0 = next(m for m, e in enumerate(bank.entries)
              if e.params is casc0.stage0.params)
    steps = cfg["steps"]
    for m in sorted({m0, bank.trusted_index}):
        e = bank.entries[m]
        if e.trusted:
            inputs, kw = raw, dict(steps=steps * 3, seed=seed + 999)
        else:
            inputs, kw = reps_x[e.rep], dict(steps=steps,
                                             seed=seed + m // len(reps))
        _sync(dev)
        t0 = time.perf_counter()
        again = train_cnn(e.arch, inputs, y, device=dev, **kw)
        _sync(dev)
        secs = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(again), tree_leaves(e.params)))
        log(f"  {casc0.concept} {e.name} trained again ({kw['steps']} steps "
            f"in {secs:.3f} s): bit-identical to the bank's: {same}")
        if not same:
            raise AssertionError(f"{e.name}: training is not deterministic")
        if dev.type == "cuda":
            n = cfg["profile_steps"]
            kw["steps"] = n
            _sync(dev)
            t0 = time.perf_counter()
            train_cnn(e.arch, inputs, y, device=dev, **kw)
            _sync(dev)
            device_profile(lambda: train_cnn(e.arch, inputs, y, device=dev,
                                             **kw), dev,
                           time.perf_counter() - t0,
                           f"training profile ({e.name}, {n} steps)")


def loop_check(dev, raw, y, reps, steps):
    """``fit_cnn``'s loop (on a card: one step captured in a CUDA graph and
    replayed) against the same step run eagerly, ``steps`` times, for a
    grid model (cnn_l1_c16_d16 in gray at the smallest size) from the
    same initial weights: bit-identical, or the capture changed what a
    step computes (a counter, batch or reset fault)."""
    import torch

    from repro_torch.configs.base import TahomaCNNConfig
    from repro_torch.core.pipeline import (_deterministic_cudnn,
                                           _training_step, fit_cnn)
    from repro_torch.core.transforms import (Representation,
                                             materialize_representations)
    from repro_torch.models.cnn import init_cnn
    from repro_torch.train.optimizer import tree_leaves
    rep = Representation(min(r.resolution for r in reps), "gray")
    x = materialize_representations(raw, reps)[rep]
    cfg = TahomaCNNConfig(1, 16, 16, input_hw=rep.resolution,
                          input_channels=1)
    init = init_cnn(torch.Generator(device=dev).manual_seed(7), cfg,
                    device=dev)
    looped = tree_leaves(fit_cnn(init, x, y, steps=steps, device=dev))
    eager, _, step = _training_step(init, x, y, steps=steps, batch=16,
                                    lr=3e-3, seed=0, device=dev)
    with _deterministic_cudnn():
        for _ in range(steps):
            step()
    same = all(torch.equal(a, b.detach()) for a, b in zip(looped, eager))
    log(f"  fit_cnn's loop on {dev.type} vs its step run eagerly, "
        f"{cfg.arch_id} at {rep.name}, {steps} steps: bit-identical: {same}")
    if not same:
        raise AssertionError("the training loop differs from its step run "
                             "eagerly")


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


def straddles(corpus, cascades, rows, chunk, *, int8=False, index=None):
    """{row: (concept, scores)} for the rows of ``rows`` on which two
    routes of some cascade's level 0 give scores on opposite sides of
    one of that level's f32 thresholds and within SCORE_TOL of each
    other. The routes: the fused kernel and the plain version, each at
    the scan's batch width ``chunk``, and, with an ingest ``index``, the
    score it recorded for the row (a reference frame scored at ingest).
    ``int8`` scores the first cascade on its int8 weights."""
    import numpy as np
    import torch

    from repro_torch.kernels.image_transform import fused_pyramid_stage0
    from repro_torch.kernels.ref import fused_pyramid_stage0_ref
    out = {}
    rows = np.asarray(rows, np.int64)
    for pos, casc in enumerate(cascades):
        s0 = casc.stage0
        qp = s0.qparams if int8 and pos == 0 else None
        lo, hi = casc.thresholds[0]
        ts = [float(np.float32(t)) for t in ([0.5] if lo is None
                                            else [lo, hi])]
        ing = None
        if index is not None and \
                index.cascade_keys.get(casc.concept) == casc.key:
            ing = index.scores[casc.concept]
        for at in range(0, len(rows), chunk):
            part = rows[at:at + chunk]
            idx = np.concatenate([part, np.repeat(part[-1:],
                                                  chunk - len(part))])
            imgs = corpus[torch.as_tensor(idx, device=corpus.device)]
            _, sk = fused_pyramid_stage0(imgs, [], s0.params, s0.rep,
                                         qparams=qp)
            _, sp = fused_pyramid_stage0_ref(imgs, [], s0.params, s0.rep,
                                             qparams=qp)
            for r, a, b in zip(part.tolist(), sk.tolist(), sp.tolist()):
                got = [a, b]
                if ing is not None and not np.isnan(ing[r]):
                    got.append(float(ing[r]))
                if any(abs(x - y) <= SCORE_TOL
                       and ((x >= t) != (y >= t) or (x <= t) != (y <= t))
                       for x in got for y in got for t in ts):
                    out.setdefault(r, (casc.concept, tuple(got)))
    return out


def boundary_rows(corpus, cascades, rows, chunk, *, int8=False, index=None):
    """Of ``rows`` (where two paths disagree), each must be a threshold-
    boundary row of one of ``cascades`` (``straddles``): a flip explained
    by the stated f32 score tolerance. Raises on any other row; returns
    [(row, concept, scores)]."""
    found = straddles(corpus, cascades, rows, chunk, int8=int8, index=index)
    for r in rows:
        if int(r) not in found:
            raise AssertionError(
                f"row {int(r)}: the two paths differ and no cascade of "
                f"{[c.concept for c in cascades]} has level-0 scores "
                f"within {SCORE_TOL} across a threshold")
    return [(r, *found[r]) for r in sorted(found)]


def query_path(dev, cfg, card, kern, seed):
    """-> (launch counts on the path, what the ingest and algebra phase
    reuses: the trained systems, the joint plan, the corpus on the
    device, the predicate specs and the query)."""
    import numpy as np

    from repro_torch.data.synthetic import DEFAULT_PREDICATES
    from repro_torch.engine.planner import (PredicateClause, QuerySpec,
                                            plan_query)
    from repro_torch.engine.scan import ScanEngine, level_schedule, naive_scan
    from repro_torch.kernels import ops

    log("== query path")
    specs = DEFAULT_PREDICATES[:3]
    t0 = time.perf_counter()
    corpus = make_corpus_on(dev, cfg, specs, seed)
    log(f"  corpus {tuple(corpus.shape)} on {corpus.device}: "
        f"{corpus.numel() * 4 / 1e9:.2f} GB, {time.perf_counter() - t0:.1f} s")
    query = QuerySpec(predicates=[PredicateClause(s.name) for s in specs])
    archs, reps, sized = grid(cfg)
    infer_s, cost_label = pinned_costs(cfg, sized)

    # ---- the main path, with the launch counts read around it: train ->
    # calibrate -> profile -> evaluate -> plan -> scan
    ops.reset_launch_counts()
    systems, train = train_systems(dev, cfg, seed, specs, archs, reps,
                                   sized, infer_s)
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
        paper_figures(name, system, cost_label)
    check_oracles(plan, systems)
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
        exempt = boundary_rows(corpus, [casc0], diff, cfg["chunk"],
                               int8=int8)
        log(f"  naive_scan {kind}: {len(ref)} rows in {t_naive:.2f} s; "
            f"identical rows: {not len(diff)}"
            + (f" except {len(exempt)} threshold-boundary rows "
               f"{exempt}" if exempt else ""))
    if dev.type == "cuda":
        _, secs, eng = runs[False]
        eng.reset_cache()      # rerun the timed scan: fresh store, same work
        device_profile(lambda: eng.execute(plan.cascades), dev, secs,
                       "scan profile (f32)")
    check_retrain(dev, cfg, seed, systems[casc0.concept],
                  train[casc0.concept], casc0, reps)

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
    dms = device_ms(lambda: fused_pyramid_stage0(imgs, out_res, s0.params,
                                                 s0.rep), dev, cfg["iters"])
    plain = time_ms(lambda: fused_pyramid_stage0_ref(imgs, out_res,
                                                     s0.params, s0.rep),
                    dev, cfg["iters"])
    bound, by = stage0_bound_ms(card, cfg["chunk"], base, out_res, s0,
                                k0.arch)
    kern["stage0"].update(ms=ms, device_ms=dms, plain_ms=plain,
                          bound_ms=bound, bound_by=by,
                          max_abs_err=max(worst, kern["stage0"]["worst"]),
                          shape=f"{k0.name} chunk {cfg['chunk']} base {base} "
                                f"levels {out_res}")
    log(f"  fused_pyramid_stage0 main path ({k0.name}, levels {out_res}): "
        f"kernel {ms:.4f} ms (device {_ms(dms)}), plain {plain:.4f} ms, "
        f"bound {bound:.4f} ms ({by})")
    matmul_main_path(dev, cfg, card, kern, systems[casc0.concept])
    return launches, dict(systems=systems, plan=plan, corpus=corpus,
                          specs=specs, query=query)


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
            f"(CUDA events); device time kernel {_ms(row['device_ms'])} ms, "
            f"torch.matmul {_ms(row['library_device_ms'])} ms; bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    kern["matmul"].update(rows[0], max_abs_err=err, other_shapes=rows[1:])
    s = cfg["mm_probe"]
    gen = torch.Generator(device=dev).manual_seed(5)
    a, b = (torch.randn((s, s), generator=gen, device=dev) for _ in "ab")
    ms = device_ms(lambda: matmul(a, b), dev, 3)
    lib = device_ms(lambda: torch.matmul(a, b), dev, 3)

    def rate(t):
        return "" if t is None else f" ({2 * s ** 3 / t / 1e9:.1f} TFLOP/s)"

    log(f"  matmul inner-loop probe ({s},{s})@({s},{s}) f32: kernel "
        f"{_ms(ms)} ms{rate(ms)}, torch.matmul {_ms(lib)} ms{rate(lib)}")


# ---------------------------------------------------------- phase 3b --
def ingest_algebra_path(dev, cfg, kern, seed, query):
    """Streaming ingest and the query algebra on the query path's trained
    systems and plan (nothing is trained again): (a) a camera stream
    through ``build_ingest_pipeline`` with the plan's cascades; (b)
    indexed queries on the stream, exact and approx; (c) boolean trees
    on the query corpus; (d) a temporal join over two cameras. Launch
    counts are reset just before the phase's work and read just after
    it, before any launch that compares a kernel with its plain version;
    ``fused_pyramid_stage0`` must launch once per scored ingest chunk.
    Row sets are held against cold scans and the naive oracles, apart
    from counted threshold-boundary rows. Returns the phase's
    ``fused_pyramid_stage0`` launches."""
    import numpy as np
    import torch

    from repro_torch.core.pipeline import build_ingest_pipeline
    from repro_torch.data.synthetic import (make_camera_stream,
                                            make_two_camera_corpus)
    from repro_torch.engine.algebra import (And, Join, Not, Or, Pred,
                                            execute_join, execute_tree,
                                            naive_join_pairs,
                                            naive_tree_rows)
    from repro_torch.engine.ingest import indexed_execute
    from repro_torch.engine.planner import QuerySpec, plan_query
    from repro_torch.engine.scan import ScanEngine, naive_scan
    from repro_torch.kernels import ops
    log("== ingest and algebra")
    t_phase = time.perf_counter()
    systems, plan, corpus = query["systems"], query["plan"], query["corpus"]
    specs, chunk, base = query["specs"], cfg["chunk"], cfg["base"]
    n, batch = cfg["stream"], cfg["stream_batch"]
    t0 = time.perf_counter()
    frames, labels, scene = make_camera_stream(
        specs, n, hw=base, seed=seed + 200, hold_max=4, jitter=1)
    log(f"  camera stream {frames.shape} on the host ({frames.nbytes / 1e9:.2f}"
        f" GB, {int(scene.max()) + 1} scenes), made in "
        f"{time.perf_counter() - t0:.1f} s")
    ids = np.arange(n, dtype=np.int64)
    pending = []        # (label, rows, cascades, corpus, index): explained
    #                     after the counts are read (those launches compare)

    # ---- (a) ingest, as a stream arrives
    ops.reset_launch_counts()
    pipe = build_ingest_pipeline(plan.cascades, n, chunk=chunk, skip=True,
                                 skip_threshold=None, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    for lo in range(0, n, batch):
        pipe.ingest(frames[lo:lo + batch], ids[lo:lo + batch])
    _sync(dev)
    t_ingest = time.perf_counter() - t0
    ingest_launches = ops.LAUNCHES["fused_pyramid_stage0"]
    st, index = pipe.stats, pipe.index
    log(f"  ingest: {n} frames in batches of {batch}, chunk {chunk}: "
        f"{t_ingest:.3f} s ({n / t_ingest:.0f} frames/s); refs {st.refs}, "
        f"skipped {st.skipped}, decided labels {st.decided_labels}, stage-0 "
        f"scores {st.stage0_scores}, chunks {st.chunks}; calibrated skip "
        f"threshold {pipe.skip_threshold!r} (from the first "
        f"{pipe.calib_frames} diffs); fused_pyramid_stage0 launches "
        f"{ingest_launches}")
    if dev.type == "cuda" and (ingest_launches != st.chunks
                               or ingest_launches == 0):
        raise AssertionError(f"ingest launched fused_pyramid_stage0 "
                             f"{ingest_launches} times for {st.chunks} "
                             f"scored chunks")
    if not np.array_equal(scene[index.alias], scene):
        raise AssertionError("a skip-alias crosses a scene boundary")
    ref = index.alias == ids
    cal = pipe.calib_frames
    change = np.concatenate([[True], scene[1:] != scene[:-1]])
    if not (ref[:cal].all() and np.array_equal(ref[cal:], change[cal:])):
        raise AssertionError("not one reference per scene after "
                             "calibration")
    # the scored chunks, as ingest split the batches: the first and the
    # last are held against the kernel and the plain version at the end
    scored = [g[ref[g]] for lo in range(0, n, batch)
              for at in range(lo, min(lo + batch, n), chunk)
              for g in (ids[at:min(at + chunk, lo + batch, n)],)
              if ref[g].any()]
    if len(scored) != st.chunks:
        raise AssertionError(f"{len(scored)} chunks hold references, "
                             f"{st.chunks} were scored")
    kept = [(g, frames[g].copy()) for g in (scored[0], scored[-1])]

    # ---- (b) indexed queries on the stream, exact and approx
    stream = torch.from_numpy(frames).to(dev)
    all_ids = ids
    plans = {m: plan_query(systems, query["query"], scenario="CAMERA",
                           joint=True, index=index, index_mode=m)
             for m in ("exact", "approx")}
    px = plans["exact"]
    held = sum(index.cascade_keys.get(c.concept) == c.key
               for c in px.cascades)
    log(f"  re-planned with the index: "
        f"{[c.concept for c in px.cascades]} (ingest order "
        f"{index.concepts}); the index holds {held} of its "
        f"{len(px.cascades)} cascade keys")
    log(px.explain(n_rows=n))
    scans = {}
    for label, run in (
            ("indexed", lambda e: indexed_execute(e, px)),
            ("cold", lambda e: e.execute(px.cascades)),
            ("approx", lambda e: indexed_execute(e, plans["approx"]))):
        eng = ScanEngine(stream, chunk=chunk, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        res = run(eng)
        _sync(dev)
        scans[label] = (res, time.perf_counter() - t0)
    t0 = time.perf_counter()
    naive = naive_scan(stream, px.cascades, chunk=chunk, device=dev)
    t_naive = time.perf_counter() - t0
    for label, (res, secs) in scans.items():
        s = res.stats
        log(f"  {label} scan of the stream: {len(res.indices)} rows, rows "
            f"evaluated {s.rows_evaluated} (per stage "
            f"{[g.rows_evaluated for g in s.stages]}), {s.chunks} chunks, "
            f"{secs:.3f} s"
            + (f", {secs * 1e3 / s.chunks:.3f} ms/chunk" if s.chunks else ""))
    log(f"  naive_scan of the stream: {len(naive)} rows in {t_naive:.2f} s")
    got = scans["indexed"][0].indices
    pending.append(("exact indexed vs cold", np.setxor1d(
        got, scans["cold"][0].indices), px.cascades, stream, index))
    pending.append(("exact indexed vs naive_scan",
                    np.setxor1d(got, naive), px.cascades, stream, index))
    approx = plans["approx"]
    cold_rows = scans["cold"][0].indices
    a_rows = scans["approx"][0].indices
    recall = {c: index.measured_recall(
        c, labels[:, [s.name for s in specs].index(c)])
        for c in index.concepts}
    log(f"  approx: prefilter keeps {len(approx.index_prefilter(all_ids))} "
        f"of {n} rows (exact: {len(px.index_prefilter(all_ids))}); "
        f"measured recall against the stream's labels {recall}; "
        f"{len(a_rows)} rows, {len(np.intersect1d(a_rows, cold_rows))} of "
        f"the cold scan's {len(cold_rows)}")
    del scans, stream

    # ---- (c) boolean trees on the query corpus
    names = [s.name for s in specs]
    a, b, c = (Pred(x) for x in names)
    nq = int(corpus.shape[0])
    meta = {"cam": np.arange(nq) % 2, "t": 3 * np.arange(nq, dtype=np.int64)}
    fn_cache: dict = {}
    for tree, eq in ((Or(And(a, Not(b)), c), {}),
                     (And(a, Or(b, Not(c))), {"cam": 0}),
                     (Not(Or(a, b)), {})):
        tp = plan_query(systems, QuerySpec(metadata_eq=eq, where=tree),
                        metadata=meta)
        out = {}
        for opt in (True, False):
            eng = ScanEngine(corpus, meta, chunk=chunk, device=dev)
            res = execute_tree(eng, tp, optimize=opt)
            _sync(dev)
            out[opt] = res
            if opt:
                log(tp.explain(n_rows=nq))
        t0 = time.perf_counter()
        oracle = naive_tree_rows(corpus, tree, tp.cascade_map(), meta, eq,
                                 chunk=chunk, device=dev, _fn_cache=fn_cache)
        t_naive = time.perf_counter() - t0
        for opt, res in out.items():
            log(f"  tree {expr(tree)} {eq or ''} optimized={opt}: "
                f"{len(res.indices)} rows, {res.engine_calls} engine calls, "
                f"rows evaluated {res.rows_evaluated}, {res.seconds:.3f} s")
            pending.append((f"tree {expr(tree)} optimized={opt} vs "
                            f"naive_tree_rows",
                            np.setxor1d(res.indices, oracle), tp.cascades,
                            corpus, None))
        log(f"  naive_tree_rows: {len(oracle)} rows in {t_naive:.2f} s")

    # ---- (d) a temporal join over two cameras
    t0 = time.perf_counter()
    (xa, _, tma), (xb, _, tmb) = make_two_camera_corpus(
        specs, cfg["join"], hw=base, seed=seed + 300)
    log(f"  two cameras {xa.shape} + {xb.shape}, int64 timestamps, made in "
        f"{time.perf_counter() - t0:.1f} s")
    cams = [torch.from_numpy(x).to(dev) for x in (xa, xb)]
    del xa, xb
    metas = ({"t": tma}, {"t": tmb})
    join = Join(a, a, delta_t=2)
    jp = plan_query(systems, QuerySpec(where=join), metadata=metas)
    engines = [ScanEngine(x, m, chunk=chunk, device=dev)
               for x, m in zip(cams, metas)]
    res = execute_join(engines, jp)
    _sync(dev)
    launches = ops.LAUNCHES["fused_pyramid_stage0"]
    log(jp.explain())
    t0 = time.perf_counter()
    rows = [naive_tree_rows(x, side, sp.cascade_map(), chunk=chunk,
                            device=dev, _fn_cache=fn_cache)
            for x, side, sp in zip(cams, (join.left, join.right),
                                   (jp.left, jp.right))]
    want = naive_join_pairs((rows[0], tma), (rows[1], tmb), join.delta_t)
    t_naive = time.perf_counter() - t0
    log(f"  join {expr(join.left)} x {expr(join.right)} within "
        f"{join.delta_t}: {len(res.pairs)} pairs, build side "
        f"{'left' if jp.build_side == 0 else 'right'}, probe rows left "
        f"after the window pushdown {jp.window_kept} of {len(tmb)}, "
        f"{res.seconds:.3f} s (left {res.left.rows_evaluated} rows "
        f"evaluated, right {res.right.rows_evaluated}); naive "
        f"{len(want)} pairs in {t_naive:.2f} s")
    log(f"  fused_pyramid_stage0 launches in the phase: {launches} "
        f"({ingest_launches} on the ingest path)")

    # ---- exactness: every differing row a counted boundary row
    for label, diff, cascades, data, idx in pending:
        exempt = boundary_rows(data, cascades, diff, chunk, index=idx)
        log(f"  {label}: identical rows: {not len(diff)}"
            + (f" except {len(exempt)} threshold-boundary rows {exempt}"
               if exempt else ""))
    pairs = {tuple(p) for p in res.pairs.tolist()}
    wanted = {tuple(p) for p in want.tolist()}
    diff = sorted(pairs ^ wanted)
    if diff:
        bl = straddles(cams[0], jp.left.cascades, [p[0] for p in diff], chunk)
        br = straddles(cams[1], jp.right.cascades, [p[1] for p in diff],
                       chunk)
        bad = [p for p in diff if p[0] not in bl and p[1] not in br]
        if bad:
            raise AssertionError(f"join pairs differ from naive_join_pairs "
                                 f"off the threshold boundary: {bad[:8]}")
    log(f"  join vs naive_join_pairs: identical pairs: {not diff}"
        + (f" except {len(diff)} pairs on threshold-boundary rows"
           if diff else ""))
    check_ingest_scores(pipe, kept)
    ingest_profile(dev, plan, frames, ids, pipe, batch, t_ingest)
    kern["stage0"]["ingest_launches"] = ingest_launches
    log(f"  the phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def ingest_profile(dev, plan, frames, ids, pipe, batch, t_ingest):
    """Where the ingest's time goes: the host's frame signatures alone
    (the skip detector's feature, per chunk as ingest computes them),
    then a second ingest of the same stream through a fresh pipeline
    under torch.profiler (device busy time and idle share against the
    first ingest's wall time)."""
    from repro_torch.core.pipeline import build_ingest_pipeline
    from repro_torch.engine.ingest import frame_signature
    t0 = time.perf_counter()
    for lo in range(0, len(ids), pipe.chunk):
        frame_signature(frames[lo:lo + pipe.chunk], pipe.skip_res)
    t_sig = time.perf_counter() - t0
    log(f"  ingest's frame signatures alone (host): {t_sig:.3f} s of its "
        f"{t_ingest:.3f} s")
    if dev.type != "cuda":
        return

    def run():
        again = build_ingest_pipeline(plan.cascades, len(ids),
                                      chunk=pipe.chunk, skip=True,
                                      skip_threshold=None, device=dev)
        for lo in range(0, len(ids), batch):
            again.ingest(frames[lo:lo + batch], ids[lo:lo + batch])
    device_profile(run, dev, t_ingest, "ingest profile", top=6)


def expr(tree) -> str:
    """An expression tree in one short line: And(acorn, Not(ferret))."""
    from repro_torch.engine.algebra import Pred
    if isinstance(tree, Pred):
        return tree.concept
    kids = getattr(tree, "children", None) or (tree.child,)
    return f"{type(tree).__name__}({', '.join(expr(k) for k in kids)})"


def check_ingest_scores(pipe, chunks):
    """(a)'s score check: on each of ``chunks`` ([(row ids, their
    frames)], one scored ingest chunk's references each), the anchor's
    recorded ingest scores equal the kernel's own on the same padded
    chunk (same levels requested, same width), and stay within
    SCORE_TOL of the plain version's."""
    import numpy as np
    import torch

    from repro_torch.kernels.image_transform import fused_pyramid_stage0
    from repro_torch.kernels.ref import fused_pyramid_stage0_ref
    c0 = pipe.cascades[0]
    s0 = c0.stage0
    need = {c0.reps[0].resolution} | {c.reps[0].resolution
                                      for c in pipe.cascades[1:]}
    for rids, x in chunks:
        nv = len(rids)
        x = np.concatenate([x, np.repeat(x[-1:], pipe.chunk - nv, axis=0)])
        imgs = torch.from_numpy(x).to(pipe.device)
        pooled = sorted(need - {imgs.shape[1]})
        _, sk = fused_pyramid_stage0(imgs, pooled, s0.params, s0.rep)
        _, sp = fused_pyramid_stage0_ref(imgs, pooled, s0.params, s0.rep)
        got = pipe.index.scores[c0.concept][rids]
        sk = sk[:nv].cpu().numpy()
        same = np.array_equal(sk, got)
        err = float(np.abs(sk - sp[:nv].cpu().numpy()).max())
        log(f"  ingest scores of {c0.concept} on a chunk of {nv} references "
            f"(rows {int(rids[0])}..{int(rids[-1])}): equal to the kernel's "
            f"on the padded chunk: {same}; max |kernel - plain| {err:.3g}")
        if not same or err > SCORE_TOL:
            raise AssertionError("ingest scores differ from the kernel's "
                                 "own, or the kernel from the plain version")


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

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.bindings import ssd_heads_per_block
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
        f"(CUDA events); device time kernel {_ms(fl['device_ms'])} ms, sdpa "
        f"{_ms(fl['library_device_ms'])} ms; bound {fl['bound_ms']:.4f} ms "
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

    # the serving path's shape, mamba2-130m's (N 128, several heads a
    # block on the tensor cores), and the reference tests' shapes in f32
    # (the FFMA kernel) and bf16 (the tensor-core kernel's ragged P and N)
    m130 = get_arch("mamba2-130m")
    m130_shape = (b, s, m130.ssm_heads, m130.ssm.head_dim, m130.ssm.d_state)
    cases = [((b, s, h, p, n), chunk, bf), (m130_shape, chunk, bf)] + [
        (shp, c, dt) for shp in SSD_TEST_SHAPES for c in (16, 32, 64)
        for dt in (torch.float32, bf)]
    for shp, c, dt in cases:
        args = ssd_inputs(*shp, dt)
        (y, fin), (yr, fr) = (ssd_scan(*args, chunk=c),
                              ssd_scan_ref(*args, chunk=c))
        ey, oky = _close(y, yr, *SSD_TOL)
        ef, okf = _close(fin, fr, *SSD_TOL)
        bb, _, hh, pp, nn = shp
        hb = ssd_heads_per_block(bb, hh, pp, nn, dt == bf)
        log(f"  ssd_scan x {shp[:4]} N {shp[4]} {dt} chunk {c}: max |err| "
            f"y {ey:.3g}, final state {ef:.3g} (tol {SSD_TOL}); "
            + (f"tensor cores, {hb} heads a block" if hb else "f32 FFMA"))
        if not (oky and okf):
            raise AssertionError(f"ssd_scan {shp} chunk {c}: {ey}, {ef}")
        ss["max_abs_err"] = max(ss["max_abs_err"], ey, ef)
    rows = []
    for (bb, sl, hh, pp, nn) in ((b, s, h, p, n), m130_shape):
        args = ssd_inputs(bb, sl, hh, pp, nn, bf)
        row = {"ms": time_ms(lambda: ssd_scan(*args, chunk=chunk), dev, it),
               "device_ms": device_ms(lambda: ssd_scan(*args, chunk=chunk),
                                      dev, it),
               "plain_ms": time_ms(lambda: ssd_scan_ref(*args, chunk=chunk),
                                   dev, it)}
        # the least work: the state update and the output contraction, on
        # the unit the kernel uses (bf16 tensor cores), against the bytes
        # (x, B, C in bf16, dt and a in f32 read; y and the final state in
        # f32 written)
        t_ops = 4.0 * bb * sl * hh * pp * nn / card["bf16"]
        nbytes = (bb * sl * hh * pp * 2 + bb * sl * hh * 4 + hh * 4
                  + 2 * bb * sl * nn * 2 + bb * sl * hh * pp * 4
                  + bb * hh * pp * nn * 4)
        t_mem = nbytes / card["bw"]
        row.update(bound_ms=max(t_ops, t_mem) * 1e3,
                   bound_by="operations" if t_ops > t_mem else "bytes",
                   library_ms=None,
                   shape=f"x ({bb},{sl},{hh},{pp}) bf16, N {nn}, chunk "
                         f"{chunk}, {ssd_heads_per_block(bb, hh, pp, nn)} "
                         f"heads a block")
        log(f"  ssd_scan {row['shape']}: kernel {row['ms']:.4f} ms (device "
            f"{_ms(row['device_ms'])}), plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); no single "
            f"PyTorch call computes it")
        rows.append(row)
    ss.update(rows[0], other_shapes=rows[1:])
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
        for name in names:
            err_by = check_transform(f"{name} on {label} frames", x, specs,
                                     got[name], label == "dyadic")
            worst[name] = max(worst[name], *err_by.values())

    hold("dyadic", imgs, outs)
    del outs
    x = torch.rand((b, base, base, 3), generator=gen, device=dev)
    hold("torch.rand", x, run(x))
    transform_times(dev, cfg, card, kern, imgs, specs, worst)
    kern["fused_pyramid_transform"]["other_shapes"] = pyramid_other_shapes(
        dev, cfg, gen)
    return launches


def check_transform(label, x, specs, outs, exact_input):
    """Each (res, color) output against its plain version: on dyadic
    frames (``exact_input``) rgb/r/g/b torch.equal and gray within
    TRANSFORM_GRAY_TOL, else within TRANSFORM_TOL. Raises on a miss;
    returns the max |err| of gray and of the other colors."""
    import torch
    err_by = {"gray": 0.0, "other": 0.0}
    for o, (r, c) in zip(outs, specs):
        want = _transform_ref(x, r, c)
        if o.shape != want.shape or not torch.isfinite(o).all():
            raise AssertionError(f"{label} ({r}, {c}): bad output")
        err = float((o - want).abs().max())
        if exact_input and c != "gray":
            ok = torch.equal(o, want)
        else:
            ok = err <= (TRANSFORM_GRAY_TOL if exact_input
                         else TRANSFORM_TOL)
        if not ok:
            raise AssertionError(f"{label} ({r}, {c}): max |err| {err}")
        key = "gray" if c == "gray" else "other"
        err_by[key] = max(err_by[key], err)
    log(f"  {label}, all {len(specs)} outputs: " + (
        f"rgb/r/g/b equal, gray max |err| {err_by['gray']:.3g} (tol "
        f"{TRANSFORM_GRAY_TOL})" if exact_input else
        f"max |err| {max(err_by.values()):.3g} (tol {TRANSFORM_TOL})"))
    return err_by


def pyramid_cases(cfg):
    """fused_pyramid_transform's other paths: (label, frames, base,
    (res, color) specs, storage offset of the frames in floats)."""
    from repro_torch.core.transforms import COLOR_REPS
    b, base = cfg["chunk"], cfg["base"]
    main = tuple((r, c) for r in cfg["resolutions"] for c in COLOR_REPS)
    return (
        ("no chain: 32 px straight from 224 px (factor 7)", b, 224,
         ((112, "rgb"), (32, "gray"), (224, "g")), 0),
        ("a (3, 3) projection that is no identity (bgr)", b, base,
         ((base, "bgr"), (base // 2, "bgr"), (base // 8, "bgr")), 0),
        ("chain at 84 px (no multiple of 16)", b, 84,
         tuple((r, c) for r in (42, 21) for c in COLOR_REPS), 0),
        ("frames at storage offset 1 (off 16-byte alignment)", b, base,
         main, 1),
        ("B = 1", 1, base, main, 0),
        (f"B = {b + 1} (no multiple of the grid)", b + 1, base, main, 0),
    )


def pyramid_case_inputs(case, gen, dev):
    """The dyadic frames of a ``pyramid_cases`` case (at its storage
    offset) and its (res, channel weights) specs."""
    import torch

    _, b, base, specs, offset = case
    flat = torch.empty(offset + b * base * base * 3, device=dev)
    x = flat[offset:].view(b, base, base, 3)
    x.copy_(dyadic(b, base, gen, dev))
    return x, [(r, _weights(c)) for r, c in specs]


def pyramid_other_shapes(dev, cfg, gen):
    """Every ``pyramid_cases`` case through the entry point, held against
    the plain version (check_transform, dyadic frames), and the kernel
    alone timed (a prepared launch; the entry point on the CPU)."""
    from repro_torch.kernels import bindings
    from repro_torch.kernels.image_transform import (fused_pyramid_transform,
                                                     transform_params)
    rows = []
    for case in pyramid_cases(cfg):
        label, b, base, specs, _ = case
        x, cws = pyramid_case_inputs(case, gen, dev)
        err_by = check_transform(f"fused_pyramid_transform, {label}", x,
                                 specs, fused_pyramid_transform(x, cws), True)
        if dev.type == "cuda":
            prm, _outs = transform_params(x, cws)   # outputs kept alive
            ms = time_ms(lambda: bindings.launch_fused_pyramid_transform(prm),
                         dev, cfg["iters"] * 10)
            path = "strips" if prm.chain else "tiles"
        else:
            ms = time_ms(lambda: fused_pyramid_transform(x, cws), dev, 1)
            path = "plain"
        rows.append({"case": label, "kernel": path, "ms": ms,
                     "max_abs_err": max(err_by.values())})
        log(f"    {b} x {base} px -> {len(specs)} specs: {path} kernel "
            f"{ms:.4f} ms")
    return rows


def _weights(color):
    """ops.COLOR_WEIGHTS[color], or for "bgr" the channels reversed: a
    (3, 3) matrix that is no identity (exact on dyadic frames)."""
    import numpy as np

    from repro_torch.kernels.ops import COLOR_WEIGHTS
    if color == "bgr":
        return np.ascontiguousarray(np.eye(3, dtype=np.float32)[:, ::-1])
    return COLOR_WEIGHTS[color]


def _transform_ref(x, res, color):
    from repro_torch.kernels.ref import fused_transform_ref
    return fused_transform_ref(x, _weights(color), res)


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
            dev_ms = device_ms(lambda: launch(prm), dev, it)
        else:
            ms = dev_ms = entry_ms
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
        k = {"max_abs_err": worst[name], "ms": ms, "device_ms": dev_ms,
             "plain_ms": plain, "tb_per_s": nbytes / ms / 1e9,
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
        log(f"  {name} {k['shape']}: kernel {ms:.4f} ms (device "
            f"{_ms(dev_ms)} ms; {k['tb_per_s']:.3f} TB/s of {nbytes / 1e6:.1f}"
            f" MB; entry point {entry_ms:.4f} ms), plain {plain:.4f} ms{lib}, "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']})")


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
                                               "tb_per_s", "other_shapes",
                                               "ingest_launches")
                       if key in k}})
    print(json.dumps({"kernels": out}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
