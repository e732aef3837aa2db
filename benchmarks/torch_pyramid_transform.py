"""fused_pyramid_transform on the card: two source trees side by side, and
the phase shares of the tile kernel.

    python3 benchmarks/torch_pyramid_transform.py --trees PARENT .
    python3 benchmarks/torch_pyramid_transform.py --phases PARENT

``--trees A B`` runs A, B, B, A, each in a process of its own that imports
``repro_torch`` from that tree's ``src`` (and builds that tree's kernels
into its ``build/``), and times, in every tree, the same prepared launches
(CUDA events around back-to-back launches; device time from
torch.profiler, chip_smoke.device_ms): fused_pyramid_transform on the
query path's 256 dyadic 224 px frames -> all 20 (res, color) specs,
fused_transform -> (56, gray) as a control, and every case of
chip_smoke.pyramid_cases. Every output is held against its plain version
first (chip_smoke.check_transform). Prints each tree's runs, then per
case each tree's median and spread. Compare trees only within one run.

``--phases TREE`` builds a copy of TREE's csrc/image_transform.cu whose
kernels stamp clock64() between phases and sum each phase over blocks,
runs the query path's shape and prints each phase's share of the block
cycles, and ptxas's lines for the copy. The tile kernel (transform_tile,
the main path's before the strip kernel; thread 0) at each block barrier,
one more barrier after each output level's projections: staging the
tile, pooling each level, projecting and writing each level's outputs.
The strip kernel (thread 32, a thread that issues no copies) per work
item: waiting for its slot, pooling, writing, the barrier and the refill.

Both runs also time two PyTorch yardsticks of the memory rate on the same
card: ``fill_`` of as many bytes as the main path writes, and ``copy_`` of
its frames (as many bytes read as written).

Needs a card; case definitions and helpers come from this checkout's
chip_smoke.py.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 3          # timings of each case in one process
ITERS = 100       # launches a timing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--phases", metavar="TREE")
    ap.add_argument("--worker", metavar="TREE", help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(Path(args.worker), args.seed)
    if args.phases:
        return phases(Path(args.phases).resolve(), args.seed)
    if not args.trees:
        ap.error("give --trees A B or --phases TREE")
    trees = [Path(t).resolve() for t in args.trees]
    runs = []
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        out = subprocess.run(
            [sys.executable, __file__, "--worker", str(tree), "--seed",
             str(args.seed)], env=env, capture_output=True, text=True)
        print(out.stdout, end="", flush=True)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    print(f"== {runs[0]['card']}")
    for case in runs[0]["ms"]:
        for tree in trees:
            mine = [r for r in runs if r["tree"] == str(tree)]
            for clock in ("ms", "device_ms"):
                xs = [x for r in mine for x in r[clock][case] if x is not None]
                if not xs:
                    print(f"  {case} | {tree.name} {clock}: not measured")
                    continue
                print(f"  {case} | {tree.name} {clock}: median "
                      f"{statistics.median(xs):.4f}, spread "
                      f"{max(xs) - min(xs):.4f} (runs "
                      f"{' '.join(f'{x:.4f}' for x in xs)})")
    return 0


def _cases(cfg):
    """(label, frames, base, specs, offset, launcher name) of every timed
    case: the main path, the control, then chip_smoke.pyramid_cases."""
    import chip_smoke
    from repro_torch.core.transforms import COLOR_REPS
    b, base = cfg["chunk"], cfg["base"]
    main_specs = tuple((r, c) for r in cfg["resolutions"] for c in COLOR_REPS)
    return ([(f"main path: {b} x {base} px -> {len(main_specs)} specs", b,
              base, main_specs,
              0, "launch_fused_pyramid_transform"),
             (f"control: fused_transform {b} x {base} px -> (56, gray)", b,
              base, ((56, "gray"),), 0, "launch_fused_transform")]
            + [(*case, "launch_fused_pyramid_transform")
               for case in chip_smoke.pyramid_cases(cfg)])


def worker(tree: Path, seed: int) -> int:
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.device import resolve_device
    from repro_torch.kernels import bindings, build
    from repro_torch.kernels.image_transform import transform_params
    dev = torch.device("cuda")
    resolve_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    got = {"tree": str(tree), "card": smi, "ms": {}, "device_ms": {}}
    print(f"-- {tree}", flush=True)
    for label, b, base, specs, offset, launcher in _cases(chip_smoke.FULL):
        x, cws = chip_smoke.pyramid_case_inputs(
            (label, b, base, specs, offset), gen, dev)
        launch = getattr(bindings, launcher)
        prm, outs = transform_params(x, cws)
        launch(prm)
        for fn, props in chip_smoke.ptxas_by_function(
                build.BUILD_INFO.pop("logs", {}).get("image_transform", "")):
            print(f"  ptxas image_transform: {fn}: {props}")
        chip_smoke.check_transform(f"  {label}", x, specs, outs, True)
        got["ms"][label] = [chip_smoke.time_ms(lambda: launch(prm), dev, ITERS)
                            for _ in range(REPS)]
        got["device_ms"][label] = [
            chip_smoke.device_ms(lambda: launch(prm), dev, ITERS)
            for _ in range(REPS)]
        del prm, outs
    label, b, base, specs, _, _ = _cases(chip_smoke.FULL)[0]
    written = sum(b * r * r * (3 if c == "rgb" else 1) for r, c in specs)
    dst = torch.empty(written, device=dev)
    frames = torch.empty(b * base * base * 3, device=dev)
    src = torch.rand(frames.shape, generator=gen, device=dev)
    for name, fn in ((f"yardstick: fill_ of {4 * written / 1e6:.1f} MB",
                      lambda: dst.fill_(0.5)),
                     (f"yardstick: copy_ of {4 * frames.numel() / 1e6:.1f} "
                      f"MB", lambda: frames.copy_(src))):
        got["ms"][name] = [chip_smoke.time_ms(fn, dev, ITERS)
                           for _ in range(REPS)]
        got["device_ms"][name] = [chip_smoke.device_ms(fn, dev, ITERS)
                                  for _ in range(REPS)]
    print(json.dumps(got), flush=True)
    return 0


# ---- phase shares
PRELUDE = """
__device__ unsigned long long phase_cycles[64];
#define PHASE(i, t)                                                \\
  if (threadIdx.x == (t)) {                                        \\
    const long long t_ = clock64();                                \\
    atomicAdd(&phase_cycles[(i)], (unsigned long long)(t_ - t0_)); \\
    t0_ = t_;                                                      \\
  }
"""
EPILOGUE = """
extern "C" int phases_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, phase_cycles, sizeof(phase_cycles));
}
extern "C" int phases_reset() {
  static unsigned long long zero[64];
  return (int)cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
}
"""
# (text, text it becomes). Tile kernel: phase 0 staging, 1 + l pooling
# level l, 18 + l the outputs of level l (17: the base's).
TILE_PATCHES = (
    ("  const float* img = p.img + b * H * H * 3;\n",
     "  const float* img = p.img + b * H * H * 3;\n"
     "  long long t0_ = clock64();\n"),
    ("  }\n  __syncthreads();\n\n  // ---- pool each level",
     "  }\n  __syncthreads();\n  PHASE(0, 0);\n\n  // ---- pool each level"),
    ("      D[i] = __fdiv_rn(sum, area);\n    }\n    __syncthreads();\n",
     "      D[i] = __fdiv_rn(sum, area);\n    }\n    __syncthreads();\n"
     "    PHASE(1 + l, 0);\n"),
    ("      project<3>(S, out, th, tw, res, oy, ox, cw, p.mean, p.inv_std);\n",
     "      project<3>(S, out, th, tw, res, oy, ox, cw, p.mean, p.inv_std);\n"
     "    if (o + 1 == p.n_out || p.out_level[o + 1] != l) {\n"
     "      __syncthreads();\n      PHASE(18 + l, 0);\n    }\n"),
)
TILE_PHASES = {0: "stage the tile", 17: "outputs at the base"}
# Strip kernel: 40 waiting, 41 pooling, 42 writing, 43 barrier + refill.
STRIP_PATCHES = (
    ("    build_plan(p, w);\n  }\n  __syncthreads();\n",
     "    build_plan(p, w);\n  }\n  __syncthreads();\n"
     "  long long t0_ = clock64();\n"),
    ("    mbar_wait(&full[slot], (unsigned)(k / ring) & 1u);\n",
     "    mbar_wait(&full[slot], (unsigned)(k / ring) & 1u);\n"
     "    PHASE(40, 32);\n"),
    ("    write_outputs(p, w, 0, k > 0",
     "    PHASE(41, 32);\n    write_outputs(p, w, 0, k > 0"),
    ("lvb + ((k - 1) & 1) * p.lv_stride, item(k - 1));\n",
     "lvb + ((k - 1) & 1) * p.lv_stride, item(k - 1));\n"
     "    PHASE(42, 32);\n"),
    ("    if (threadIdx.x == 0) fill(slot, k + ring);\n",
     "    if (threadIdx.x == 0) fill(slot, k + ring);\n    PHASE(43, 32);\n"),
)
STRIP_PHASES = {40: "wait for the slot", 41: "pool", 42: "write",
                43: "barrier + refill"}


def phases(tree: Path, seed: int) -> int:
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.device import resolve_device
    from repro_torch.kernels import bindings, build
    from repro_torch.kernels.image_transform import transform_params
    dev = torch.device("cuda")
    resolve_device(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    label, b, base, specs, offset, _ = _cases(chip_smoke.FULL)[0]
    x, cws = chip_smoke.pyramid_case_inputs((label, b, base, specs, offset),
                                            gen, dev)
    prm, outs = transform_params(x, cws)
    strips = bool(getattr(prm, "chain", 0))
    src = (tree / "src/repro_torch/kernels/csrc/image_transform.cu"
           ).read_text()
    for old, new in STRIP_PATCHES if strips else TILE_PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"{tree}: the kernel does not hold {old!r} "
                             f"once")
        src = src.replace(old, new)
    head = src.index("#include <cuda_runtime.h>\n") + len(
        "#include <cuda_runtime.h>\n")
    src = src[:head] + PRELUDE + src[head:] + EPILOGUE
    out_dir = tree / "build" / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "image_transform_phases.cu").write_text(src)
    lib_path = out_dir / "libimage_transform_phases.so"
    nvcc = subprocess.run(
        [build._nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-o",
         str(lib_path), str(out_dir / "image_transform_phases.cu")],
        capture_output=True, text=True)
    if nvcc.returncode:
        raise SystemExit(nvcc.stdout + nvcc.stderr)
    for fn, props in chip_smoke.ptxas_by_function(nvcc.stdout + nvcc.stderr):
        print(f"  ptxas (stamped copy): {fn}: {props}")
    lib = ctypes.CDLL(str(lib_path))
    run = lib.repro_fused_pyramid_transform
    run.argtypes = [ctypes.POINTER(bindings.ITParams), ctypes.c_void_p]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    launch = lambda: run(ctypes.byref(prm), stream)   # noqa: E731
    if launch():
        raise SystemExit("launch failed")
    chip_smoke.check_transform(f"  stamped copy, {label}", x, specs, outs,
                               True)
    ms = chip_smoke.time_ms(launch, dev, ITERS)
    cycles = (ctypes.c_ulonglong * 64)()
    lib.phases_reset()
    for _ in range(ITERS):
        launch()
    torch.cuda.synchronize()
    lib.phases_read(cycles)
    if strips:
        names, per = STRIP_PHASES, "a work item"
        units = b * (base // 16)
    else:
        names, per = dict(TILE_PHASES), "a block"
        for i in range(prm.n_levels):
            r = prm.level_res[i]
            names[1 + i] = f"pool {r} px"
            names[18 + i] = f"outputs at {r} px"
        units = b * (base // prm.tile_h) * (base // prm.tile_w)
    total = sum(cycles)
    print(f"== {label}: stamped copy {ms:.4f} ms; "
          f"{'strip' if strips else 'tile'} kernel cycles by phase "
          f"({ITERS} launches, {tree.name})")
    for i in sorted(names):
        print(f"  {names[i]}: {100 * cycles[i] / total:.1f}% "
              f"({cycles[i] / ITERS / units:.0f} cycles {per})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
