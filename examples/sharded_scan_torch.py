"""Run the sharded scan engine with its lanes on every visible GPU and hold
its rows against the serial scan's and ``naive_scan``'s.

    python3 examples/sharded_scan_torch.py [--frames 2048] [--lanes 2]

The corpus (dyadic 224 px frames from a seed) lies on the first GPU.
``ShardedScanEngine`` runs ``--lanes`` shards per visible GPU, placed by
``launch/mesh.shard_devices`` (round-robin): lanes on the corpus's GPU
gather from it, lanes on the others get their partition and a copy of
the cascades' weights once per scan. The cascades have the query path's
shape (a 28 px single-model stage 0 through the ``fused_pyramid_stage0``
kernel, a 28 px single model, and a 28 px -> 28 px -> 224 px cascade),
with seeded random weights whose outputs are centred on 0.5 and
thresholds at score quantiles, so every level sees rows. It prints, per
backend, the rows, the devices and lanes, supersteps, stage-0 launches,
ms (host clock around a synchronized scan) and the peak memory each GPU
allocated; a row that differs from the serial scan must be a
threshold-boundary row (``chip_smoke.straddles``) or the run fails.
Needs a card; with one GPU every lane shares it.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def cascades_on(corpus, gen, dev):
    """The three cascades, weights from ``gen``."""
    import numpy as np
    import torch

    from repro_torch.configs.base import TahomaCNNConfig
    from repro_torch.core.executor import Stage0
    from repro_torch.core.transforms import (Representation,
                                             color_transform, resize_area)
    from repro_torch.engine.scan import CompiledCascade
    from repro_torch.models.cnn import (cnn_forward, cnn_predict_proba,
                                        init_cnn, quantize_cnn)
    sample = corpus[:256]
    out = []
    for i, (name, levels) in enumerate((
            ("pinwheel", [((1, 16, 32), 28, "b")]),
            ("ferret", [((1, 16, 32), 28, "g")]),
            ("acorn", [((4, 16, 64), 28, "r"), ((2, 16, 64), 28, "r"),
                       ((3, 48, 64), 224, "rgb")]))):
        params, reps, ths = [], [], []
        for l, (arch, res, color) in enumerate(levels):
            rep = Representation(res, color)
            p = init_cnn(gen, TahomaCNNConfig(*arch, input_hw=res,
                                              input_channels=rep.channels),
                         device=dev)
            x = color_transform(resize_area(sample, res), color)
            with torch.no_grad():
                p["out_b"] -= cnn_forward(p, x).median()
                s = cnn_predict_proba(p, x).cpu().numpy()
            if l < len(levels) - 1:
                ths.append((float(np.quantile(s, 0.25)),
                            float(np.quantile(s, 0.75))))
            params.append(p)
            reps.append(rep)
        ths.append((None, None))
        out.append(CompiledCascade(
            name, ("random", i), reps,
            [partial(cnn_predict_proba, p) for p in params], ths,
            cost_s=1e-5 * (i + 1), selectivity=0.5,
            stage0=Stage0(params[0], reps[0], quantize_cnn(params[0]))))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=2048)
    ap.add_argument("--lanes", type=int, default=2,
                    help="shards per visible GPU")
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this check runs on the card",
              file=sys.stderr)
        return 2
    from chip_smoke import straddles
    from repro_torch.device import resolve_device
    from repro_torch.engine.scan import ScanEngine, naive_scan
    from repro_torch.engine.sharded import ShardedScanEngine
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import host_device_count, shard_devices

    dev = resolve_device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build_all()
    n_gpu = host_device_count()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    corpus = torch.randint(0, 256, (args.frames, 224, 224, 3),
                           generator=gen, device=dev).float() / 256
    # coarse structure the random CNNs can tell apart: half-tone images
    corpus = torch.floor((corpus + corpus.mean(dim=(1, 2), keepdim=True))
                         * 128) / 256
    cascades = cascades_on(corpus, gen, dev)
    chunk = args.chunk

    serial = ScanEngine(corpus, chunk=chunk, device=dev)
    serial.execute(cascades)
    serial.reset_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = serial.execute(cascades).indices
    torch.cuda.synchronize()
    print(f"{n_gpu} GPU(s); serial ScanEngine on {dev}: {len(want)} rows "
          f"of {args.frames}, {(time.perf_counter() - t0) * 1e3:.3f} ms",
          flush=True)
    naive = naive_scan(corpus, cascades, chunk=chunk, device=dev)
    widths = [16 << i for i in range(chunk.bit_length())
              if 16 << i <= chunk]
    bad = 0
    shards = args.lanes * n_gpu
    for parallel in (True, False):
        eng = ShardedScanEngine(corpus, shards=shards, chunk=chunk,
                                devices=shard_devices(shards), device=dev)
        eng.execute(cascades, parallel=parallel)
        eng.reset_cache()
        for d in range(n_gpu):
            torch.cuda.reset_peak_memory_stats(d)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.execute(cascades, parallel=parallel)
        for d in range(n_gpu):
            torch.cuda.synchronize(d)
        ms = (time.perf_counter() - t0) * 1e3
        st = res.stats
        peaks = [round(torch.cuda.max_memory_allocated(d) / 1e6, 1)
                 for d in range(n_gpu)]
        print(f"{shards} shards {st.backend}: {len(res.indices)} rows, "
              f"devices {[str(d) for d in eng.devices]}, lanes {st.lanes}, "
              f"distinct devices {st.n_devices}, supersteps "
              f"{st.supersteps}, stage-0 launches "
              f"{ops.LAUNCHES['fused_pyramid_stage0']}, {ms:.3f} ms, peak "
              f"MB per GPU {peaks}", flush=True)
        for label, rows in (("the serial scan", want), ("naive_scan", naive)):
            diff = np.setxor1d(res.indices, rows)
            found = straddles(corpus, cascades, diff, chunk, widths=widths)
            unexplained = [int(r) for r in diff if int(r) not in found]
            bad += len(unexplained)
            print(f"  vs {label}: identical rows: {not len(diff)}"
                  + (f"; {len(found)} threshold-boundary rows"
                     if found else "")
                  + (f"; UNEXPLAINED {unexplained[:8]}"
                     if unexplained else ""), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
