"""Serving example on the PyTorch/CUDA port (the twin of serve_cascade.py):
a MIXED request stream ("does this frame contain a?" / "...contain b?")
over a frame corpus resident on the device, served by the shard-aware
AsyncCascadeService: requests hash-route to per-shard queues, each shard
dispatches on a lane of its own (a CUDA stream on the card), a deadline
wheel flushes bucketed batches (on the card the from-base flush runs the
``fused_pyramid_stage0`` kernel), labels commit to shard-owned virtual
columns (re-asked frames answer with zero model invocations), and pooled
pyramid levels are shared across concepts through the cross-query
representation cache.

  PYTHONPATH=src python examples/serve_cascade_torch.py [--requests 256]
      [--batch-size 64] [--shards 4] [--repeat 0.4] [--sync] [--host]
      [--device cuda]

``--sync`` runs the synchronous-polling CascadeService (serve/batcher.py)
instead. ``--host`` drives the async service with the wall-clock event
host (serve/host.py): a timer-parked thread fires deadline flushes, so
the client never calls ``poll()``. ``--device`` defaults to ``cuda`` and
raises without a card; pass ``--device cpu`` to run on the CPU. After the
stream, every served label is held against ``naive_scan``'s for its
concept (the sync service's capped levels may differ from it; the async
service's full-width levels do not, up to threshold-boundary rows).
"""
import argparse
import sys
import time
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import TahomaCNNConfig  # noqa: E402
from repro_torch.core.executor import Stage0, calibrate_capacity  # noqa
from repro_torch.core.pipeline import build_cascade_service  # noqa: E402
from repro_torch.core.pipeline import train_cnn  # noqa: E402
from repro_torch.core.transforms import (Representation,  # noqa: E402
                                         apply_transform)
from repro_torch.data.synthetic import (DEFAULT_PREDICATES,  # noqa: E402
                                        make_corpus)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.engine.scan import CompiledCascade, naive_scan  # noqa
from repro_torch.models.cnn import cnn_predict_proba, quantize_cnn  # noqa
from repro_torch.serve import EventHost, Request  # noqa: E402


def build_cascade(spec, batch_size: int, device, *, hw: int = 32,
                  steps: int = 150, n_train: int = 300):
    """Train a 2-level cascade (small gray@16 -> full rgb@hw) for one
    predicate on ``device`` and package it as a CompiledCascade, its
    level 0 in kernel-foldable form (Stage0)."""
    x, y = make_corpus(spec, n_train + 130, hw=hw, seed=0)
    x = torch.from_numpy(x).to(device)
    tr_x, tr_y = x[:n_train], y[:n_train]
    rep_fast = Representation(16, "gray")
    rep_full = Representation(hw, "rgb")
    fast_arch = TahomaCNNConfig(1, 8, 16, input_hw=16, input_channels=1)
    full_arch = TahomaCNNConfig(2, 16, 32, input_hw=hw, input_channels=3)
    p_fast = train_cnn(fast_arch, apply_transform(tr_x, rep_fast), tr_y,
                       steps=steps, device=device)
    p_full = train_cnn(full_arch, apply_transform(tr_x, rep_full), tr_y,
                       steps=steps + 50, device=device)
    # calibrate level-2 capacity from the observed uncertain fraction
    # (a sync-batcher knob: the async service runs full-width levels)
    with torch.no_grad():
        s = cnn_predict_proba(p_fast, apply_transform(
            x[n_train:], rep_fast)).cpu().numpy()
    unc = float(((s > 0.2) & (s < 0.8)).mean())
    cap = calibrate_capacity(unc, batch_size)
    print(f"  {spec.name}: uncertain fraction {unc:.2f} -> "
          f"level-2 capacity {cap}")
    return CompiledCascade(
        concept=spec.name, cascade_id=("serve-2level", spec.name),
        reps=[rep_fast, rep_full],
        model_fns=[partial(cnn_predict_proba, p_fast),
                   partial(cnn_predict_proba, p_full)],
        thresholds=[(0.2, 0.8), (None, None)], capacities=[cap],
        stage0=Stage0(p_fast, rep_fast, quantize_cnn(p_fast)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--shards", type=int, default=None,
                    help="shard-queue count (default: one per device)")
    ap.add_argument("--repeat", type=float, default=0.4,
                    help="fraction of requests re-asking an earlier frame")
    ap.add_argument("--pace", type=float, default=0.002,
                    help="inter-arrival gap in seconds (0 = burst)")
    ap.add_argument("--sync", action="store_true",
                    help="synchronous batcher (serve/batcher.py)")
    ap.add_argument("--host", action="store_true",
                    help="drive the async service with the wall-clock "
                         "event host (no caller poll())")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-test scale")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.tiny:
        args.requests = min(args.requests, 48)
        args.batch_size = min(args.batch_size, 16)
    steps = 40 if args.tiny else 150
    dev = resolve_device(args.device)

    specs = (DEFAULT_PREDICATES[1], DEFAULT_PREDICATES[4])
    print(f"training one 2-level cascade per predicate on {args.device}...")
    cascades = {s.name: build_cascade(s, args.batch_size, dev, steps=steps)
                for s in specs}

    # resident candidate corpus + ground truth per concept
    n_corpus = max(args.requests, 64)
    frames = {s.name: make_corpus(s, n_corpus, hw=32, seed=9)
              for s in specs}
    corpus = torch.from_numpy(np.concatenate(
        [frames[s.name][0] for s in specs])).to(dev)
    offset = {s.name: i * n_corpus for i, s in enumerate(specs)}

    mode = "sync" if args.sync else "async"
    service = build_cascade_service(
        corpus, cascades, mode=mode, shards=args.shards,
        batch_size=args.batch_size, max_wait_s=0.005, device=dev)
    print(f"serving mode: {mode}"
          + ("" if args.sync else
             f"  ({service.n_shards} shard queues on "
             f"{service.summary()['lanes']} lanes over "
             f"{len(set(service.devices))} devices)"))
    if mode == "async":
        n = service.warmup()      # no first-call set-up under live traffic
        print(f"warmed {n} executions")
    host = None
    if args.host and mode == "async":
        host = EventHost(service).start()
        print("event host started (deadlines fire without caller poll)")

    # mixed stream: each request asks about ONE predicate's concept;
    # a --repeat fraction re-asks an already-served frame
    rng = np.random.default_rng(13)
    results = []
    t0 = time.perf_counter()
    for i in range(args.requests):
        spec = specs[i % len(specs)]
        fresh = i < 8 or rng.uniform() >= args.repeat
        j = (i if fresh else int(rng.integers(0, i))) // len(specs)
        row = offset[spec.name] + j
        r = Request(i, row if mode == "async" else corpus[row])
        (host or service).submit(spec.name, r)
        results.append((spec.name, j, row, r))
        if host is None:
            service.poll()
        if args.pace:
            time.sleep(args.pace)
    if host is not None:
        host.wait_idle(60.0)      # event-driven: no poll, no drain
        host.stop()
    else:
        service.drain()
    dt = time.perf_counter() - t0

    from repro_torch.kernels.ops import LAUNCHES
    lat = np.array(service.latencies()) * 1e3
    print(f"\nserved {args.requests} mixed requests in {dt:.2f}s "
          f"({args.requests / dt:.0f} img/s)")
    for c in service.concepts:
        y = frames[c][1]
        acc = np.mean([int(r.result) == int(y[j])
                       for cc, j, _, r in results if cc == c])
        st = service.stats[c]
        extra = (f"store_hits={st.store_hits} " if mode == "async" else "")
        print(f"  {c}: batches={st.batches} {extra}"
              f"padded={st.padded_slots} accuracy={acc:.3f}")
    if mode == "async":
        summ = service.summary()
        print(f"store hit rate {summ['store_hit_rate']:.2f}  "
              f"repcache hit rate "
              f"{summ['repcache']['hit_rate']:.2f}  "
              f"deadline/size/drain flushes "
              f"{summ['deadline_flushes']}/{summ['size_flushes']}"
              f"/{summ['drain_flushes']}")
        p = summ["latency_ms"]
        print(f"latency p50={p['p50']}ms p95={p['p95']}ms "
              f"p99={p['p99']}ms  queue depth max="
              f"{summ['queue_depth']['max']}  in-flight max="
              f"{summ['in_flight']['max']}")
    else:
        print(f"latency p50={np.percentile(lat, 50):.1f}ms "
              f"p99={np.percentile(lat, 99):.1f}ms")

    # every served label against naive_scan's for its concept
    want = {}
    for c, casc in cascades.items():
        col = np.zeros(len(corpus), np.int8)
        col[naive_scan(corpus, [casc], chunk=args.batch_size,
                       device=dev)] = 1
        want[c] = col
    diff = sum(int(r.result) != int(want[c][row])
               for c, _, row, r in results)
    print(f"identical labels vs naive_scan: {diff == 0} ({diff} of "
          f"{len(results)} differ)")
    print(f"fused_pyramid_stage0 launches (warmup and flushes): "
          f"{LAUNCHES['fused_pyramid_stage0']}")


if __name__ == "__main__":
    main()
