"""Measure the per-model inference costs of chip_smoke.py's query-path bank
on the card and write them as the pinned cost file.

    python3 benchmarks/torch_infer_costs.py \
        [--out src/repro_torch/configs/infer_costs_h100.json] [--rounds 5]

The bank is the one ``initialize_system`` trains in chip_smoke.py's query
phase (the paper grid, 18 architectures x {28, 56, 112, 224} px x 5
colors, plus the trusted model at 224 px rgb; the same names), built by
``train_model_grid`` with 0 training steps: a model's inference time
does not depend on its weights. Each round runs the port's own profiler
(``core/pipeline.profile_infer_costs``: 32 frames a call, best of 3 timed
calls with CUDA events, seconds per image); the file keeps each model's
median over the rounds, with the card's name and power limit
(nvidia-smi) beside the costs. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

DEFAULT_OUT = ROOT / "src" / "repro_torch" / "configs" / "infer_costs_h100.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the costs are measured on the card",
              file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.core.pipeline import (profile_infer_costs,
                                           train_model_grid)
    from repro_torch.data.synthetic import DEFAULT_PREDICATES, make_corpus
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")
    cfg = chip_smoke.FULL
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    archs, reps, _ = chip_smoke.grid(cfg)
    x, y = make_corpus(DEFAULT_PREDICATES[0], 32, hw=cfg["base"], seed=0)
    bank = train_model_grid(x, y, archs, reps, steps=0, device=dev)
    rounds = [profile_infer_costs(bank, x) for _ in range(args.rounds)]
    costs = {n: statistics.median(r[n] for r in rounds) for n in bank.names}
    name, limit = (s.strip() for s in smi.split(","))
    out = {"card": name, "power_limit": limit,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "source": "benchmarks/torch_infer_costs.py",
           "method": f"median over {args.rounds} rounds of "
                     f"profile_infer_costs (32 frames a call, best of 3 "
                     f"CUDA-event timings), seconds per image",
           "infer_s": costs}
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    spread = sorted(max(r[n] for r in rounds) / min(r[n] for r in rounds)
                    for n in bank.names)
    print(f"{len(costs)} models: {min(costs.values()) * 1e6:.3f} to "
          f"{max(costs.values()) * 1e6:.3f} us/image; max/min over rounds "
          f"median {spread[len(spread) // 2]:.3f}, worst {spread[-1]:.3f}; "
          f"written to {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
