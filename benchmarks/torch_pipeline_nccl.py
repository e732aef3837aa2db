"""``train/pipeline_parallel.pipeline_forward`` on two NCCL ranks, a card
each, against the stack run without a pipeline: the two-card part of
chip_smoke.py's ``== fleet tooling`` phase alone (chip_smoke.py runs on
one card, where NCCL refuses two ranks, and prints that it did not run).

    python3 benchmarks/torch_pipeline_nccl.py     # from the repo root

Needs two or more cards. Prints the cards' name and power limit
(nvidia-smi) and chip_smoke.pipeline_check's line: each rank's time for
8 micro-batches of (256, 4096) f32 through tanh(h @ w) a stage, and
whether its outputs are ``torch.equal`` to the stack's; it fails if any
output is more than 1e-6 off.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke
    if torch.cuda.device_count() < 2:
        print(f"needs two cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    chip_smoke.pipeline_check(torch.device("cuda"),
                              chip_smoke.FULL["fleet"]["pipe"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
