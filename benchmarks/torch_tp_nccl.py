"""The tensor-parallel steps on NCCL ranks, one card a rank: chip_smoke.py's
``== tensor parallel`` phase (two gloo ranks sharing one card, since NCCL
refuses two ranks on one card) on a machine with several cards.

    python3 benchmarks/torch_tp_nccl.py     # from the repo root

Needs two or more cards: a (data 1, model 2) mesh, and (data 1, model 4)
where four are present. On each mesh, chip_smoke.tp_check's lines:
zamba2-1.2b at its published widths and depth, deepseek-7b at 4 of its
30 layers, phi3.5-moe at 2 of 32 and deepseek-v2 at 1 of 60 (experts
and MLA heads split over 'model') served (8 prompts x 512 tokens, then
greedy steps), and whisper-tiny whole on 1500 frames (8 x 128; on 4
ranks its 6 heads padded to 8) through ``launch/steps`` on random bf16
weights, each rank's parameter bytes and peak memory beside the
one-rank path's on rank 0's card, the prefill logits and greedy tokens
held against it, the MoE routing hashes equal on every rank and on one
card; and f32 train steps of zamba2-1.2b (8 x 512) and phi3.5-moe (1
layer, 2 x 256) held against the one-rank step (loss, each leaf's
gradient). Prints the cards' name and power limit (nvidia-smi) first.
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
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"needs two cards, this machine has {cards}", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    build.build_all()            # once, before the ranks load the kernels
    for n in (2, 4):
        if n > cards:
            break
        print(f"== (data 1, model {n}), {n} NCCL ranks", flush=True)
        chip_smoke.tp_check(torch.device("cuda"),
                            dict(chip_smoke.FULL["tp"], model=n), "nccl", 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
