"""The tensor-parallel, context-parallel and ZeRO steps on NCCL ranks, one
card a rank: chip_smoke.py's ``== tensor parallel``, ``== context
parallel`` and ``== ZeRO layers`` phases (gloo ranks sharing one card,
since NCCL refuses two ranks on one card) on a machine with several cards.

    python3 benchmarks/torch_tp_nccl.py [--part tp|cp|zero|all]   # repo root

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
gradient). Then (``--part cp``) the context-parallel decode on (data 2,
model 1), (data 4, model 1) and (data 2, model 2) where the cards are
there: chip_smoke.cp_check's lines, zamba2-1.2b whole at long_500k
(batch 1, the cache's 524288 positions split over 'data'), a prompt and
greedy steps from its end and across the middle blocks' edge, held
against the one-rank path on the first card (bf16 logits within 0.05
of the largest and tokens equal but for near-ties; f32 at seq_len 65536
within 1e-5, tokens equal). Then (``--part zero``) the ZeRO train step
on (data 2, model 1), (data 4, model 1) and (data 2, model 2):
chip_smoke.zero_check's lines, zamba2-1.2b at its published widths,
each rank holding its shard of the weights and AdamW state and the step
gathering each layer's leaves over 'data' as the layer runs: a bf16
step at full depth (global batch 4 x 512; the rank's memory rise, the
collectives a micro-batch against the specs, the launches) and an f32
step at one segment's depth held against the one-rank step on the
first card (loss, gradients, parameters after AdamW, m and v). Prints
the cards' name and power limit (nvidia-smi) first.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import argparse

    import torch

    import chip_smoke
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part", choices=("tp", "cp", "zero", "all"),
                    default="all")
    part = ap.parse_args(argv).part
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
    dev = torch.device("cuda")
    for n in (2, 4) if part in ("tp", "all") else ():
        if n > cards:
            break
        print(f"== (data 1, model {n}), {n} NCCL ranks", flush=True)
        chip_smoke.tp_check(dev, dict(chip_smoke.FULL["tp"], model=n),
                            "nccl", 0)
    for data, model in ((2, 1), (4, 1), (2, 2)) if part in ("cp", "all") \
            else ():
        if data * model > cards:
            continue
        print(f"== context parallel (data {data}, model {model}), "
              f"{data * model} NCCL ranks", flush=True)
        t0 = time.perf_counter()
        chip_smoke.cp_check(dev, dict(chip_smoke.FULL["cp"], data=data,
                                      model=model), "nccl", 31)
        print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
    for data, model in ((2, 1), (4, 1), (2, 2)) if part in ("zero", "all") \
            else ():
        if data * model > cards:
            continue
        print(f"== ZeRO layers (data {data}, model {model}), "
              f"{data * model} NCCL ranks", flush=True)
        t0 = time.perf_counter()
        chip_smoke.zero_check(dev, dict(chip_smoke.FULL["zero"], data=data,
                                        model=model), "nccl", 41)
        print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
