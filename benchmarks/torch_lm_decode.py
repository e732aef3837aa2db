"""Time the port's LM serve (prefill and greedy decode steps) at full
width, for comparing two checkouts of the port on one card.

    python3 benchmarks/torch_lm_decode.py [--src SRC] [--label NAME] \
        [--arch deepseek-7b zamba2-1.2b] [--batch 8] [--prompt 512] \
        [--gen 32] [--reps 3]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (by
default this checkout's), so an unpacked older commit can be timed by
the same script in the same call: run old, new, new, old and compare
within the call. Each arch is built at its published config with random
bf16 weights (seed 0), served once for warm-up (2 steps), then ``--reps``
times through ``launch.serve.serve`` with bf16 KV. Prints the card's name
and power limit, then one JSON line per arch with every rep's prefill
ms and decode ms/step and their medians. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--arch", nargs="+",
                    default=["deepseek-7b", "zamba2-1.2b"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the serve is timed on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models.factory import build_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    for name in args.arch:
        cfg = get_arch(name)
        model = build_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = model.init(gen, device=dev)
        prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                                generator=gen, device=dev)
        serve(model, params, prompts, 2, "bfloat16", device=dev)
        prefill, decode = [], []
        for _ in range(args.reps):
            res = serve(model, params, prompts, args.gen, "bfloat16",
                        device=dev)
            prefill.append(res.prefill_s * 1e3)
            decode.append(res.decode_s * 1e3 / args.gen)
        print(json.dumps({
            "label": args.label, "arch": name, "batch": args.batch,
            "prompt": args.prompt, "gen": args.gen, "card": smi,
            "prefill_ms": prefill, "decode_ms_per_step": decode,
            "prefill_ms_median": statistics.median(prefill),
            "decode_ms_per_step_median": statistics.median(decode)}),
            flush=True)
        del model, params, res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
