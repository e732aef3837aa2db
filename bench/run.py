"""Run one cell of the benchmark on the card and print its result line.

    python3 bench/run.py --workload scan3.cold --seed 7 --seconds 20 --trace 0

Reads the cell from BENCHMARK.json at the checkout's root, measures
``repro_torch`` (from the checkout's ``src``) for ``--seconds``, checks
every answer against the plain reference, and prints one JSON object as
the last line of standard output; the numbers compared, each beside its
limit, are the last lines of standard error. Exits non-zero, printing no
result, without enough CUDA devices or when the process has loaded JAX or
the JAX package.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the device's kernel cache at a fixed place inside the checkout, so only a
# cell's first run there builds
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "bench" / ".cache"
                                             / "cuda"))
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench import harness, spec
    cell = spec.cell(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    code, result, lines = harness.execute(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device="cuda:0", t_start=T_START)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    if result is None:
        return code
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
