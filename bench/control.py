"""Readings the limits of ``correct`` are set from, at a cell's own size.

    python3 bench/control.py --workload scan3.cold --seeds 11 12 13

For each seed, in one process, two runs of the cell's own loop through
``harness.execute`` with a window of one round of every camera (what a
run compares): the program, and the control, the plain reference put in
the program's place and computed in TF32 (operands of every convolution
and product rounded to TF32, TF32 on). Both are judged by the loop's own
comparison against the f32 reference, so the control's run reads
``correct`` false. Prints one JSON line a run: seed, side, ``correct``
and the numbers compared with their limits. Needs a card.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "bench" / ".cache"
                                             / "cuda"))
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


class Reference:
    """The system interface of ``bench/program.py`` (``prepare``,
    ``compile_cascades``, ``engine``) answered by the plain reference in
    ``precision`` ("tf32": the control)."""

    def __init__(self, block: int, precision: str = "tf32"):
        self.block, self.precision = block, precision

    def prepare(self, device) -> None:
        from bench import program
        program.prepare(device)       # the same device settings as a run

    def compile_cascades(self, cascades: list) -> list:
        return cascades

    def engine(self, corpus, meta: dict, chunk: int, device):
        return _ReferenceEngine(corpus, meta, self.block, self.precision)


class _ReferenceEngine:
    def __init__(self, corpus, meta: dict, block: int, precision: str):
        self.corpus, self.meta = corpus, meta
        self.block, self.precision = block, precision

    def reset_cache(self) -> None:
        pass

    def execute(self, cascades, metadata_eq):
        import numpy as np

        from bench.reference import scan_ref
        mask = np.ones(len(self.corpus), bool)
        for col, val in metadata_eq.items():
            mask &= np.asarray(self.meta[col]) == val
        rows = np.flatnonzero(mask)
        ids, reach, _ = scan_ref.scan_answer(self.corpus, rows, cascades,
                                             self.precision, self.block)
        return SimpleNamespace(indices=ids, stats=SimpleNamespace(
            rows_scanned=len(rows), rows_evaluated=sum(r[0] for r in reach)))


def reading(cell: dict, seed: int, side: str, device) -> dict:
    """One run of ``cell`` on ``seed`` with the program (``side``
    "program") or the TF32 control ("control") in the system's place."""
    from bench import harness
    system = None if side == "program" else \
        Reference(int(cell["config"]["reference_block"]))
    t0 = time.perf_counter()
    code, result, lines = harness.execute(
        cell, seed=seed, seconds=0.0, trace=False, device=device,
        t_start=time.time(), system=system)
    if result is None:
        raise RuntimeError("; ".join(lines))
    return {"seed": seed, "side": side, "correct": result["correct"],
            "checks": result["checks"], "attempted": result["attempted"],
            "notes": [ln for ln in lines if ln.startswith(("boundary",
                                                           "wrong rows"))],
            "s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sides", nargs="+", default=["program", "control"],
                    choices=["program", "control"])
    args = ap.parse_args(argv)
    import torch

    from bench import spec
    if not torch.cuda.is_available():
        print("control readings are taken on the card", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load_benchmark(), args.workload)
    for seed in args.seeds:
        for side in args.sides:
            print(json.dumps(reading(cell, seed, side, "cuda:0")),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
