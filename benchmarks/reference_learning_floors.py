"""Do the reference's models clear chip_smoke.py's learning floors on the
query phase's data? A cut of that phase, run with the JAX reference on
the CPU.

    PYTHONPATH=src python benchmarks/reference_learning_floors.py \
        [--predicate 1] [--resolutions 28 56] [--steps 90]

The data follow chip_smoke.py's (FULL) image model and sizes: one
predicate of ``DEFAULT_PREDICATES[:3]``, a 1024-frame training split
(``make_corpus(spec, 1024, hw=224, seed=seed + 30)``) and the 512-frame
eval split (``seed + 20``); chip_smoke.py draws frames of the same model
on the card with torch's generator (``chip_smoke.synth``), so its
accuracies are another draw of the same task. The grid is cut to the paper's 18
architectures at the given resolutions in all five colors, plus the
trusted model at 224 px rgb, trained with ``train_model_grid``'s seeds
and steps. Prints each model's eval accuracy, the best model's and the
trusted model's, and the floors chip_smoke.py holds the port to (best
> 0.85, trusted > 0.80, tests/test_system.py's).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro.configs.base import TahomaCNNConfig
from repro.configs.tahoma_cnn import architecture_space
from repro.core.pipeline import train_model_grid
from repro.core.transforms import Representation
from repro.data.synthetic import DEFAULT_PREDICATES, make_corpus

COLORS = ("rgb", "r", "g", "b", "gray")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--predicate", type=int, default=1)
    ap.add_argument("--resolutions", type=int, nargs="+", default=[28, 56])
    ap.add_argument("--steps", type=int, default=90)   # chip_smoke's
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    spec = DEFAULT_PREDICATES[:3][args.predicate]
    tr_x, tr_y = make_corpus(spec, 1024, hw=224, seed=args.seed + 30)
    ev_x, ev_y = make_corpus(spec, 512, hw=224, seed=args.seed + 20)
    archs = [TahomaCNNConfig(a.n_conv_layers, a.conv_nodes, a.dense_nodes)
             for a in architecture_space(small=False)]
    reps = [Representation(r, c) for r in args.resolutions for c in COLORS]
    t0 = time.perf_counter()
    bank = train_model_grid(tr_x, tr_y, archs, reps, steps=args.steps,
                            seed=args.seed)
    t_train = time.perf_counter() - t0
    scores = bank.score_matrix(ev_x)
    acc = ((scores >= 0.5) == ev_y[None].astype(bool)).mean(1)
    for name, a in zip(bank.names, acc):
        print(f"  {name}: eval accuracy {a:.4f}")
    best = int(np.argmax(acc))
    ti = bank.trusted_index
    print(f"predicate {spec.name}: {len(bank.entries)} models trained in "
          f"{t_train:.1f} s (JAX reference, CPU)")
    print(f"best model {bank.names[best]} {acc[best]:.4f} (floor "
          f"0.85: {'clears' if acc[best] > 0.85 else 'MISSES'}); trusted "
          f"{acc[ti]:.4f} (floor 0.80: "
          f"{'clears' if acc[ti] > 0.80 else 'MISSES'}); bank mean "
          f"{acc.mean():.4f}")


if __name__ == "__main__":
    main()
