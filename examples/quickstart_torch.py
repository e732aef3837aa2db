"""Quickstart on the PyTorch/CUDA port: the full TAHOMA loop on one binary
predicate, end to end, on a torch device (the twin of quickstart.py).

1. build a labeled corpus (synthetic stand-in for an ImageNet category);
2. system initialization (paper Fig. 2) on the device: train the A x F
   model grid with BCE + AdamW, calibrate per-model decision thresholds,
   profile costs;
3. enumerate + evaluate the cascades, compute the Pareto frontier under
   a deployment scenario;
4. select a cascade for the user's accuracy constraint and run a
   content-based query through it.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cuda]
      [--scenario CAMERA] [--tiny]

``--device`` defaults to ``cuda`` and raises without a card; pass
``--device cpu`` to run on the CPU.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import TahomaCNNConfig  # noqa: E402
from repro_torch.core.cascade import spec_levels  # noqa: E402
from repro_torch.core.pipeline import initialize_system  # noqa: E402
from repro_torch.core.query import (BinaryPredicate, Corpus,  # noqa: E402
                                    run_query)
from repro_torch.core.selector import pareto_set, select  # noqa: E402
from repro_torch.core.transforms import (apply_transform,  # noqa: E402
                                         representation_space)
from repro_torch.data.synthetic import (DEFAULT_PREDICATES,  # noqa: E402
                                        make_corpus, three_way_split)
from repro_torch.models.cnn import cnn_predict_proba  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scenario", default="CAMERA",
                    choices=["INFER_ONLY", "ARCHIVE", "ONGOING", "CAMERA"])
    ap.add_argument("--min-accuracy", type=float, default=0.85)
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-test scale: fewer models/images/steps")
    args = ap.parse_args()

    pred = DEFAULT_PREDICATES[1]
    print(f"== predicate: contains_object({pred.name}) ==")
    n_img = 240 if args.tiny else 480
    x, y = make_corpus(pred, n_img, hw=32, seed=0)
    splits = three_way_split(x, y, seed=1)

    print(f"initializing system on {args.device} (training model grid)...")
    t0 = time.time()
    if args.tiny:
        archs = [TahomaCNNConfig(1, 8, 16)]
        reps = representation_space([8, 16, 32], ("rgb", "gray"))
        steps = 40
    else:
        archs = [TahomaCNNConfig(1, 8, 16), TahomaCNNConfig(2, 16, 16)]
        reps = representation_space([8, 16, 32])
        steps = 150
    sys_ = initialize_system(*splits, archs=archs, reps=reps, steps=steps,
                             device=args.device)
    print(f"  {len(sys_.bank.entries)} models in {time.time()-t0:.0f}s")

    space = sys_.cascade_space(args.scenario)
    par = pareto_set(space)
    print(f"cascades evaluated: {len(space):,}; Pareto frontier: "
          f"{len(par)} points "
          f"(acc {space.acc[par].min():.3f}-{space.acc[par].max():.3f})")
    for i in par[:6]:
        print(f"  acc={space.acc[i]:.3f} {space.throughput[i]:9.0f} img/s  "
              f"{space.describe(int(i), sys_.bank.names, sys_.targets)}")

    floor = min(args.min_accuracy, float(space.acc.max()) - 0.01)
    sel = select(space, min_accuracy=floor)
    print(f"\nselected (acc>={floor:.2f}): acc={sel.accuracy:.3f} "
          f"{sel.throughput:.0f} img/s under {args.scenario}")
    levels = spec_levels(space, sel.index, sys_.p_low, sys_.p_high)

    @torch.no_grad()
    def executor(imgs):
        x = torch.as_tensor(imgs, device=sys_.device)
        out = np.zeros(len(imgs), np.int32)
        active = np.ones(len(imgs), bool)
        for m, lo, hi in levels:
            e = sys_.bank.entries[m]
            s = cnn_predict_proba(e.params,
                                  apply_transform(x, e.rep)).cpu().numpy()
            if lo is None:
                out[active] = (s >= 0.5)[active]
                active[:] = False
            else:
                dec = active & ((s <= lo) | (s >= hi))
                out[dec] = (s >= hi)[dec]
                active &= ~dec
        return out

    ev_x, ev_y = splits[2]
    corpus = Corpus(images=ev_x,
                    metadata={"city": np.where(np.arange(len(ev_x)) % 2,
                                               "detroit", "akron")})
    ids = run_query(corpus, metadata_eq={"city": "detroit"},
                    binary_preds=[BinaryPredicate(pred.name, executor)])
    prec = ev_y[ids].mean() if len(ids) else float("nan")
    print(f"\nquery: city='detroit' AND contains_object({pred.name})")
    print(f"  -> {len(ids)} matches, precision vs ground truth: {prec:.2f}")


if __name__ == "__main__":
    main()
