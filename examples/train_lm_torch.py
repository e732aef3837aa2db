"""End-to-end training example of the PyTorch/CUDA port, the twin of
examples/train_lm.py: train an LM (the arch's smoke config; --full for its
full config) for a few hundred steps with the fault-tolerant runtime —
checkpoints, failure injection + recovery, straggler detection, optional
gradient compression. Runs on the card unless --device cpu is given.

  PYTHONPATH=src python examples/train_lm_torch.py --arch mamba2-130m \\
      --steps 200 [--compress topk] [--inject-failure 50] [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import main  # noqa: E402

if __name__ == "__main__":
    if "--steps" not in " ".join(sys.argv):
        sys.argv += ["--steps", "200"]
    main()
