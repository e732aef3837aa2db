"""Hand-written Hopper kernels (csrc/*.cu, built by build.py, bound by
ops.py) with their plain PyTorch versions (ref.py). Nothing is compiled
or loaded at import time."""
