"""Hand-written Hopper kernels (csrc/*.cu, built by build.py, bound by
bindings.py) with their wrappers, their plain PyTorch versions (ref.py)
and the public entry points (ops.py). Nothing is compiled or loaded at
import time."""
