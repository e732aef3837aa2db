"""The paper's own model grid: A (architecture space) and the reduced grids
used for CPU-scale experiments. F (representation space) lives in
core/transforms.py; the model design space is A x F (paper §IV Def. 5/6).
"""
from __future__ import annotations

import itertools

from repro_torch.configs.base import TahomaCNNConfig

# Paper §VII-A2 settings (360 models = 18 archs x 20 representations).
PAPER_CONV_LAYERS = (1, 2, 4)
PAPER_CONV_NODES = (16, 32)
PAPER_DENSE_NODES = (16, 32, 64)
PAPER_RESOLUTIONS = (30, 60, 120, 224)
PAPER_COLOR_REPS = ("rgb", "r", "g", "b", "gray")

# Reduced grid for the 1-core CPU container (structure-preserving subset).
SMALL_CONV_LAYERS = (1, 2)
SMALL_CONV_NODES = (8, 16)
SMALL_DENSE_NODES = (16, 32)
SMALL_RESOLUTIONS = (16, 32, 64)
SMALL_COLOR_REPS = ("rgb", "r", "g", "b", "gray")


def architecture_space(small: bool = True) -> list[TahomaCNNConfig]:
    layers = SMALL_CONV_LAYERS if small else PAPER_CONV_LAYERS
    conv = SMALL_CONV_NODES if small else PAPER_CONV_NODES
    dense = SMALL_DENSE_NODES if small else PAPER_DENSE_NODES
    return [
        TahomaCNNConfig(n_conv_layers=l, conv_nodes=c, dense_nodes=d)
        for l, c, d in itertools.product(layers, conv, dense)
    ]


def representation_space(small: bool = True) -> list[tuple[int, str]]:
    res = SMALL_RESOLUTIONS if small else PAPER_RESOLUTIONS
    col = SMALL_COLOR_REPS if small else PAPER_COLOR_REPS
    return list(itertools.product(res, col))
