"""Config dataclasses of the Tahoma model family (copy of the reference's
``TahomaCNNConfig``; the LM configs are not part of this package yet)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TahomaCNNConfig:
    """Paper Fig. 3 family: [conv->relu->maxpool] x L -> dense relu -> sigmoid.

    A (architecture space): n_conv_layers x conv_nodes x dense_nodes.
    F (representation space) lives in core/transforms.py, not here.
    """
    n_conv_layers: int = 2
    conv_nodes: int = 32
    dense_nodes: int = 32
    kernel_size: int = 3
    input_hw: int = 60
    input_channels: int = 3

    @property
    def arch_id(self) -> str:
        return f"cnn_l{self.n_conv_layers}_c{self.conv_nodes}_d{self.dense_nodes}"
