"""NVIDIA H100 figures for the roofline model (per card), the port's
counterpart of the reference's TPU constants.

``PEAKS`` holds one row per H100 part, from NVIDIA's H100 Tensor Core GPU
data sheet (dense rates, no sparsity, at the part's full power limit):

* ``hbm_bw``: HBM bytes/s (SXM 3.35 TB/s HBM3, PCIe 2.0 TB/s HBM2e, NVL
  3.9 TB/s HBM3);
* ``f32_flops``: float32 FLOP/s outside the tensor cores, the FFMA rate
  (SXM 67, PCIe 51, NVL 60 TFLOP/s);
* ``bf16_flops``: dense bf16 tensor-core FLOP/s (SXM 989, PCIe 756, NVL
  835 TFLOP/s).

A card set below its power limit runs slower than these under load, so
every time held against them is printed beside the card's limit.

``NVLINK_BW`` is the SXM card's NVLink 4 figure: 18 links x 50 GB/s
counting both directions, 900e9 B/s a GPU. It holds inside one node of 8
cards. ``CHIPS_SINGLE_POD`` and ``CHIPS_MULTI_POD`` are the production
meshes' rank counts: a 256-rank mesh spans 32 nodes of 8, whose links
between nodes (InfiniBand or Ethernet) are slower than NVLink, so
collective seconds over ``NVLINK_BW`` are a lower bound.

``peaks(name)`` looks a row up by ``torch.cuda.get_device_name()``; the
most specific part name is matched first ("H100 PCIe" before "H100").
"""
from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    part: str
    hbm_bw: float        # B/s
    f32_flops: float     # FLOP/s, f32 FFMA
    bf16_flops: float    # FLOP/s, dense bf16 tensor cores


PEAKS = (Peaks("H100 PCIe", 2.0e12, 51e12, 756e12),
         Peaks("H100 NVL", 3.9e12, 60e12, 835e12),
         Peaks("H100", 3.35e12, 67e12, 989e12))
SXM = PEAKS[-1]
PEAK_FLOPS_BF16 = SXM.bf16_flops
HBM_BW = SXM.hbm_bw
NVLINK_BW = 900e9    # B/s a GPU: 18 NVLink 4 links x 50 GB/s (SXM)
CHIPS_SINGLE_POD = 256
CHIPS_MULTI_POD = 512


def peaks(device_name: str) -> Peaks:
    """The row of the part ``device_name`` names (as
    ``torch.cuda.get_device_name()`` gives it); a card the table does not
    name raises."""
    for row in PEAKS:
        if row.part in device_name:
            return row
    raise KeyError(f"no peak figures for {device_name!r}: launch/hw.PEAKS "
                   f"names {[r.part for r in PEAKS]}")
