"""Device resolution shared by every entry point of the port.

``resolve_device(None)`` is ``cuda``: the port runs on the card unless the
caller asks for the CPU. A CUDA request without a card raises — nothing
falls back to the CPU. On the card, "f32" means f32: TF32 is switched off
for matmuls and convolutions, and cuDNN autotuning is off so that a row's
score does not depend on which algorithm a batch width happened to pick.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device unless device='cpu' is "
                "passed, and torch.cuda.is_available() is False")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def tensor_device(tree) -> torch.device | None:
    """Device of the first tensor in a nested dict/list tree (None if the
    tree holds no tensor)."""
    if torch.is_tensor(tree):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            dev = tensor_device(v)
            if dev is not None:
                return dev
    return None


def params_device(params, device=None) -> torch.device:
    """``resolve_device(device)``, after checking that ``params`` (a tree
    of tensors) lie on that device: an entry point computes where its
    weights are and never moves them."""
    dev = resolve_device(device)
    pdev = tensor_device(params)
    if pdev is None or pdev.type != dev.type or (
            dev.index is not None and pdev.index != dev.index):
        raise ValueError(f"params on {pdev}, running on {dev}")
    return pdev
