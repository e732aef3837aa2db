"""Dense MLPs, gated (silu: w_gate, w_up, w_down) and non-gated (w_in +
b_in, w_out + b_out), ported from the reference's ``models/ffn.py``.
Mixture-of-Experts is not ported yet."""
from __future__ import annotations

import torch

from repro_torch.models.common import activation, dense_init, pdtype


def init_mlp(gen, cfg, *, device):
    """Gated (w_gate, w_up, w_down) when ``cfg.act`` is silu."""
    d_ff = cfg.d_ff
    dt = pdtype(cfg)

    def dense(shape):
        return dense_init(gen, shape, 0, dt, device=device)

    if cfg.act == "silu":
        return {"w_gate": dense((cfg.d_model, d_ff)),
                "w_up": dense((cfg.d_model, d_ff)),
                "w_down": dense((d_ff, cfg.d_model))}
    return {"w_in": dense((cfg.d_model, d_ff)),
            "b_in": torch.zeros((d_ff,), dtype=dt, device=device),
            "w_out": dense((d_ff, cfg.d_model)),
            "b_out": torch.zeros((cfg.d_model,), dtype=dt, device=device)}


def apply_mlp(p, x, cfg):
    act = activation(cfg.act)
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    h = act(x @ p["w_in"] + p["b_in"])
    return h @ p["w_out"] + p["b_out"]
