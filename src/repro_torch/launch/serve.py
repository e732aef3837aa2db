"""Serving launcher: prefill + batched greedy decode, ported from the
reference's ``launch/serve.py`` for the architectures the port runs.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      [--batch 8 --prompt-len 64 --gen 32 --kv-dtype bfloat16 --full] \\
      [--device cuda]

``--arch`` takes every architecture the port registers: the hybrid
zamba2-1.2b, the ssm mamba2-130m, and the dense deepseek-7b, minitron-4b,
granite-20b and qwen2.5-32b (``--arch deepseek-7b --full`` serves its 6.9 B
parameters at full width on one card).

Without ``--full`` the arch's smoke config is served. Weights and prompts
are random, seeded with 0 as the reference seeds them. ``--device``
defaults to ``cuda``; without a card that raises, and ``--device cpu``
runs the plain versions of the kernels.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import params_device, resolve_device

_CACHE_SEQ_LEAVES = ("k", "v", "k_scale", "v_scale")


@dataclass
class ServeResult:
    tokens: torch.Tensor   # (B, gen+1): the prefill's argmax, then one per step
    logits: torch.Tensor   # (gen+1, B, Vp): what each token was taken from
    prefill_s: float       # prefill + cache growth + first argmax
    decode_s: float        # all ``gen`` decode steps


def grow_cache(cache, extra: int):
    """Room for ``extra`` more tokens: the attention leaves (axis 2 is the
    sequence) are zero-padded, as the reference's ``grow`` pads them."""
    def grow(name, x):
        if isinstance(x, dict):
            return {k: grow(k, v) for k, v in x.items()}
        if name in _CACHE_SEQ_LEAVES and x.dim() >= 3:
            pad = x.new_zeros(x.shape[:2] + (extra,) + x.shape[3:])
            return torch.cat([x, pad], dim=2)
        return x
    return grow("", cache)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(model, params, tokens, gen: int, kv_dtype: str = "bfloat16", *,
          device=None) -> ServeResult:
    """Prefill ``tokens`` (B, S), then ``gen`` greedy decode steps. Runs
    on the card unless ``device`` says otherwise; ``params`` must lie on
    that device."""
    pdev = params_device(params, device)
    tokens = torch.as_tensor(tokens).to(device=pdev, dtype=torch.int64)
    _sync(pdev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens},
                                  kv_dtype=kv_dtype)
    cache = grow_cache(cache, gen)
    tok = torch.argmax(logits, -1)[:, None]
    _sync(pdev)
    prefill_s = time.perf_counter() - t0
    out, seen = [tok], [logits]
    t0 = time.perf_counter()
    for _ in range(gen):
        logits, cache = model.decode(params, cache, {"tokens": tok})
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok)
        seen.append(logits)
    _sync(pdev)
    return ServeResult(torch.cat(out, 1), torch.stack(seen), prefill_s,
                       time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--kv-dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "int8"])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_arch, smoke_config
    from repro_torch.models.factory import build_model, count_params

    cfg = get_arch(args.arch) if args.full else smoke_config(args.arch)
    dev = resolve_device(args.device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    print(f"arch={cfg.name} params={count_params(params):,} "
          f"kv={args.kv_dtype} device={dev}")
    b, s = args.batch, args.prompt_len
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                       (b, s))
    res = serve(model, params, tokens, args.gen, args.kv_dtype, device=dev)
    rate = (f"{args.gen * b / res.decode_s:.1f} tok/s" if res.decode_s > 0
            else "no decode steps")
    print(f"prefill {b}x{s} in {res.prefill_s * 1e3:.3f} ms | decoded "
          f"{args.gen} toks x batch {b} in {res.decode_s:.3f}s ({rate}) | "
          f"sample: {res.tokens[0, :8].tolist()}")
    return res


if __name__ == "__main__":
    main()
