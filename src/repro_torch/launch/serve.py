"""Serving launcher: prefill + batched greedy decode for any --arch, ported
from the reference's ``launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      [--batch 8 --prompt-len 64 --gen 32 --kv-dtype bfloat16 --full] \\
      [--device cuda]

``--arch`` takes all ten of the reference's architectures: the hybrid
zamba2-1.2b, the ssm mamba2-130m, the dense deepseek-7b, minitron-4b,
granite-20b and qwen2.5-32b, the moe phi3.5-moe-42b-a6.6b and
deepseek-v2-236b (MLA), the vlm qwen2-vl-72b (M-RoPE) and the audio
whisper-tiny (encoder-decoder). ``--arch deepseek-7b --full`` serves its
6.9 B parameters at full width on one card; the larger archs do not fit
one card at full depth.

Without ``--full`` the arch's smoke config is served. Weights, prompts and
the audio family's frame embeddings are random, seeded with 0 as the
reference seeds them; the vlm family gets the reference's M-RoPE
positions (all three streams count tokens). ``--device`` defaults to
``cuda``; without a card that raises, and ``--device cpu`` runs the plain
versions of the kernels.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import params_device, resolve_device
from repro_torch.serve.kvcache import SEQ_LEAVES



@dataclass
class ServeResult:
    tokens: torch.Tensor   # (B, gen+1): the prefill's argmax, then one per step
    logits: torch.Tensor   # (gen+1, B, Vp): what each token was taken from
    prefill_s: float       # prefill + cache growth + first argmax
    decode_s: float        # all ``gen`` decode steps


def grow_cache(cache, extra: int):
    """Room for ``extra`` more tokens: the attention and MLA leaves (axis 2
    is the sequence) are zero-padded, as the reference's ``grow`` pads
    them; the audio family's cross cache (the encoder's frames) keeps its
    length."""
    def grow(name, x):
        if isinstance(x, dict):
            return {k: (v if k == "cross" else grow(k, v))
                    for k, v in x.items()}
        if name in SEQ_LEAVES and x.dim() >= 3:
            pad = x.new_zeros(x.shape[:2] + (extra,) + x.shape[3:])
            return torch.cat([x, pad], dim=2)
        return x
    return grow("", cache)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(model, params, tokens, gen: int, kv_dtype: str = "bfloat16", *,
          device=None, enc_frames=None, vision_embeds=None,
          mrope_positions=None) -> ServeResult:
    """Prefill ``tokens`` (B, S), then ``gen`` greedy decode steps. Runs
    on the card unless ``device`` says otherwise; ``params`` must lie on
    that device. The audio family needs ``enc_frames`` (B, n_frames, d).
    The vlm family takes ``vision_embeds`` (B, P, d) for the prompt's
    prefix and ``mrope_positions`` (3, B, S) (default: the reference's,
    every stream counting tokens); decode step i sits at position S + i
    on all three streams, as in the reference."""
    cfg = model.cfg
    pdev = params_device(params, device)
    tokens = torch.as_tensor(tokens).to(device=pdev, dtype=torch.int64)
    b, s = tokens.shape
    batch = {"tokens": tokens}
    if cfg.family == "audio":
        if enc_frames is None:
            raise ValueError(f"{cfg.name}: the audio family serves with "
                             f"enc_frames (B, n_frames, d_model)")
        batch["enc_frames"] = torch.as_tensor(enc_frames).to(pdev)
    if cfg.family == "vlm":
        if mrope_positions is None:
            mrope_positions = torch.arange(s, device=pdev)[None, None] \
                .expand(3, b, s)
        batch["mrope_positions"] = torch.as_tensor(mrope_positions).to(pdev)
        if vision_embeds is not None:
            batch["vision_embeds"] = torch.as_tensor(vision_embeds).to(pdev)
    _sync(pdev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, kv_dtype=kv_dtype)
    cache = grow_cache(cache, gen)
    tok = torch.argmax(logits, -1)[:, None]
    _sync(pdev)
    prefill_s = time.perf_counter() - t0
    out, seen = [tok], [logits]
    t0 = time.perf_counter()
    for i in range(gen):
        step = {"tokens": tok}
        if cfg.family == "vlm":
            step["mrope_positions"] = torch.full((3, b, 1), s + i,
                                                 dtype=torch.int64,
                                                 device=pdev)
        logits, cache = model.decode(params, cache, step)
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
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (b, s))
    frames = None
    if cfg.family == "audio":
        frames = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32) * 0.1)
    res = serve(model, params, tokens, args.gen, args.kv_dtype, device=dev,
                enc_frames=frames)
    rate = (f"{args.gen * b / res.decode_s:.1f} tok/s" if res.decode_s > 0
            else "no decode steps")
    print(f"prefill {b}x{s} in {res.prefill_s * 1e3:.3f} ms | decoded "
          f"{args.gen} toks x batch {b} in {res.decode_s:.3f}s ({rate}) | "
          f"sample: {res.tokens[0, :8].tolist()}")
    return res


if __name__ == "__main__":
    main()
