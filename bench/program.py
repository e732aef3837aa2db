"""The system under test: ``repro_torch``'s ScanEngine, handed the
benchmark's corpus, metadata, weights and thresholds. The only module of
the benchmark that imports the program; the reference imports none of it.
"""
from __future__ import annotations

from functools import partial


def compile_cascades(cascades: list) -> list:
    """The benchmark's cascades as the program's ``CompiledCascade``s,
    each with its level-0 model in kernel-foldable form (``Stage0``) so a
    card runs the chunk's pyramid and that model in one fused launch."""
    from repro_torch.core.executor import Stage0
    from repro_torch.core.transforms import Representation
    from repro_torch.engine.scan import CompiledCascade
    from repro_torch.models.cnn import cnn_predict_proba
    out = []
    for i, c in enumerate(cascades):
        reps = [Representation(l["res"], l["color"]) for l in c["levels"]]
        params = [l["params"] for l in c["levels"]]
        out.append(CompiledCascade(
            c["name"], ("bench", i), reps,
            [partial(cnn_predict_proba, p) for p in params],
            list(c["thresholds"]), stage0=Stage0(params[0], reps[0])))
    return out


def engine(corpus, meta: dict, chunk: int, device):
    from repro_torch.engine.scan import ScanEngine
    return ScanEngine(corpus, metadata=meta, chunk=chunk, device=device)


def prepare(device) -> None:
    """Resolve the device as the program does (TF32 off, cuDNN autotuning
    off) and, on a card, build and load its CUDA kernels."""
    from repro_torch.device import resolve_device
    resolve_device(device)
    if str(device).startswith("cuda"):
        from repro_torch.kernels import build
        build.build_all()
