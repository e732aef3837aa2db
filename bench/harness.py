"""One run of one cell: its loop, its metric readers, the import guard,
and the result line.

The loop (``bench/loops/<traffic's loop>.py``) makes the inputs, sets up
the program, measures the window, checks the answers against the plain
reference, and returns a ``Run``. The readers (``bench/metrics/<name>.py``)
turn the ``Run`` into metrics: the cell's end-to-end metrics with
``trace=0``, its per-layer metrics with ``trace=1``. A reader that finds
nothing to read returns None and its metric is left out.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field

from bench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What one run measured: the loop fills it, the readers read it."""
    setup_s: float = 0.0
    window_s: float = 0.0
    queries: list = field(default_factory=list)   # the window's, in order
    trace: object = None                          # bench.trace.Trace
    memory_peak_bytes: int = 0
    device_kind: str = ""
    device_count: int = 1
    card: str = ""                                # name and power limit
    attempted: int = 0
    failed: int = 0
    checks: dict = field(default_factory=dict)    # name -> (value, limit)
    data: dict = field(default_factory=dict)      # the loop's own
    notes: list = field(default_factory=list)     # lines for stderr


def forbidden_modules(names=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``repro_torch`` is neither)."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def correct(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())


def metrics(run: Run, entries: list) -> dict:
    out = {}
    for m in entries:
        v = spec.module("metrics", m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def execute(cell: dict, *, seed: int, seconds: float, trace: bool,
            device, t_start: float, system=None) -> tuple:
    """(exit code, result dict or None, lines for standard error).
    ``system``: what the loop measures in the program's place (the
    control's reference); None, the program."""
    loop = spec.module("loops", cell["traffic"]["loop"])
    extra = {} if system is None else {"system": system}
    run = loop.run(cell, seed=seed, seconds=seconds, trace=trace,
                   device=device, t_start=t_start, **extra)
    found = forbidden_modules()
    if found:
        return 3, None, [f"the process loaded {found}: the benchmark "
                         f"measures the port alone"]
    result = {
        "correct": correct(run.checks),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics(run, cell["per_layer"] if trace
                           else cell["metrics"]),
        "device": {"platform": "gpu" if str(device).startswith("cuda")
                   else "cpu", "kind": run.device_kind,
                   "count": run.device_count,
                   "memory_peak_bytes": run.memory_peak_bytes},
    }
    if trace and run.trace is not None and run.trace.kernels:
        tr = run.trace
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        ops = sorted(tr.time_by_name().items(), key=lambda kv: -kv[1][1])
        result["breakdown"] = {
            "device_ops": [[n, v[1]] for n, v in ops[:10]],
            "idle_gaps": tr.gaps_by_host(10)}
    result["card"] = run.card
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in run.checks.items()}
    lines = run.notes + [f"check {k}: {v} (limit {lim})"
                         for k, (v, lim) in run.checks.items()]
    return 0, result, lines
