"""Closed loop of cold scans: one analyst's queries one after another,
each a multi-predicate scan of one camera's recording on an empty
virtual-column store.

Set-up (``setup_s``, from process start): the system's kernels built or
loaded, the corpus drawn on the device, the cascades' weights and
thresholds calibrated on the reference, the engine built, one warm query.
Window: queries for ``seconds``, and at least one round of every camera,
each ``execute(cascades, metadata_eq={"cam": c})`` timed by the host
clock around it to a synchronised end. With ``trace``, ``trace_queries``
more queries under the profiler. Then the peak memory is read, the
system's state freed, and every answer of the window and of the traced
stretch compared row by row with the plain reference's answer for its
camera (``wrong_rows``).

The system under test is ``bench/program.py`` (``repro_torch``); the
control (``bench/control.py``) hands in the reference computed in TF32
in its place and runs this same loop and comparison.
"""
from __future__ import annotations

import gc
import resource
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from bench import inputs, program
from bench import trace as tracing
from bench.harness import Run
from bench.reference import scan_ref


@dataclass
class Query:
    cam: int
    ms: float
    ids: np.ndarray | None       # None: the query raised or returned none
    rows_scanned: int
    rows_evaluated: int
    error: str = ""


def card_name(device) -> tuple:
    """(device kind, "kind, power limit") of the card, or the CPU's."""
    if not str(device).startswith("cuda"):
        return "cpu", "cpu"
    kind = torch.cuda.get_device_name(torch.device(device))
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        smi = []
    return kind, (smi[0] if smi else f"{kind}, power limit not read")


def sync(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize(device)


def query(eng, compiled, cam: int, device) -> Query:
    eng.reset_cache()
    t0 = time.perf_counter()
    try:
        res = eng.execute(compiled, metadata_eq={"cam": cam})
        sync(device)
    except Exception as e:  # noqa: BLE001 - an answer that never comes
        return Query(cam, (time.perf_counter() - t0) * 1e3, None, 0, 0,
                     f"{type(e).__name__}: {e}")
    ms = (time.perf_counter() - t0) * 1e3
    if res is None or res.indices is None:
        return Query(cam, ms, None, 0, 0, "no answer")
    return Query(cam, ms, np.asarray(res.indices, np.int64),
                 int(res.stats.rows_scanned), int(res.stats.rows_evaluated))


def wrong_rows(answered: list, want: dict) -> set:
    """Distinct row ids on which any answer differs from the reference's
    answer for its camera; a query without an answer adds none (it is
    counted as failed)."""
    wrong = set()
    for q in answered:
        if q.ids is not None:
            wrong.update(int(r) for r in np.setxor1d(q.ids, want[q.cam]))
    return wrong


class HostClock:
    """What the host did over a stretch, for the notes: the process's CPU
    seconds, involuntary context switches, garbage collections and their
    seconds, and the core the main thread ended on."""

    def __init__(self):
        self.gc_s, self.gc_n, self._t = 0.0, 0, None
        gc.callbacks.append(self._on_gc)
        self.ru = resource.getrusage(resource.RUSAGE_SELF)
        self.cpu = time.process_time()

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1

    def close(self) -> str:
        gc.callbacks.remove(self._on_gc)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        try:
            core = Path("/proc/self/stat").read_text().rsplit(")", 1)[1] \
                .split()[36]
        except (OSError, IndexError):
            core = "?"
        return (f"cpu {time.process_time() - self.cpu:.3f} s, involuntary "
                f"switches {ru.ru_nivcsw - self.ru.ru_nivcsw}, voluntary "
                f"{ru.ru_nvcsw - self.ru.ru_nvcsw}, gc {self.gc_n} in "
                f"{self.gc_s:.4f} s, core {core}")


def run(cell: dict, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, system=program) -> Run:
    cfg, traffic = cell["config"], cell["traffic"]
    out = Run()
    out.device_kind, out.card = card_name(device)
    system.prepare(device)
    with torch.no_grad():
        corpus = inputs.draw_corpus(cfg, seed, device)
        meta = inputs.metadata(cfg)
        cascades = inputs.make_cascades(cfg, corpus, seed)
    compiled = system.compile_cascades(cascades)
    eng = system.engine(corpus, meta, int(cfg["chunk"]), device)
    cams = inputs.rounds(cfg, seed)
    query(eng, compiled, next(cams), device)               # warm
    t0 = time.perf_counter()
    out.setup_s = time.time() - t_start

    host = HostClock()
    deadline = t0 + seconds
    while True:
        out.queries.append(query(eng, compiled, next(cams), device))
        if time.perf_counter() >= deadline \
                and len(out.queries) >= int(cfg["recordings"]):
            break
    out.window_s = time.perf_counter() - t0
    host = host.close()

    traced = []
    if trace:
        with tracing.profiler() as prof:
            for _ in range(int(traffic["trace_queries"])):
                with tracing.span():
                    traced.append(query(eng, compiled, next(cams), device))
        out.trace = tracing.read(prof)
        out.trace.rows_scanned = sum(q.rows_scanned for q in traced)

    if str(device).startswith("cuda"):
        out.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    del eng, compiled
    gc.collect()              # the engine's scan closures form a cycle
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()

    answered = out.queries + traced
    want, reach, margin = {}, {}, {}
    with torch.no_grad():
        for cam in sorted({q.cam for q in answered}):
            rows = np.flatnonzero(meta["cam"] == cam)
            want[cam], reach[cam], m = scan_ref.scan_answer(
                corpus, rows, cascades, "f32", int(cfg["reference_block"]))
            margin.update(m)
    wrong = wrong_rows(answered, want)
    failed = [q for q in answered if q.ids is None]
    out.attempted, out.failed = len(answered), len(failed)
    tol = float(cfg["boundary_tolerance"])
    out.checks = {"wrong_rows": (len(wrong), int(cfg["limits"]["wrong_rows"])),
                  "failed_queries": (len(failed), 0)}
    out.data = {"config": cfg, "reach": reach}
    ms = [q.ms for q in out.queries]
    out.notes = [
        f"card: {out.card}",
        f"window: {len(out.queries)} queries in {out.window_s} s (ms: "
        f"first {ms[0]}, median {float(np.median(ms))}, last {ms[-1]}; "
        f"median by quarter of the window "
        f"{[float(np.median(x)) for x in np.array_split(ms, 4) if len(x)]}"
        f"); traced: {len(traced)} queries",
        f"host over the window: {host}",
        f"boundary rows (a deciding reference score within {tol} of its "
        f"threshold): {sum(v <= tol for v in margin.values())}",
        f"wrong rows (row: reference score's distance from its nearest "
        f"threshold): {[(r, margin.get(r)) for r in sorted(wrong)[:20]]}"]
    if failed:
        out.notes.append(f"failed queries (camera: error): "
                         f"{[(q.cam, q.error) for q in failed[:5]]}")
    return out
