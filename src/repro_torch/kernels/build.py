"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds). All
sources are compiled in parallel, at first use, into
``<repo>/build/kernels/<hash of the sources>/`` — a directory git ignores.
A changed source gets a new hash and therefore a fresh build. Nothing
here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, from the repo's sources")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source that has no library yet (one nvcc process per
    source, all started together), then load them all. Returns
    {source stem: CDLL}. Raises with nvcc's output on a failed build."""
    if _LIBS:
        return _LIBS
    out_dir = BUILD_ROOT / source_hash()
    todo = [src for src in sources()
            if not (out_dir / f"lib{src.stem}.so").exists()]
    t0 = time.perf_counter()
    procs = {}
    if todo:
        nvcc = _nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
    for src in todo:
        lib = out_dir / f"lib{src.stem}.so"
        tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib)
    logs = {}
    for stem, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[stem] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {stem}.cu:\n{out}")
        os.replace(tmp, lib)
        (out_dir / f"{stem}.log").write_text(out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, dir=str(out_dir),
                      built=sorted(procs), logs=logs)
    for src in sources():
        _LIBS[src.stem] = ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
    return _LIBS


def library(stem: str) -> ctypes.CDLL:
    return build_all()[stem]
