"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -shared``),
at first use, into ``build/kernels/`` at the repo root. The file name carries
a hash of the sources, so an edited kernel is rebuilt and a stale library is
never loaded. ``build`` starts one nvcc per source, all at once. Both
``build`` and ``load`` first check that the card is of the capability that
code runs on (``utils/platform.require_sm90a``), so any other card fails
with its name before a kernel is compiled or loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from avlen_tpu_torch.utils.platform import require_sm90a

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("smt_encode", "partial_irfft", "spectrogram")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):  # the .cu and the shared headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str] = KERNELS, verbose: bool = False) -> List[Tuple[str, float, str]]:
    """Compile ``names`` in parallel (one nvcc each). Returns (name, seconds,
    compiler output) per kernel; with ``verbose`` the output holds ptxas'
    register and spill report. Raises if any compile fails, or on a card
    other than sm_90."""
    require_sm90a()
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    results, failed = [], []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        results.append((name, secs, log))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if missing."""
    lib = _LOADED.get(name)
    if lib is None:
        require_sm90a()
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib


def current_stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
