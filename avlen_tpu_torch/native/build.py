"""Build the port's native host libraries with g++ and load them with ctypes.

PyTorch-port counterpart of the JAX package's ``native/build.py``: the frame
server and the graph engine have a flat C ABI, so a plain ``g++ -O2 -shared -fPIC
-std=c++17`` of the port's own sources (``native/*.cpp``) and ctypes
suffice. Libraries go to ``build/native/`` at the repo root; as in
``utils/cuda_build.py`` each file name carries a hash of its source and
flags (an edited source is rebuilt, a stale library never loaded), and a
library is compiled to a per-process temporary file and renamed into place,
so that processes building at once never load a half-written one. A failed
compile raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
SOURCES = {
    "graph_engine": "graph_engine.cpp",
    "frame_server": "frame_server.cpp",
}
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LOADED: Dict[str, ctypes.CDLL] = {}


def native_lib_path(name: str) -> str:
    digest = hashlib.sha256((SRC_DIR / SOURCES[name]).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return str(BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_native(name: Optional[str] = None, force: bool = False) -> Dict[str, float]:
    """Compile ``name`` (default: every library) unless already built.
    Returns the seconds of each compile that ran."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {}
    for t in [name] if name else list(SOURCES):
        out = native_lib_path(t)
        if not force and os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", *CXX_FLAGS, str(SRC_DIR / SOURCES[t]), "-o", tmp]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {t} ({' '.join(cmd)}):\n{proc.stdout}")
        os.replace(tmp, out)
        seconds[t] = time.perf_counter() - t0
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if missing."""
    lib = _LOADED.get(name)
    if lib is None:
        build_native(name)
        lib = ctypes.CDLL(native_lib_path(name))
        _LOADED[name] = lib
    return lib
