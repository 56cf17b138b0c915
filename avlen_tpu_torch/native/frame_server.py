"""ctypes bindings + bank writer for the mmap frame-cache server
(frame_server.cpp, the port's copy of the JAX package's source)."""

from __future__ import annotations

import ctypes
import struct
from typing import Tuple

import numpy as np

from avlen_tpu_torch.native.build import load_library

MAGIC = 0x41564C46
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def write_frame_bank(path: str, frames: np.ndarray) -> None:
    """frames: (N, A, H, W, C) contiguous array of any fixed-size dtype."""
    assert frames.ndim == 5
    n, a, h, w, c = frames.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<7i", MAGIC, n, a, h, w, c, frames.dtype.itemsize))
        f.write(np.ascontiguousarray(frames).tobytes())


class FrameServer:
    def __init__(self, path: str, dtype=np.uint8):
        lib = load_library("frame_server")
        lib.fs_open.restype = ctypes.c_void_p
        lib.fs_open.argtypes = [ctypes.c_char_p]
        lib.fs_close.argtypes = [ctypes.c_void_p]
        lib.fs_shape.argtypes = [ctypes.c_void_p, _I32P]
        lib.fs_gather.argtypes = [ctypes.c_void_p, ctypes.c_int32, _I32P, _I32P, _U8P]
        self._lib = lib
        self._h = ctypes.c_void_p(lib.fs_open(path.encode()))
        if not self._h:
            raise IOError(f"cannot open frame bank {path}")
        shape = np.zeros((6,), np.int32)
        lib.fs_shape(self._h, shape)
        self.n, self.a, self.h, self.w, self.c, self.itemsize = (int(x) for x in shape)
        self.dtype = np.dtype(dtype)
        assert self.dtype.itemsize == self.itemsize

    def close(self):
        if getattr(self, "_h", None):
            self._lib.fs_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    @property
    def frame_shape(self) -> Tuple[int, int, int]:
        return (self.h, self.w, self.c)

    def gather(self, nodes, rots) -> np.ndarray:
        nodes = np.ascontiguousarray(nodes, np.int32)
        rots = np.ascontiguousarray(rots, np.int32)
        # the server copies without bounds checks (JAX's gather reads past the
        # mapping): refuse what the bank does not hold
        if rots.shape != nodes.shape or (nodes.size and (
                nodes.min() < 0 or nodes.max() >= self.n or rots.min() < 0 or rots.max() >= self.a)):
            raise IndexError(f"frame bank of {self.n} nodes x {self.a} rotations: no frame at "
                             f"nodes {nodes.min(initial=0)}..{nodes.max(initial=0)}, "
                             f"rotations {rots.min(initial=0)}..{rots.max(initial=0)}")
        b = len(nodes)
        out = np.zeros((b, self.h, self.w, self.c), self.dtype)
        self._lib.fs_gather(self._h, b, nodes, rots, out.view(np.uint8).reshape(-1))
        return out
