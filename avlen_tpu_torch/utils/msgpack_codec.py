"""Data-only msgpack, as ``flax.serialization.msgpack_serialize`` writes it.

The port's checkpoints are the JAX package's files (avlen_tpu/utils/
checkpoint.py), and the machines the port runs on need not have the
``msgpack`` package, so the format is kept here in full:

* nil, bool, int (the smallest encoding), float64, str, bin, array (list or
  tuple), map (str keys, written in sorted order: flax copies the tree with
  ``jax.tree_util.tree_map`` first, which sorts every dict) and ext;
* a numpy array is ExtType 1 over ``packb((shape, dtype.name, bytes))``, a
  numpy scalar ExtType 3 over the same.

Flax splits an array of more than 2**30 bytes into chunks; no leaf of this
system comes near that, so such an array is refused rather than written in
another layout. ``packb`` returns the bytes, ``pack_into`` appends the
pieces to a list (an array's buffer is one of them, uncopied), and
``unpackb`` reads them back, arrays as read-only numpy views of the
buffer, as flax gives them. Nothing is ever executed on load.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE


def _uint_header(n: int, small: int, fix_limit: int, codes) -> bytes:
    """Header of a str/bin/array/map of length n: fix form below fix_limit
    (small | n), then 8/16/32-bit lengths by ``codes`` (None = no 8-bit)."""
    if n < fix_limit:
        return bytes([small | n])
    c8, c16, c32 = codes
    if c8 is not None and n <= 0xFF:
        return bytes([c8, n])
    if n <= 0xFFFF:
        return struct.pack(">BH", c16, n)
    return struct.pack(">BI", c32, n)


def _int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n > 0:
        for code, fmt, top in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                               (0xCE, ">BI", 0xFFFFFFFF), (0xCF, ">BQ", 2**64 - 1)):
            if n <= top:
                return struct.pack(fmt, code, n)
    else:
        for code, fmt, low in ((0xD0, ">Bb", -2**7), (0xD1, ">Bh", -2**15),
                               (0xD2, ">Bi", -2**31), (0xD3, ">Bq", -2**63)):
            if n >= low:
                return struct.pack(fmt, code, n)
    raise OverflowError(f"integer {n} does not fit msgpack")


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    if n <= 0xFF:
        return struct.pack(">BBb", 0xC7, n, code)
    if n <= 0xFFFF:
        return struct.pack(">BHb", 0xC8, n, code)
    return struct.pack(">BIb", 0xC9, n, code)


def _ndarray_pieces(arr: np.ndarray) -> List[Any]:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialised")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"an array of {arr.nbytes} bytes: flax would write it in chunks")
    shape = tuple(int(s) for s in arr.shape)  # ascontiguousarray makes 0-d arrays 1-d
    arr = np.ascontiguousarray(arr)
    body: List[Any] = [bytes([0x93])]
    pack_into(shape, body)
    pack_into(arr.dtype.name, body)
    body.append(_uint_header(arr.nbytes, 0, 0, (0xC4, 0xC5, 0xC6)))
    body.append(memoryview(arr.reshape(-1).view(np.uint8)))
    return body


def pack_into(obj: Any, out: List[Any]) -> None:
    """Append the msgpack encoding of ``obj`` to ``out`` as pieces."""
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        out.append(_uint_header(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB)))
        out.append(data)
    elif type(obj) in (bytes, bytearray, memoryview):
        data = memoryview(obj).cast("B")
        out.append(_uint_header(len(data), 0, 0, (0xC4, 0xC5, 0xC6)))
        out.append(data)
    elif type(obj) in (list, tuple):
        out.append(_uint_header(len(obj), 0x90, 16, (None, 0xDC, 0xDD)))
        for v in obj:
            pack_into(v, out)
    elif type(obj) is dict:
        out.append(_uint_header(len(obj), 0x80, 16, (None, 0xDE, 0xDF)))
        for k in sorted(obj):
            pack_into(k, out)
            pack_into(obj[k], out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        body = _ndarray_pieces(np.asarray(obj))
        code = EXT_NDARRAY if isinstance(obj, np.ndarray) else EXT_NPSCALAR
        out.append(_ext_header(code, sum(len(p) for p in body)))
        out.extend(body)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} (data-only msgpack)")


def packb(obj: Any) -> bytes:
    out: List[Any] = []
    pack_into(obj, out)
    return b"".join(out)


# ---------------------------------------------------------------------------
class _Reader:
    """``bin_view``: bin objects as memoryviews of the data, not copies."""

    def __init__(self, data, bin_view: bool = False):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.bin_view = bin_view

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in sized:
            data = self.take(self.unpack(sized[b]))
            if b >= 0xD9:
                return str(data, "utf-8")
            return data if self.bin_view else bytes(data)
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in nums:
            return self.unpack(nums[b])
        if b in (0xDC, 0xDD):
            return self._array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            n = fixext[b]
        elif b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        else:
            raise ValueError(f"unknown msgpack type byte 0x{b:02x}")
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ndarray(data) -> np.ndarray:
    shape, name, buf = _Reader(data, bin_view=True).read()
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, data) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


def unpackb(data) -> Any:
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError("extra bytes after the msgpack object")
    return out
