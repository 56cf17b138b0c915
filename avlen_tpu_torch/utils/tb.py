"""TensorBoard event files, written and read without a third-party package.

PyTorch counterpart of ``avlen_tpu/utils/tb.py`` (parity:
ss_baselines/common/tensorboard_utils.py:18-72): ``TensorboardWriter`` with
``add_scalar``/``add_scalars`` and a no-op writer when there is no log_dir.
The JAX package writes through tensorboardX; here the file is written
directly, as TensorBoard reads it:

* TFRecord framing: the payload's length as a little-endian u64, the masked
  CRC-32C of those 8 bytes, the payload, the masked CRC-32C of the payload
  (CRC-32C by a 256-entry Castagnoli table);
* a first record ``Event{wall_time, file_version: "brain.Event:2"}``;
* then one ``Event{wall_time=1, step=2, summary=5{value=1{tag=1,
  simple_value=2}}}`` per scalar, protobuf-encoded by hand (proto3: a zero
  step is left out);
* and one ``Event{..., summary=5{value=1{tag=1, image=4{height=1, width=2,
  colorspace=3, encoded_image_string=4}}}}`` per video, the animated GIF
  of ``utils/video.gif_bytes`` in the image, as tensorboardX writes a
  video (its summary.proto). tensorboardX needs moviepy to encode one; the
  port needs no third-party package.

Every record is flushed as it is written. ``read_scalars`` reads the
scalars of every event file under a directory back (``run.py
--eval-best``).
"""

from __future__ import annotations

import glob
import os
import socket
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 fields: negatives as ten-byte two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(number: int, data: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(data)) + data


def encode_event(wall_time: float, step: int = 0, file_version: Optional[str] = None,
                 tag: Optional[str] = None, value: float = 0.0) -> bytes:
    """An ``Event`` proto: wall_time (1, double), step (2, int64),
    file_version (3, string) or summary (5) of one simple_value."""
    out = struct.pack("<Bd", 1 << 3 | 1, wall_time)
    if step:
        out += _varint(2 << 3) + _varint(step)
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    if tag is not None:
        val = _field_bytes(1, tag.encode()) + struct.pack("<Bf", 2 << 3 | 5, value)
        out += _field_bytes(5, _field_bytes(1, val))
    return out


def encode_image_event(wall_time: float, step: int, tag: str, height: int, width: int,
                       channels: int, encoded: bytes) -> bytes:
    """An ``Event`` whose summary holds one encoded image (a video's GIF)."""
    out = struct.pack("<Bd", 1 << 3 | 1, wall_time)
    if step:
        out += _varint(2 << 3) + _varint(step)
    image = b"".join(_varint(n << 3) + _varint(v) for n, v in ((1, height), (2, width), (3, channels)))
    image += _field_bytes(4, encoded)
    val = _field_bytes(1, tag.encode()) + _field_bytes(4, image)
    return out + _field_bytes(5, _field_bytes(1, val))


def frame_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


class EventFileWriter:
    """One ``events.out.tfevents.<time>.<host>`` file in ``log_dir``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._write(encode_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        self._f.write(frame_record(payload))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(encode_event(time.time(), int(step), tag=tag, value=float(value)))

    def add_image(self, tag: str, step: int, height: int, width: int, channels: int,
                  encoded: bytes) -> None:
        self._write(encode_image_event(time.time(), int(step), tag, height, width, channels, encoded))

    def close(self) -> None:
        self._f.close()


class TensorboardWriter:
    def __init__(self, log_dir: Optional[str], flush_secs: int = 30):
        # records are flushed as written, so flush_secs has nothing to pace
        self.log_dir = log_dir
        self.writer = EventFileWriter(log_dir) if log_dir else None
        self._scalars_writers: Dict[str, EventFileWriter] = {}

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def close(self) -> None:
        if self.writer:
            self.writer.close()
        for w in self._scalars_writers.values():
            w.close()

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self.writer:
            self.writer.add_scalar(tag, float(value), step)

    def add_scalars(self, tag: str, values: dict, step: int) -> None:
        """Each value under ``tag`` in a run of its own,
        ``<log_dir>/<tag with / as _>_<key>``, as tensorboardX lays them out."""
        if not self.writer:
            return
        for k, v in values.items():
            sub = os.path.join(self.log_dir, tag.replace("/", "_") + "_" + k)
            if sub not in self._scalars_writers:
                self._scalars_writers[sub] = EventFileWriter(sub)
            self._scalars_writers[sub].add_scalar(tag, float(v), step)

    def add_video_from_np_images(self, tag: str, step: int, images, fps: int = 10) -> None:
        """(H, W, 3) uint8 frames as one video event (an animated GIF)."""
        if not self.writer:
            return
        from avlen_tpu_torch.utils.video import gif_bytes

        h, w, c = np.asarray(images[0]).shape
        self.writer.add_image(tag, step, h, w, c, gif_bytes(images, fps))


# ---------------------------------------------------------------------------
def read_records(path: str) -> List[bytes]:
    """The payloads of a TFRecord file, each CRC checked; a record still
    being written at the end of the file is left out."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if hcrc != masked_crc32c(header):
            raise ValueError(f"{path}: corrupt record header at byte {pos}")
        if pos + 16 + n > len(data):
            break
        payload = data[pos + 12:pos + 12 + n]
        (pcrc,) = struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])
        if pcrc != masked_crc32c(payload):
            raise ValueError(f"{path}: bad payload CRC at byte {pos}")
        out.append(payload)
        pos += 16 + n
    return out


def _fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message."""
    pos = 0

    def varint():
        nonlocal pos
        shift = result = 0
        while True:
            b = buf[pos]
            pos += 1
            result |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return result

    while pos < len(buf):
        key = varint()
        number, wire = key >> 3, key & 7
        if wire == 0:
            yield number, wire, varint()
        elif wire == 1:
            yield number, wire, buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            n = varint()
            yield number, wire, buf[pos:pos + n]
            pos += n
        elif wire == 5:
            yield number, wire, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")


def decode_event(payload: bytes) -> Tuple[float, int, List[Tuple[str, float]]]:
    """(wall_time, step, [(tag, simple_value), ...]) of an ``Event``."""
    wall_time, step, scalars = 0.0, 0, []
    for number, _, v in _fields(payload):
        if number == 1:
            (wall_time,) = struct.unpack("<d", v)
        elif number == 2:
            step = v - (1 << 64) if v >= 1 << 63 else v
        elif number == 5:
            for vnum, _, value in _fields(v):
                if vnum != 1:
                    continue
                tag, simple = None, None
                for f, _, x in _fields(value):
                    if f == 1:
                        tag = x.decode()
                    elif f == 2:
                        (simple,) = struct.unpack("<f", x)
                if tag is not None and simple is not None:
                    scalars.append((tag, simple))
    return wall_time, step, scalars


def read_scalars(log_dir: str) -> Dict[str, List[Tuple[int, float]]]:
    """{tag: [(step, value), ...]} over the event files directly in
    ``log_dir``, files in name order and events in file order."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    for path in sorted(glob.glob(os.path.join(log_dir, "*tfevents*"))):
        for payload in read_records(path):
            _, step, scalars = decode_event(payload)
            for tag, value in scalars:
                out.setdefault(tag, []).append((step, value))
    return out
