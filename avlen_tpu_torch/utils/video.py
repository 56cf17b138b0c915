"""Episode videos, with binaural audio where ffmpeg can mux it.

PyTorch counterpart of ``avlen_tpu/utils/video.py`` (generate_video /
images_to_video_with_audio, ss_baselines/common/utils.py:187-238,
289-340): writes an episode's frames to disk and/or tensorboard under the
name ``episode=<id>-ckpt=<i>-<metric>=<v>...``.

``.mp4`` goes through imageio and its ffmpeg plugin where both are
installed, as in the JAX package. Everywhere else (the JAX package writes
a ``.gif`` through imageio there, or cannot write at all without imageio)
the frames go to ``.gif`` through ``gif_bytes``: a lossless GIF89a encoder
in numpy and Python. It builds one global palette from the frames' colours
and LZW-codes each frame's palette indices, so the file decodes to the
frames exactly; it raises on more than 256 colours rather than quantise (a
top-down map has at most 10: 5 colours and their fogged copies). The
tensorboard video event carries the same GIF bytes (``utils/tb.py``).
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import wave
from typing import List, Optional, Sequence

import numpy as np

from avlen_tpu_torch.utils.logging import logger

_MAX_CODE = 4096  # GIF's LZW codes are at most 12 bits wide


def write_wav(path: str, audio: np.ndarray, sampling_rate: int) -> None:
    """audio (T, 2) float in [-1, 1] → 16-bit stereo wav."""
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(pcm.shape[1] if pcm.ndim == 2 else 1)
        f.setsampwidth(2)
        f.setframerate(sampling_rate)
        f.writeframes(pcm.tobytes())


def _palette(images: Sequence[np.ndarray]):
    """(palette (2^m, 3) uint8, per-frame index arrays, m): one global
    palette of every colour in the frames, m ≥ 2 bits."""
    frames = np.stack([np.asarray(img, np.uint8) for img in images])
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (H, W, 3) uint8, got {frames.shape[1:]}")
    rgb = (frames[..., 0].astype(np.int32) << 16) | (frames[..., 1].astype(np.int32) << 8) | frames[..., 2]
    colours, index = np.unique(rgb.reshape(-1), return_inverse=True)
    if len(colours) > 256:
        raise ValueError(f"{len(colours)} colours: a GIF palette holds at most 256")
    m = max(2, int(np.ceil(np.log2(max(len(colours), 2)))))
    palette = np.zeros((1 << m, 3), np.uint8)
    palette[: len(colours), 0] = colours >> 16
    palette[: len(colours), 1] = (colours >> 8) & 0xFF
    palette[: len(colours), 2] = colours & 0xFF
    return palette, index.reshape(frames.shape[:3]).astype(np.uint8), m


def _lzw(pixels: bytes, m: int) -> bytes:
    """GIF's variable-width LZW code stream of palette indices (m-bit
    roots), codes packed LSB first. A code is as wide as the newest table
    entry the decoder holds; a full table (4096 codes) is cleared."""
    clear, eoi = 1 << m, (1 << m) + 1
    codes, widths = [clear], [m + 1]
    width, next_code, table = m + 1, eoi + 1, {}
    prefix = pixels[0]
    for px in pixels[1:]:
        key = prefix << 8 | px
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(width)
        table[key] = next_code
        if next_code == 1 << width and width < 12:
            width += 1
        next_code += 1
        if next_code == _MAX_CODE:
            codes.append(clear)
            widths.append(width)
            width, next_code, table = m + 1, eoi + 1, {}
        prefix = px
    codes.append(prefix)
    widths.append(width)
    # the decoder adds an entry for that last code; EOI is read at its width
    if next_code == 1 << width and width < 12:
        width += 1
    codes.append(eoi)
    widths.append(width)
    w = np.asarray(widths, np.int64)
    c = np.asarray(codes, np.int64)
    offsets = np.concatenate([[0], np.cumsum(w)[:-1]])
    bits = np.zeros(int(w.sum()), np.uint8)
    for j in range(12):
        sel = w > j
        bits[offsets[sel] + j] = (c[sel] >> j) & 1
    return np.packbits(bits, bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out += bytes([len(chunk)]) + chunk
    return bytes(out + b"\x00")


def gif_bytes(images: Sequence[np.ndarray], fps: int = 10) -> bytes:
    """A looping GIF89a of (H, W, 3) uint8 frames that decodes to them
    exactly; ValueError on more than 256 colours."""
    palette, index, m = _palette(images)
    _, h, w = index.shape
    delay = max(int(round(100.0 / fps)), 1)  # centiseconds
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", w, h, 0xF0 | (m - 1), 0, 0)
    out += palette.tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"
    for frame in index:
        out += b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0)
        out += bytes([m]) + _sub_blocks(_lzw(frame.tobytes(), m))
    return bytes(out + b"\x3b")


def images_to_video(path: str, images: List[np.ndarray], fps: int = 10) -> str:
    """Write the frames to ``path`` (.mp4) through imageio where it has an
    mp4 backend; otherwise to the same name with ``.gif`` through
    ``gif_bytes``. Returns the path written, and logs which writer ran."""
    if path.endswith(".mp4"):
        try:
            import imageio

            with imageio.get_writer(path, fps=fps) as w:
                for img in images:
                    w.append_data(np.asarray(img, np.uint8))
            logger.info(f"wrote {path} (imageio)")
            return path
        except (ValueError, ImportError):
            pass  # no imageio, or imageio without an mp4 backend
    alt = os.path.splitext(path)[0] + ".gif"
    with open(alt, "wb") as f:
        f.write(gif_bytes(images, fps))
    logger.info(f"no mp4 backend; wrote {alt} (GIF writer)")
    return alt


def images_to_video_with_audio(
    path: str,
    images: List[np.ndarray],
    audio: Optional[np.ndarray],
    sampling_rate: int = 16000,
    fps: int = 10,
) -> str:
    """Mux frames + audio when ffmpeg exists; otherwise silent video + wav.
    Returns the video's path."""
    path = images_to_video(path, images, fps)
    if audio is None:
        return path
    wav_path = os.path.splitext(path)[0] + ".wav"
    write_wav(wav_path, audio, sampling_rate)
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg or not path.endswith(".mp4"):
        logger.info(f"ffmpeg not available; wrote {path} + {wav_path} separately")
        return path
    muxed = os.path.splitext(path)[0] + "_av.mp4"
    try:
        subprocess.run(
            [ffmpeg, "-y", "-loglevel", "error", "-i", path, "-i", wav_path,
             "-c:v", "copy", "-c:a", "aac", "-shortest", muxed],
            check=True,
        )
        os.replace(muxed, path)
        os.remove(wav_path)
    except subprocess.CalledProcessError as e:
        logger.warning(f"audio mux failed: {e}")
    return path


def generate_video(
    video_option: List[str],
    video_dir: Optional[str],
    images: List[np.ndarray],
    episode_id: str,
    checkpoint_idx: int,
    metrics: dict,
    tb_writer=None,
    audios: Optional[np.ndarray] = None,
    sampling_rate: int = 16000,
    fps: int = 10,
) -> None:
    """generate_video semantics (common/utils.py:187-238): the name encodes
    the episode and its metrics; written to disk and/or tensorboard as
    ``video_option`` says."""
    if not images:
        return
    metric_str = "-".join(f"{k}={v:.2f}" for k, v in metrics.items())
    name = f"episode={episode_id}-ckpt={checkpoint_idx}-{metric_str}"
    if "disk" in video_option and video_dir:
        os.makedirs(video_dir, exist_ok=True)
        images_to_video_with_audio(
            os.path.join(video_dir, name + ".mp4"), images, audios, sampling_rate, fps
        )
    if "tensorboard" in video_option and tb_writer is not None:
        tb_writer.add_video_from_np_images(f"episode{episode_id}", checkpoint_idx, images, fps=fps)
