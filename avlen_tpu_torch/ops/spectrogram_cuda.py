"""Log-mean-pooled magnitude spectrogram of binaural audio.

``spectrogram(audio, config)``: (B, 2, T) f32 → (B, F', T', 2) f32, equal to
``spectrogram_from_audiogoal`` of the JAX package: reflect pad, frames of
n_fft at hop, centred periodic Hann window, |DFT|, block mean pool with the
zero padding counted, log1p, channels last.

Replaces the TPU kernel ``avlen_tpu/ops/pallas_spectrogram.py:spectrogram_pallas``
(body ``_kernel``). On a CUDA tensor it launches the hand-written kernel
``csrc/spectrogram.cu``; on a CPU tensor it runs the plain version.

Bound on an H100: at (16, 2, 16000) bytes, ~2.3 MB (~0.7 µs at 3.35 TB/s),
far under one block's chain of dependent steps plus the launch (~2 µs); a
radix-2 design of the same function spent 95 % of its 40.5 µs there inside
its blocks, not in the launch. At the spectrogram bank's 256 rows, bytes
(~36 MB, ~11 µs) and f32 operations (~9 µs) within 20 % of each other.
One launch: each block takes one env and one pooled time column, frames its
span of both ears once into shared memory, packs the two ears of a frame
into one complex FFT (left real, right imaginary), runs it as radix-8
Stockham stages in registers with two swizzled exchange buffers, and pools
the unpacked magnitudes of both ears on every thread. ``spectrogram_plan``
holds the index math; the C entry computes the same launch, and the wrapper
checks that the two agree.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from avlen_tpu_torch.ops.audio import (
    SpectrogramConfig,
    block_reduce_mean,
    device_window,
    stft_magnitude,
)
from avlen_tpu_torch.utils import cuda_build

VALUES = 8  # complex values each thread holds through every radix stage
MAX_THREADS = 1024
MAX_SMEM = 232448  # bytes of shared memory one H100 block may use
# XOR applied to bits 0-3 of a frame index i by bits 4-6 (SWIZZLE[(i >> 4) & 7]):
# no radix stage's loads or stores conflict on banks for n_fft 128..1024
SWIZZLE = (0, 3, 5, 6, 9, 10, 12, 15)

_TWIDDLES: Dict[Tuple[str, int], torch.Tensor] = {}
_CHECKED: Dict[Tuple[int, int, int], bool] = {}


@dataclass(frozen=True)
class SpectrogramPlan:
    """One launch of ``csrc/spectrogram.cu`` for ``batch`` envs of ``t`` samples.

    Block (x, y) takes env y and pooled time column x: frames x*bt .. x*bt+bt-1
    (those < n_frames), whose samples are the ``span`` consecutive samples of
    each ear from padded index x*bt*hop. Thread ``tid`` works on frame
    ``tid // (n_fft/8)``; frames past ``bt`` are idle threads that round the
    block up to whole warps. The stages' ``radices`` run in order on the
    two-ear frame; stage s reads buffer (s-1) % 2 (stage 0 the span, which
    buffer 1 holds) and writes buffer s % 2; a buffer holds frame f at f*n_fft
    through ``swizzle``, the last stage's at f*(n_fft + 1) in natural order.
    Pooled value j of each ear is the sum over a ``group`` of lanes (lane l
    takes frames l, l + group, ...) of each lane's bf bins.
    """

    batch: int
    t: int
    n_fft: int
    hop: int
    pad: int
    n_frames: int
    bf: int
    bt: int
    fprime: int
    tprime: int
    radices: Tuple[int, ...]
    threads: int
    span: int
    buffer_slots: int
    smem_bytes: int
    group: int
    grid: Tuple[int, int, int]
    twiddles: np.ndarray = field(compare=False, repr=False)  # e^{+2 pi i m/n_fft}, complex64

    def span_indices(self, col: int) -> np.ndarray:
        """Index into the unpadded signal of each span sample of block column
        ``col``, reflected at both edges (the edge sample not repeated); -1
        where the padded signal has ended (the kernel stores 0 there)."""
        q = col * self.bt * self.hop + np.arange(self.span)
        p = q - self.pad
        p = np.where(p < 0, -p, p)
        p = np.where(p >= self.t, 2 * (self.t - 1) - p, p)
        return np.where(q < self.t + 2 * self.pad, p, -1)


def swizzle(i):
    """Slot of element i of a frame in an exchange buffer (array or int)."""
    return i ^ np.asarray(SWIZZLE)[(np.asarray(i) >> 4) & 7]


def radices(n_fft: int) -> Tuple[int, ...]:
    """Radix stages of an n_fft-point transform: radix 8 throughout, after a
    radix-2 or radix-4 stage for what 8 leaves of log2 n_fft."""
    log_n = n_fft.bit_length() - 1
    rest = log_n % 3
    return ((1 << rest),) * (rest > 0) + (8,) * (log_n // 3)


@functools.lru_cache(maxsize=64)
def spectrogram_plan(batch: int, t: int, config: SpectrogramConfig = SpectrogramConfig()) -> SpectrogramPlan:
    n_fft, hop = config.n_fft, config.hop_length
    if config.pad_mode != "reflect":
        raise ValueError(f"spectrogram: pad_mode {config.pad_mode!r} unsupported (reflect only)")
    if n_fft & (n_fft - 1) or not 64 <= n_fft <= 1024 or config.win_length > n_fft:
        raise ValueError(f"spectrogram: n_fft {n_fft} must be a power of two in [64, 1024]")
    if t <= n_fft // 2:
        raise ValueError(f"spectrogram: signal of {t} samples too short to reflect-pad by {n_fft // 2}")
    bf, bt = config.block
    threads = -(-bt * n_fft // VALUES // 32) * 32
    span = (bt - 1) * hop + n_fft
    buffer_slots = max(bt * (n_fft + 1), span)
    smem = 2 * buffer_slots * 8
    if threads > MAX_THREADS or smem > MAX_SMEM:
        raise ValueError(f"spectrogram: {bt} frames of {n_fft} exceed one block's threads or shared memory")
    n_frames = 1 + t // hop
    tprime = -(-n_frames // bt)
    group = min(32, max(2, 1 << (bt - 1).bit_length()))  # lanes 0 and 1 take one ear each
    m = np.arange(n_fft)
    return SpectrogramPlan(
        batch=batch, t=t, n_fft=n_fft, hop=hop, pad=n_fft // 2, n_frames=n_frames, bf=bf, bt=bt,
        fprime=-(-(n_fft // 2 + 1) // bf), tprime=tprime, radices=radices(n_fft), threads=threads,
        span=span, buffer_slots=buffer_slots, smem_bytes=smem, group=group, grid=(tprime, batch, 1),
        twiddles=np.exp(2j * np.pi * m / n_fft).astype(np.complex64),
    )


def spectrogram_plain(audio: torch.Tensor, config: SpectrogramConfig = SpectrogramConfig()) -> torch.Tensor:
    """The plain PyTorch version: STFT magnitude → pool → log1p."""
    mag = stft_magnitude(
        audio,
        n_fft=config.n_fft,
        hop_length=config.hop_length,
        win_length=config.win_length,
        pad_mode=config.pad_mode,
    )  # (..., 2, F, T)
    pooled = block_reduce_mean(mag, config.block)
    return torch.movedim(torch.log1p(pooled), -3, -1)


def spectrogram(audio: torch.Tensor, config: SpectrogramConfig = SpectrogramConfig()) -> torch.Tensor:
    """(B, 2, T) f32 → (B, F', T', 2) f32."""
    if audio.device.type == "cpu":
        return spectrogram_plain(audio, config)
    if audio.device.type != "cuda":
        raise ValueError(f"spectrogram: unsupported device {audio.device}")
    return _launch(audio, config)


spectrogram.launches = 0


def device_twiddles(device: torch.device, plan: SpectrogramPlan) -> torch.Tensor:
    """The plan's twiddle table as (n_fft, 2) f32 on ``device``, made once per
    device and n_fft."""
    key = (str(device), plan.n_fft)
    tw = _TWIDDLES.get(key)
    if tw is None:
        tw = _TWIDDLES[key] = torch.as_tensor(np.ascontiguousarray(plan.twiddles.view(np.float32)), device=device)
    return tw


def _launch(audio: torch.Tensor, config: SpectrogramConfig) -> torch.Tensor:
    if audio.ndim != 3 or audio.shape[1] != 2 or audio.dtype != torch.float32:
        raise ValueError(f"spectrogram: want (B, 2, T) float32, got {tuple(audio.shape)} {audio.dtype}")
    b, _, t = audio.shape
    plan = spectrogram_plan(b, t, config)
    _check_c_plan(plan)
    window = device_window(audio.device, plan.n_fft, config.win_length)
    tw = device_twiddles(audio.device, plan)
    x = audio.contiguous()
    out = torch.empty((b, plan.fprime, plan.tprime, 2), dtype=torch.float32, device=audio.device)
    rc = _lib().spectrogram(
        x.data_ptr(), window.data_ptr(), tw.data_ptr(), out.data_ptr(), b, t, plan.n_fft, plan.hop,
        plan.n_frames, plan.bf, plan.bt, plan.fprime, plan.tprime, cuda_build.current_stream(audio.device),
    )
    cuda_build.check(rc, "spectrogram")
    spectrogram.launches += 1
    return out


def _check_c_plan(plan: SpectrogramPlan) -> None:
    """The C entry's launch (threads, span, buffer slots, shared bytes, group)
    must be the plan's: checked once per shape."""
    key = (plan.n_fft, plan.hop, plan.bt)
    if key in _CHECKED:
        return
    info = (ctypes.c_int * 5)()
    rc = _lib().spectrogram_launch_info(plan.n_fft, plan.hop, plan.bt, info)
    want = (plan.threads, plan.span, plan.buffer_slots, plan.smem_bytes, plan.group)
    if rc != 0 or tuple(info) != want:
        raise RuntimeError(f"spectrogram: the C launch {tuple(info)} (rc {rc}) is not the plan's {want}")
    _CHECKED[key] = True


def _lib():
    lib = cuda_build.load("spectrogram")
    fn = lib.spectrogram
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        info = lib.spectrogram_launch_info
        info.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        info.restype = ctypes.c_int
    return lib
