"""Batched audio rendering: binaural RIR convolution + spectrogram.

PyTorch counterpart of ``avlen_tpu/ops/audio.py`` with the same semantics:

* one valid-mode FFT convolution per env and step,
  ``out[t] = sum_k rir[k] * sound[i*sr + t - k]`` over a fixed-length
  segment of the zero-led padded sound, evaluated as the product of the
  segment and RIR spectra followed by ONE partial inverse transform that
  produces only the valid 1-second window (``ops/irfft_cuda.py``);
* STFT with n_fft 512, hop 160, a periodic Hann(400) centred in the frame,
  reflect padding, magnitude; 4x4 mean pooling with zero padding counted in
  the mean; log1p; channels last (``ops/spectrogram_cuda.py``).

The two transforms dispatch on the tensor's device: on a CUDA tensor they
launch the hand-written kernels, on a CPU tensor they run the kernels' plain
PyTorch versions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SpectrogramConfig:
    sampling_rate: int = 16000
    n_fft: int = 512
    hop_length: int = 160
    win_length: int = 400
    block: Tuple[int, int] = (4, 4)
    pad_mode: str = "reflect"

    @property
    def num_frames(self) -> int:
        # center=True pads n_fft//2 both sides: 1 + T // hop frames
        return 1 + self.sampling_rate // self.hop_length

    @property
    def num_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def out_shape(self) -> Tuple[int, int, int]:
        f = -(-self.num_freqs // self.block[0])
        t = -(-self.num_frames // self.block[1])
        return (f, t, 2)


def periodic_hann(win_length: int) -> np.ndarray:
    # scipy.signal.get_window('hann', N, fftbins=True)
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def centered_window(n_fft: int, win_length: int) -> np.ndarray:
    win = periodic_hann(win_length)
    pad = n_fft - win_length
    lpad = pad // 2
    return np.pad(win, (lpad, pad - lpad)).astype(np.float32)


_WINDOWS: Dict[Tuple[str, int, int], torch.Tensor] = {}


def device_window(device: torch.device, n_fft: int, win_length: int) -> torch.Tensor:
    """``centered_window(n_fft, win_length)`` on ``device``, copied there once
    per (device, n_fft, win_length): a copy from host memory on every call
    would make the caller's stream wait on the host."""
    key = (str(device), n_fft, win_length)
    window = _WINDOWS.get(key)
    if window is None:
        window = _WINDOWS[key] = torch.as_tensor(centered_window(n_fft, win_length), device=device)
    return window


def stft_magnitude(
    x: torch.Tensor,
    n_fft: int = 512,
    hop_length: int = 160,
    win_length: int = 400,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """|STFT| of ``x`` (..., T) → (..., n_fft//2+1, n_frames), librosa-compatible."""
    window = device_window(x.device, n_fft, win_length)
    lead, t = x.shape[:-1], x.shape[-1]
    pad = n_fft // 2
    xp = F.pad(x.reshape(-1, 1, t), (pad, pad), mode=pad_mode).reshape(*lead, t + 2 * pad)
    n_frames = 1 + t // hop_length
    frames = xp.unfold(-1, n_fft, hop_length)[..., :n_frames, :] * window
    spec = torch.fft.rfft(frames.float(), dim=-1)
    return spec.abs().transpose(-1, -2)  # (..., freq, time)


def block_reduce_mean(x: torch.Tensor, block: Tuple[int, int] = (4, 4)) -> torch.Tensor:
    """Mean-pool the last two dims in ``block``-sized tiles, zero padding at the
    edges counted in the mean (skimage.measure.block_reduce semantics)."""
    bf, bt = block
    f, t = x.shape[-2], x.shape[-1]
    fp, tp = -(-f // bf) * bf, -(-t // bt) * bt
    xp = F.pad(x, (0, tp - t, 0, fp - f))
    shape = x.shape[:-2] + (fp // bf, bf, tp // bt, bt)
    return xp.reshape(shape).mean(dim=(-3, -1))


def spectrogram_from_audiogoal(audio: torch.Tensor, config: SpectrogramConfig = SpectrogramConfig()) -> torch.Tensor:
    """(..., 2, T) binaural audio → (..., F', T', 2) log-mean-pooled spectrogram
    (SpectrogramSensor.compute_spectrogram, soundspaces/tasks/nav.py:87-101)."""
    from avlen_tpu_torch.ops.spectrogram_cuda import spectrogram

    lead, t = audio.shape[:-2], audio.shape[-1]
    out = spectrogram(audio.reshape(-1, 2, t), config)
    return out.reshape(*lead, *out.shape[1:])


def conv_fft_len(out_len: int, max_rir_len: int) -> int:
    need = out_len + 2 * max_rir_len - 2
    n = 1
    while n < need:
        n *= 2
    return n


def _convolve_from_fft(prod: torch.Tensor, rir_len: int, sampling_rate: int, fft_len: int) -> torch.Tensor:
    """(B, 2, F) product spectra (seg_f × rir_f) → (B, 2, sr) valid windows."""
    from avlen_tpu_torch.ops.irfft_cuda import partial_irfft

    return partial_irfft(prod, fft_len, rir_len - 1, sampling_rate)


def _product_spectrum(sound_padded, window_start, rir, sampling_rate, seg_f, rir_f, rir_len):
    """(B, 2, F) product spectrum seg_f × rir_f (+ the L, fft_len statics)."""
    l = int(rir.shape[1]) if rir is not None else int(rir_len)
    seg_len = sampling_rate + l - 1
    fft_len = conv_fft_len(sampling_rate, l)
    if seg_f is None:
        # the L-1 leading zeros make padded and unpadded offsets coincide
        idx = window_start[:, None] + torch.arange(seg_len, device=sound_padded.device)[None, :]
        idx = torch.clamp(idx, 0, sound_padded.shape[-1] - 1)
        seg = torch.gather(sound_padded, -1, idx)  # (B, seg_len)
        seg_f = torch.fft.rfft(seg.float(), n=fft_len, dim=-1)
    if rir_f is None:
        rir_f = torch.fft.rfft(rir.transpose(1, 2).float(), n=fft_len, dim=-1)  # (B, 2, F)
    return seg_f[:, None, :] * rir_f, l, fft_len


def binaural_convolve(
    sound_padded: torch.Tensor,
    window_start: torch.Tensor,
    rir: Optional[torch.Tensor],
    sampling_rate: int,
    seg_f: Optional[torch.Tensor] = None,
    rir_f: Optional[torch.Tensor] = None,
    rir_len: Optional[int] = None,
) -> torch.Tensor:
    """One 1-second binaural window of RIR-convolved source audio, batched:
    (B, L-1+S) padded sounds, (B,) window starts in samples, (B, L, 2) RIRs
    or their (B, 2, F) spectra → (B, 2, sampling_rate)."""
    prod, l, fft_len = _product_spectrum(
        sound_padded, window_start, rir, sampling_rate, seg_f, rir_f, rir_len
    )
    return _convolve_from_fft(prod, l, sampling_rate, fft_len)


def render_audiogoal(
    sound_padded: torch.Tensor,
    audio_index: torch.Tensor,
    rir: Optional[torch.Tensor],
    active: torch.Tensor,
    sampling_rate: int,
    distractor_sound_padded: Optional[torch.Tensor] = None,
    distractor_rir: Optional[torch.Tensor] = None,
    has_distractor: bool = False,
    config: Optional[SpectrogramConfig] = None,
    seg_f: Optional[torch.Tensor] = None,
    distractor_seg_f: Optional[torch.Tensor] = None,
    rir_f: Optional[torch.Tensor] = None,
    distractor_rir_f: Optional[torch.Tensor] = None,
    rir_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Audio observation for a batch of envs: (B, 2, sr) waveform and its
    spectrogram. ``active`` (B,) silences envs past the sound's duration; the
    distractor renders its first second and is summed with the goal in the
    frequency domain, so both pay ONE inverse transform."""
    cfg = config or SpectrogramConfig(sampling_rate=sampling_rate)
    start = audio_index * sampling_rate
    prod, l, fft_len = _product_spectrum(
        sound_padded, start, rir, sampling_rate, seg_f, rir_f, rir_len
    )
    if has_distractor:
        dprod, dl, dfft = _product_spectrum(
            distractor_sound_padded, torch.zeros_like(start), distractor_rir, sampling_rate,
            distractor_seg_f, distractor_rir_f, rir_len,
        )
        if (dl, dfft) != (l, fft_len):
            raise ValueError("goal and distractor RIRs must share one length")
        prod = prod + dprod
    audio = _convolve_from_fft(prod, l, sampling_rate, fft_len)
    audio = torch.where(active[:, None, None], audio, torch.zeros((), device=audio.device))
    spec = spectrogram_from_audiogoal(audio, cfg)
    return audio, spec
