"""Plain audio observation: RIR convolution and log-mean-pooled spectrogram.

The semantics the port's audio kernels implement, computed the long way in
float64: the full linear convolution of a one-second segment of the padded
source (``L - 1`` leading zeros, so padded and unpadded offsets coincide)
with the binaural RIR, by an FFT long enough to hold all of it, then the
valid window; then librosa's STFT (reflect padding of ``n_fft // 2``, a
periodic Hann window of ``win_length`` centred in ``n_fft``), magnitudes,
mean pooling over ``block`` tiles with the zero padding counted, log1p,
channels last. Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def convolve_window(sound_padded: torch.Tensor, start: torch.Tensor, rir: torch.Tensor,
                    sampling_rate: int) -> torch.Tensor:
    """(B, Lp) padded sounds, (B,) starts in samples, (B, L, 2) RIRs →
    (B, 2, sampling_rate): y[n] = sum_k rir[k] seg[L-1+n-k]."""
    b, l = rir.shape[0], rir.shape[1]
    seg_len = sampling_rate + l - 1
    idx = torch.clamp(start[:, None] + torch.arange(seg_len, device=start.device)[None, :], 0,
                      sound_padded.shape[-1] - 1)
    seg = torch.gather(sound_padded.double(), -1, idx)
    n = 1 << math.ceil(math.log2(seg_len + l - 1))
    full = torch.fft.irfft(torch.fft.rfft(seg, n=n)[:, None, :] * torch.fft.rfft(rir.double().transpose(1, 2), n=n),
                           n=n)
    return full[..., l - 1:l - 1 + sampling_rate]


def spectrogram(audio: torch.Tensor, n_fft: int = 512, hop: int = 160, win_length: int = 400,
                block: Tuple[int, int] = (4, 4)) -> torch.Tensor:
    """(B, 2, T) → (B, F', T', 2)."""
    b, _, t = audio.shape
    k = torch.arange(win_length, dtype=torch.float64, device=audio.device)
    win = 0.5 - 0.5 * torch.cos(2 * math.pi * k / win_length)
    lpad = (n_fft - win_length) // 2
    win = F.pad(win, (lpad, n_fft - win_length - lpad))
    x = F.pad(audio.reshape(b * 2, 1, t), (n_fft // 2, n_fft // 2), mode="reflect").reshape(b, 2, -1)
    frames = x.unfold(-1, n_fft, hop)[..., :1 + t // hop, :] * win
    mag = torch.fft.rfft(frames, dim=-1).abs().transpose(-1, -2)  # (B, 2, freq, time)
    bf, bt = block
    f, tt = mag.shape[-2:]
    mag = F.pad(mag, (0, -(-tt // bt) * bt - tt, 0, -(-f // bf) * bf - f))
    pooled = mag.reshape(b, 2, mag.shape[-2] // bf, bf, mag.shape[-1] // bt, bt).mean(dim=(3, 5))
    return torch.log1p(pooled).permute(0, 2, 3, 1)


def observe(sound_padded, start, rir, active, sampling_rate: int) -> torch.Tensor:
    """The spectrogram observation of B envs; silent where ``active`` is False."""
    audio = convolve_window(sound_padded, start, rir, sampling_rate)
    audio = torch.where(active[:, None, None], audio, torch.zeros((), dtype=audio.dtype, device=audio.device))
    return spectrogram(audio)
