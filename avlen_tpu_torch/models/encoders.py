"""Observation encoders (AudioCNN, VisualCNN).

PyTorch counterpart of ``avlen_tpu/models/encoders.py`` (reference
audio_cnn.py:15-89, visual_cnn.py:44-154): a VALID conv stack → flatten →
Linear → ReLU. Inputs are NHWC; the flatten runs in NHWC order, as Flax's does, so
carried weights line up. Kernels are clamped to the running spatial dims
(so tiny test inputs never collapse to size 0), which fixes the layer
shapes at construction from ``input_hw``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from avlen_tpu_torch.models.init import kaiming_normal_, linear, zeros_


class ConvEncoder(nn.Module):
    """3-layer VALID conv stack → flatten → Linear(output_size) → ReLU."""

    def __init__(self, in_channels: int, input_hw: Tuple[int, int], output_size: int,
                 kernels: Sequence[Tuple[int, int]], strides: Sequence[Tuple[int, int]],
                 channels: Sequence[int] = (32, 64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, w = input_hw
        cin = in_channels
        self.num_convs = len(kernels)
        for i, (k, s, c) in enumerate(zip(kernels, strides, channels)):
            k = (min(k[0], h), min(k[1], w))
            conv = nn.Conv2d(cin, c, k, s)
            kaiming_normal_(conv.weight, generator)
            zeros_(conv.bias)
            setattr(self, f"Conv_{i}", conv)
            h, w = (h - k[0]) // s[0] + 1, (w - k[1]) // s[1] + 1
            cin = c
        self.Dense_0 = linear(cin * h * w, output_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            x = getattr(self, f"Conv_{i}")(x)
            if i < self.num_convs - 1:
                x = F.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        return F.relu(self.Dense_0(x))


class AudioCNN(nn.Module):
    """Small-input kernel schedule when either spatial dim < 30 (the 65×26
    spectrogram hits this)."""

    def __init__(self, output_size: int, input_hw: Tuple[int, int], in_channels: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, w = input_hw
        if h < 30 or w < 30:
            kernels, strides = [(5, 5), (3, 3), (3, 3)], [(2, 2), (2, 2), (1, 1)]
        else:
            kernels, strides = [(8, 8), (4, 4), (3, 3)], [(4, 4), (2, 2), (1, 1)]
        self.ConvEncoder_0 = ConvEncoder(in_channels, input_hw, output_size, kernels, strides,
                                         generator=generator)

    def forward(self, spectrogram: torch.Tensor) -> torch.Tensor:
        return self.ConvEncoder_0(spectrogram)


class VisualCNN(nn.Module):
    """RGB-D encoder (visual_cnn.py:44-154): rgb (uint8, /255) ‖ depth along
    channels, in that order; the small-input schedule when min(H, W) < 40,
    else kernels 8/4/3 with strides 4/2/2."""

    def __init__(self, output_size: int, input_hw: Tuple[int, int], use_rgb: bool = False,
                 use_depth: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        assert use_rgb or use_depth, "VisualCNN requires rgb and/or depth"
        self.use_rgb, self.use_depth = use_rgb, use_depth
        if min(input_hw) < 40:
            kernels, strides = [(5, 5), (3, 3), (3, 3)], [(2, 2), (2, 2), (1, 1)]
        else:
            kernels, strides = [(8, 8), (4, 4), (3, 3)], [(4, 4), (2, 2), (2, 2)]
        channels = 3 * int(use_rgb) + int(use_depth)
        self.ConvEncoder_0 = ConvEncoder(channels, input_hw, output_size, kernels, strides,
                                         generator=generator)

    def forward(self, rgb: Optional[torch.Tensor] = None, depth: Optional[torch.Tensor] = None) -> torch.Tensor:
        parts = []
        if self.use_rgb:
            parts.append(rgb.float() / 255.0)
        if self.use_depth:
            parts.append(depth.float())
        return self.ConvEncoder_0(torch.cat(parts, dim=-1))
