"""SMT visual encoder: GroupNorm ResNet-18 towers over RGB and depth.

PyTorch counterpart of ``avlen_tpu/models/smt_cnn.py`` (reference
smt_cnn.py:19-130): per-modality towers over 64×64 centre-cropped frames,
each projected to a 64-d embedding, concatenated. The frames are cast to
float32 before the towers, which compute at ``dtype`` (``models/resnet.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from avlen_tpu_torch.models.resnet import ResNet18


def center_crop(x: torch.Tensor, size: int = 64) -> torch.Tensor:
    h, w = x.shape[1], x.shape[2]
    if h <= size and w <= size:
        return x
    top, left = max((h - size) // 2, 0), max((w - size) // 2, 0)
    return x[:, top : top + min(size, h), left : left + min(size, w), :]


class SMTCNN(nn.Module):
    def __init__(self, use_rgb: bool = True, use_depth: bool = True, embedding_size: int = 64,
                 crop_size: int = 64, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_rgb, self.use_depth, self.crop_size = use_rgb, use_depth, crop_size
        self.feature_dims = embedding_size * (int(use_rgb) + int(use_depth))
        if use_rgb:
            self.rgb_tower = ResNet18(3, embedding_size, generator=generator, dtype=dtype)
        if use_depth:
            self.depth_tower = ResNet18(1, embedding_size, generator=generator, dtype=dtype)

    def forward(self, rgb: Optional[torch.Tensor] = None, depth: Optional[torch.Tensor] = None) -> torch.Tensor:
        outs = []
        if self.use_rgb:
            outs.append(self.rgb_tower(center_crop(rgb.float() / 255.0, self.crop_size)))
        if self.use_depth:
            outs.append(self.depth_tower(center_crop(depth.float(), self.crop_size)))
        return torch.cat(outs, dim=-1)
