"""Observation transformers.

PyTorch counterpart of ``avlen_tpu/utils/obs_transformers.py``
(habitat_baselines' obs_transformers: resize / center-crop, the surface
ss_baselines uses through ``ResizeCenterCropper``,
ss_baselines/common/utils.py:412-530). Batched tensor ops on observation
dicts (NHWC images), registry-selectable under the JAX package's names.

``jax.image.resize(..., "bilinear")`` samples at half-pixel centres and,
when it shrinks an image, widens its triangle kernel by the scale
(antialiasing); ``F.interpolate(mode="bilinear", align_corners=False,
antialias=True)`` computes the same filter. A uint8 image is resized in
float32 and cast back by truncation, as ``astype`` does in JAX.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from avlen_tpu_torch.core.registry import registry

IMAGE_KEYS = ("rgb", "depth", "semantic")


@registry.register_model(name="ResizeShortestEdge")
class ResizeShortestEdge:
    """Resize image observations so the shortest edge equals `size`."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = dict(obs)
        for k in IMAGE_KEYS:
            if k not in obs:
                continue
            img = obs[k]
            h, w = img.shape[1], img.shape[2]
            scale = self.size / min(h, w)
            nh, nw = int(round(h * scale)), int(round(w * scale))
            resized = F.interpolate(
                img.float().permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
                align_corners=False, antialias=True,
            ).permute(0, 2, 3, 1)
            out[k] = resized.to(img.dtype) if img.dtype == torch.uint8 else resized
        return out


@registry.register_model(name="CenterCropper")
class CenterCropper:
    """Center-crop image observations to (h, w) (ResizeCenterCropper crop
    stage, common/utils.py:432-530)."""

    def __init__(self, shape: Tuple[int, int]):
        self.shape = shape

    def __call__(self, obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = dict(obs)
        ch, cw = self.shape
        for k in IMAGE_KEYS:
            if k not in obs:
                continue
            img = obs[k]
            h, w = img.shape[1], img.shape[2]
            top, left = max((h - ch) // 2, 0), max((w - cw) // 2, 0)
            out[k] = img[:, top : top + ch, left : left + cw, :]
        return out


class ResizeCenterCropper:
    """Resize then center-crop (common/utils.py:432)."""

    def __init__(self, size: Tuple[int, int]):
        self.resize = ResizeShortestEdge(min(size))
        self.crop = CenterCropper(size)

    def __call__(self, obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.crop(self.resize(obs))


def apply_obs_transforms(obs: Dict[str, torch.Tensor], transforms: Sequence) -> Dict[str, torch.Tensor]:
    for t in transforms:
        obs = t(obs)
    return obs
