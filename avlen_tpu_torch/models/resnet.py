"""GroupNorm ResNet-18.

PyTorch counterpart of ``avlen_tpu/models/resnet.py`` (the reference's
smt_resnet.py ResNet-18 with GroupNorm(16) for BatchNorm). Inputs are NHWC,
as in the JAX package; the module permutes to NCHW for the convolutions.
Submodule names follow Flax's automatic names (Conv_0, GroupNorm_0,
BasicBlock_0, ...) so that Flax parameters load by path
(``utils/flax_bridge.py``). GroupNorm eps is Flax's 1e-6.

``dtype`` is the JAX module's: every convolution computes in it, while the
GroupNorms have no dtype and so return float32 (``models/layers.py``); the
residual sums, the pooling and the head are float32. At bfloat16 this is
bfloat16 convolutions with float32 norms and residuals between them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from avlen_tpu_torch.models.init import kaiming_normal_, zeros_
from avlen_tpu_torch.models.layers import Conv2d, GroupNorm

GN_EPS = 1e-6


def _conv(cin, cout, k, stride, pad, gen, dtype):
    conv = Conv2d(cin, cout, k, stride, pad, bias=False, dtype=dtype)
    kaiming_normal_(conv.weight, gen)
    return conv


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, strides: int = 1, groups: int = 16,
                 generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = _conv(in_features, features, 3, strides, 1, generator, dtype)
        self.GroupNorm_0 = GroupNorm(groups, features, eps=GN_EPS)
        self.Conv_1 = _conv(features, features, 3, 1, 1, generator, dtype)
        self.GroupNorm_1 = GroupNorm(groups, features, eps=GN_EPS)
        # Flax adds the projection when the residual's shape differs
        self.project = in_features != features or strides != 1
        if self.project:
            self.Conv_2 = _conv(in_features, features, 1, strides, 0, generator, dtype)
            self.GroupNorm_2 = GroupNorm(groups, features, eps=GN_EPS)

    def forward(self, x):
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        residual = self.GroupNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(residual + y)


class ResNet18(nn.Module):
    """Stages (2,2,2,2), widths 64..512, global-avg-pool → optional Linear head."""

    def __init__(self, in_channels: int, num_outputs: int = 0, width: int = 64, groups: int = 16,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = _conv(in_channels, width, 7, 2, 3, generator, dtype)
        self.GroupNorm_0 = GroupNorm(groups, width, eps=GN_EPS)
        cin, k = width, 0
        for i, blocks in enumerate(stage_sizes):
            feats = width * (2**i)
            for b in range(blocks):
                strides = 2 if i > 0 and b == 0 else 1
                setattr(self, f"BasicBlock_{k}", BasicBlock(cin, feats, strides, groups, generator, dtype))
                cin, k = feats, k + 1
        self.num_blocks = k
        self.out_features = num_outputs or cin
        if num_outputs:
            self.Dense_0 = nn.Linear(cin, num_outputs)
            kaiming_normal_(self.Dense_0.weight, generator)
            zeros_(self.Dense_0.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) → (B, num_outputs or 512)."""
        x = x.float().permute(0, 3, 1, 2)
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for k in range(self.num_blocks):
            x = getattr(self, f"BasicBlock_{k}")(x)
        x = x.mean(dim=(2, 3))
        if hasattr(self, "Dense_0"):
            x = self.Dense_0(x)
        return x
