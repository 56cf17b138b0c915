"""Flax's default initialisers, drawn from an explicit ``torch.Generator``.

``kaiming_normal_`` is Flax's ``kaiming_normal()``: a fan-in normal with
variance 2/fan_in, truncated at two standard deviations and rescaled so the
truncated draw keeps that variance. The numbers differ from Flax's (another
generator); weights that must match are carried across by
``utils/flax_bridge.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _fan_in(w: torch.Tensor) -> int:
    # Linear (out, in) and Conv (out, in, kh, kw): fan_in = in * receptive field
    return w.shape[1] * (w[0, 0].numel() if w.ndim > 2 else 1)


@torch.no_grad()
def kaiming_normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    std = math.sqrt(2.0 / _fan_in(w)) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Flax's default Dense/DenseGeneral init: a fan-in normal of variance
    1/fan_in, truncated at two standard deviations and rescaled."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def orthogonal_(w: torch.Tensor, gain: float, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return torch.nn.init.orthogonal_(w, gain, generator=generator)


@torch.no_grad()
def zeros_(w: torch.Tensor) -> torch.Tensor:
    return w.zero_()


def linear(cin: int, cout: int, generator: Optional[torch.Generator] = None) -> torch.nn.Linear:
    """Flax Dense(kernel_init=kaiming_normal()) with zero bias."""
    layer = torch.nn.Linear(cin, cout)
    kaiming_normal_(layer.weight, generator)
    zeros_(layer.bias)
    return layer
