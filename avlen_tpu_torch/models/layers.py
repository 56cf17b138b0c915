"""Conv, Dense, GroupNorm and LayerNorm with Flax's dtype rule.

``TPU.PRECISION`` is the compute dtype of the JAX package's towers
(``avlen_tpu/rl/trainers/base.py:compute_dtype``). Parameters stay float32
in both packages; what a layer computes in follows Flax:

* a layer built with a ``dtype`` casts its input and its parameters to that
  dtype and returns it (Conv and Dense at bfloat16 return bfloat16);
* a layer built with none promotes its input and its parameters together,
  so a bfloat16 input with float32 parameters gives float32 (a head Dense, a
  GroupNorm or LayerNorm without a dtype fed a bfloat16 activation);
* a norm computes its statistics in float32 and casts its result last.

torch differs at both points: ``F.linear``/``F.conv2d`` refuse a bfloat16
input with float32 weights, and ``nn.GroupNorm``/``nn.LayerNorm`` return
the input's dtype (bfloat16 where Flax returns float32). These subclasses
keep torch's parameter names and classes (the Flax bridge and the
checkpoints see ``nn.Linear``/``nn.Conv2d``/``nn.GroupNorm``/``nn.LayerNorm``)
and compute as Flax does. With float32 inputs and no dtype or float32 they
run the very calls of the torch classes, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

PRECISIONS = {
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float32": torch.float32, "fp32": torch.float32,
    "float16": torch.float16, "fp16": torch.float16,
}


def precision_dtype(name: str) -> torch.dtype:
    """``TPU.PRECISION`` → the compute dtype, JAX's table and error."""
    key = str(name).lower()
    if key not in PRECISIONS:
        raise ValueError(f"unknown TPU.PRECISION {key!r}")
    return PRECISIONS[key]


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return t if t is None or t.dtype == dtype else t.to(dtype)


def _promoted(x: torch.Tensor, param: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, param.dtype)


class Conv2d(nn.Conv2d):
    """Flax ``nn.Conv(dtype=...)`` on an NCHW tensor.

    On a CUDA tensor a 16-bit convolution is cuDNN's (16-bit operands,
    float32 accumulation). torch 2.13's CPU convolution at bfloat16 (oneDNN
    3.12) returns wrong values, or NaN, on thin maps (a 10 x 2 map at stride 2,
    which the ResNet towers reach on a spectrogram), so on the CPU a 16-bit
    convolution is the float32 convolution of the operands rounded to the
    dtype, rounded to it: the same operation, accumulated in float32."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promoted(x, self.weight, self.compute_dtype)
        x, w, b = _cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt)
        if x.device.type == "cpu" and dt in (torch.bfloat16, torch.float16):
            return F.conv2d(x.float(), w.float(), None if b is None else b.float(),
                            self.stride, self.padding, self.dilation, self.groups).to(dt)
        return F.conv2d(x, w, b, self.stride, self.padding, self.dilation, self.groups)


class Linear(nn.Linear):
    """Flax ``nn.Dense(dtype=...)``."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promoted(x, self.weight, self.compute_dtype)
        return F.linear(_cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt))


class GroupNorm(nn.GroupNorm):
    """Flax ``nn.GroupNorm(dtype=...)``: float32 statistics, the result in
    ``dtype``, or in the input's dtype promoted with the parameters'."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _promoted(x, self.weight, self.compute_dtype)
        y = F.group_norm(_cast(x, torch.float32), self.num_groups, self.weight, self.bias, self.eps)
        return _cast(y, out)


class LayerNorm(nn.LayerNorm):
    """Flax ``nn.LayerNorm(dtype=...)``, as ``GroupNorm`` above."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _promoted(x, self.weight, self.compute_dtype)
        y = F.layer_norm(_cast(x, torch.float32), self.normalized_shape, self.weight, self.bias, self.eps)
        return _cast(y, out)
