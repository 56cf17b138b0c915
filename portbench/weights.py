"""Weights from the seed, and the checkpoints a configuration loads.

``make_weights`` draws every parameter of the reference's modules on the
device from one ``torch.Generator`` in one call, then scales each leaf:
matrices and convolution kernels by 1/sqrt(fan_in), norm scales about 1,
biases small. The same tensors go to the program (through a checkpoint in
the program's own format, the Flax parameter tree) and to the reference
(by parameter name).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

ATTENTION_PARENTS = ("MultiHeadAttention_0", "self_attn", "cross_attn")


def make_weights(modules: Dict[str, nn.Module], seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module name: {parameter name: float32 tensor on ``device``}}."""
    shapes = [(mod, n, tuple(p.shape)) for mod, m in modules.items() for n, p in m.named_parameters()]
    total = sum(math.prod(s) for _, _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, Dict[str, torch.Tensor]] = {mod: {} for mod in modules}
    at = 0
    for mod, name, shape in shapes:
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if len(shape) >= 2:
            x = x * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif name.endswith(".weight"):  # a norm's scale
            x = 1.0 + 0.1 * x
        else:
            x = 0.02 * x
        out[mod][name] = x.contiguous()
    return out


def flax_tree(module: nn.Module, tensors: Dict[str, torch.Tensor], nhead: int) -> Dict:
    """``{"params": tree}`` of ``tensors`` (keyed by the module's parameter
    names) in the Flax layout the program's checkpoints hold: Dense kernels
    (in, out), conv kernels HWIO, norm ``scale``, attention projections
    (D, H, dh) with (H, dh) biases and the output projection (H, dh, D)."""
    mods = dict(module.named_modules())
    tree: Dict = {}
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        parent, _, attr = owner.rpartition(".")
        m = mods[owner]
        v = t.detach().cpu().numpy()
        attention = parent.rpartition(".")[2] in ATTENTION_PARENTS and attr in ("q", "k", "v", "out")
        if attention and leaf == "weight" and attr == "out":
            v, leaf = v.T.reshape(nhead, -1, v.shape[0]), "kernel"
        elif attention and leaf == "weight":
            v, leaf = v.T.reshape(v.shape[1], nhead, -1), "kernel"
        elif attention and attr != "out":
            v = v.reshape(nhead, -1)
        elif leaf == "weight" and isinstance(m, nn.Linear):
            v, leaf = v.T, "kernel"
        elif leaf == "weight" and isinstance(m, nn.Conv2d):
            v, leaf = v.transpose(2, 3, 1, 0), "kernel"
        elif leaf == "weight":
            leaf = "scale"
        node = tree
        for k in owner.split("."):
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(v)
    return {"params": tree}
