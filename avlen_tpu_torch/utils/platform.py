"""The card gate of the port's CUDA kernels.

PyTorch counterpart of ``avlen_tpu/utils/platform.py``. The JAX module
probes the backend for host callbacks and resolves ``TPU.PALLAS_SMT``; the
port needs neither (a torch step calls the host directly, and on a CUDA
tensor the SMT kernel is the only path). What the port does need is the
one fact its kernels assume: ``utils/cuda_build.py`` compiles every kernel
for ``sm_90a`` only, so on any other card the first launch would fail with
an opaque CUDA error. ``require_sm90a`` says so before the first build.
"""

from __future__ import annotations

from typing import Union

import torch

SM90 = (9, 0)


def require_device(device: str) -> None:
    """The CLIs' ``--device`` rule: ``cuda`` raises when no CUDA device is
    available, rather than falling back to the CPU."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to run on the CPU)")


def require_sm90a(device: Union[str, int, torch.device, None] = None) -> None:
    """Raise a ``RuntimeError`` naming the card unless ``device`` (default:
    the current CUDA device) has compute capability 9.0, the Hopper
    capability the kernels' ``sm_90a`` code runs on."""
    cap = tuple(torch.cuda.get_device_capability(device))
    if cap != SM90:
        name = torch.cuda.get_device_name(device)
        raise RuntimeError(
            f"{name} has compute capability {cap[0]}.{cap[1]}; the port's CUDA kernels "
            f"are built for sm_90a only and need a Hopper card of capability 9.0"
        )
