"""Panorama visual features for the speaker.

PyTorch counterpart of ``avlen_tpu/dialog/speaker/pano_features.py``. The
reference speaker reads precomputed ResNet-152 ImageNet panorama features
per viewpoint (36 views × 2048, speaker/tasks/R2R/env.py:40-74; the
heading-aligned view selection of env.py:155-235). Here the scene frame
bank is encoded once on the device by the port's GN ResNet-18 with a
PANO_FEAT_DIM head into an (S, N, R, D) bank (R = 4 headings), so a
world feature is a gather.

The JAX package initialises this encoder from ``jax.random.key(0)`` on
every ``speaker_from_config`` call and never saves it; PyTorch cannot draw
the same numbers, so a speaker trained with USE_PANO_FEATURES in one
package is served other features in the other (ROADMAP, reference
behaviours). With the same encoder weights the features agree.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from avlen_tpu_torch.models.resnet import ResNet18

PANO_FEAT_DIM = 128


class PanoramaEncoder(ResNet18):
    """GN ResNet-18 → PANO_FEAT_DIM projection (the from-scratch stand-in
    for frozen ResNet-152 ImageNet features)."""

    def __init__(self, in_channels: int = 3, generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, num_outputs=PANO_FEAT_DIM, generator=generator)


@torch.no_grad()
def precompute_panorama_features(
    rgb, encoder: PanoramaEncoder, batch: int = 256, device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """(S, N, R, H, W, 3) uint8 frame bank → (S, N, R, D) float32 features,
    encoded on ``device`` in fixed batches of ``batch`` frames (the last
    one zero-padded, as the JAX package pads it)."""
    rgb = np.asarray(rgb)
    s, n, r, h, w, c = rgb.shape
    flat = torch.from_numpy(rgb.reshape(-1, h, w, c))
    device = torch.device(device)
    encoder = encoder.to(device).eval()
    outs = []
    for i in range(0, len(flat), batch):
        x = torch.zeros((batch, h, w, c), dtype=torch.float32, device=device)
        chunk = flat[i:i + batch].to(device)
        x[: len(chunk)] = chunk.float() / 255.0
        outs.append(encoder(x)[: len(chunk)].cpu())
    return torch.cat(outs).numpy().reshape(s, n, r, -1)


def heading_to_rot_index(heading_deg) -> np.ndarray:
    """Nearest frame-bank rotation index for a heading in degrees
    (atan2(dz, dx) convention; rot r faces (270 - 90 r) % 360, the env's
    orientation layout)."""
    h = np.asarray(heading_deg, np.float64)
    return (np.rint((270.0 - h) / 90.0).astype(np.int64) % 4).astype(np.int32)
