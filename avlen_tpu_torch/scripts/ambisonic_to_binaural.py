"""Offline ambisonic → binaural RIR conversion.

PyTorch counterpart of ``scripts/ambisonic_to_binaural.py`` (which replaces
the reference's AmbisonicBinauralizer binary driven per scene × angle,
scripts/ambisonic_to_binaural.py:16-47): first-order B-format RIRs (W, Y,
Z, X channels) are rotated about the vertical axis for each head
orientation and decoded to a binaural pair with opposing virtual
cardioids, over the whole RIR bank at once on ``--device``. The decode is
elementwise, so it is plain torch (the JAX script computes it outside any
Pallas kernel too).

Usage:
  python -m avlen_tpu_torch.scripts.ambisonic_to_binaural --input ambi.npy --output out_dir \\
      [--angles 0 90 180 270] [--device cuda|cpu]

``ambi.npy`` holds (num_rirs, 4, L) float32 B-format RIRs; outputs
``out_dir/<angle>.npy`` with (num_rirs, L, 2) binaural RIRs.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from avlen_tpu_torch.utils.platform import require_device


def ambisonic_to_binaural(ambi: torch.Tensor, angle_deg: float) -> torch.Tensor:
    """ambi (B, 4, L) float32 channels (W, Y, Z, X); ``angle_deg`` the head
    angle in degrees. Returns (B, L, 2) float32."""
    w, y, x = ambi[:, 0], ambi[:, 1], ambi[:, 3]
    th = torch.deg2rad(torch.tensor(angle_deg, dtype=torch.float32, device=ambi.device))
    # rotate the horizontal sound field by -angle (head turns by +angle)
    y_r = -x * torch.sin(th) + y * torch.cos(th)
    # virtual cardioids at ±90° (left = +y axis)
    w2 = w * math.sqrt(2.0)
    left = 0.5 * (w2 + y_r)
    right = 0.5 * (w2 - y_r)
    return torch.stack([left, right], dim=-1)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True, help="(N, 4, L) float32 .npy of B-format RIRs")
    p.add_argument("--output", required=True)
    p.add_argument("--angles", type=int, nargs="+", default=[0, 90, 180, 270])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    require_device(args.device)

    ambi = torch.as_tensor(np.load(args.input), dtype=torch.float32, device=args.device)
    os.makedirs(args.output, exist_ok=True)
    for angle in args.angles:
        out = ambisonic_to_binaural(ambi, float(angle)).cpu().numpy()
        np.save(os.path.join(args.output, f"{angle}.npy"), out)
        print(f"wrote {args.output}/{angle}.npy {out.shape}")


if __name__ == "__main__":
    main()
