"""Build per-scene frame banks.

PyTorch-port counterpart of ``scripts/cache_observations.py`` (the
reference renders and pickles (node, angle) → {rgb, depth} caches via
habitat-sim). There is no renderer, so frames come from the synthetic
generator; they are written in the native mmap bank format served by the
port's frame server (``native/frame_server.cpp``), byte for byte as the JAX
package's script writes them for the same ``--seed``.

Usage:
  python -m avlen_tpu_torch.scripts.cache_observations --output data/scene_observations \
      --scenes 2 --side 8 --res 128
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from avlen_tpu_torch.native.frame_server import write_frame_bank
from avlen_tpu_torch.sim.synthetic import make_frames, make_grid_scene


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--output", required=True)
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--side", type=int, default=8)
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    os.makedirs(args.output, exist_ok=True)
    for i in range(args.scenes):
        graph = make_grid_scene(rng, side=args.side)
        rgb, depth = make_frames(rng, graph.num_nodes, args.res)
        write_frame_bank(os.path.join(args.output, f"scene{i:03d}_rgb.avlf"), rgb)
        write_frame_bank(
            os.path.join(args.output, f"scene{i:03d}_depth.avlf"),
            (depth * 65535).astype(np.uint16),
        )
        print(f"scene{i:03d}: {graph.num_nodes} nodes cached at {args.res}px")


if __name__ == "__main__":
    main()
