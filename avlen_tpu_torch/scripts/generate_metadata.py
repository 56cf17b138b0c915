"""Generate scene metadata (navigation graphs).

PyTorch-port counterpart of ``scripts/generate_metadata.py`` (the
reference's scripts/generate_{matterport3d,replica}_metadata.py build
points.txt + graph.pkl per scene): synthesizes grid scenes
(``sim/synthetic.py``) and writes the reference-compatible ``points.txt``
and the packed ``scene.npz`` per scene, the same bytes and arrays as the
JAX package's script at the same ``--seed``. Numpy only; there is no
device work, so ``--device`` is accepted for the CLIs' common surface and
checked, nothing more.

Usage:
  python -m avlen_tpu_torch.scripts.generate_metadata --output data/metadata --scenes 4 --side 10
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from avlen_tpu_torch.sim.graph import build_scene_tables
from avlen_tpu_torch.sim.synthetic import make_grid_scene
from avlen_tpu_torch.utils.platform import require_device


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--output", required=True)
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--side", type=int, default=8)
    p.add_argument("--grid-size", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    require_device(args.device)

    rng = np.random.RandomState(args.seed)
    for i in range(args.scenes):
        graph = make_grid_scene(rng, side=args.side, grid_size=args.grid_size)
        tables = build_scene_tables(graph)
        scene_dir = os.path.join(args.output, f"scene{i:03d}")
        os.makedirs(scene_dir, exist_ok=True)
        # reference-compatible points.txt: index x y z
        with open(os.path.join(scene_dir, "points.txt"), "w") as f:
            for j, pos in enumerate(graph.positions):
                f.write(f"{j}\t{pos[0]:.6f}\t{pos[1]:.6f}\t{pos[2]:.6f}\n")
        np.savez(
            os.path.join(scene_dir, "scene.npz"),
            positions=graph.positions,
            edges=graph.edges,
            hops=tables.hops,
            fwd_next=tables.fwd_next,
            oracle_next=tables.oracle_next,
        )
        print(f"wrote {scene_dir}: {graph.num_nodes} nodes, {len(graph.edges)} edges")


if __name__ == "__main__":
    main()
