"""Generate dialog (VLN-style) episode datasets.

PyTorch-port counterpart of the repo's ``scripts/generate_vln_episodes.py``
(same modes, arguments and outputs; a host program, no device), itself
the counterpart of scripts/generate_vln_episode.py in the reference
(aligns Fine-Grained R2R sub-instructions + VLN-CE paths onto SoundSpaces
graphs to build the `semantic_audionav_dialog_approx` dataset). Two modes:

* default (synthetic): episodes are sampled on synthetic scenes and each
  episode's ``sub_instr`` is generated by the speaker over the episode's
  shortest path — the same pairing of (path, instruction) the dialog
  pretraining stage consumes.

      python -m avlen_tpu_torch.scripts.generate_vln_episodes --output dialog.json.gz \
          --episodes 200 --scenes 2 --side 8

* ``--from-r2r``: the reference's full alignment pipeline over real (or
  fabricated format-exact) FGR2R + VLN-CE + MatterSim connectivity data and
  a semantic-audionav dataset tree (``avlen_tpu_torch/data/vln.py``;
  reference generate_vln_episode.py:679-717).

      python -m avlen_tpu_torch.scripts.generate_vln_episodes --from-r2r \
          --fgr2r data/Fine-Grained-R2R/data/FGR2R_train.json \
          --vlnce data/R2R_VLNCE_v1-2/train/train.json.gz \
          --connectivity-dir connectivity \
          --metadata-dir data/metadata/mp3d \
          --audionav-dir data/datasets/semantic_audionav/mp3d/v1/train \
          --output-dir data/datasets/semantic_audionav_dialog_approx/mp3d/v1/train
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from avlen_tpu_torch.core.episodes import EpisodeDataset
from avlen_tpu_torch.dialog.instruction_bank import shortest_path_prefix
from avlen_tpu_torch.dialog.speaker.speaker import Speaker
from avlen_tpu_torch.sim.graph import build_scene_tables
from avlen_tpu_torch.sim.synthetic import make_episodes, make_grid_scene


def _from_r2r(args) -> None:
    from avlen_tpu_torch.data.reference import load_scene_graph
    from avlen_tpu_torch.data.vln import generate_dialog_dataset

    scene_graphs = {
        scan: load_scene_graph(os.path.join(args.metadata_dir, scan))
        for scan in sorted(os.listdir(args.metadata_dir))
        if os.path.isdir(os.path.join(args.metadata_dir, scan))
    }
    counts = generate_dialog_dataset(
        fgr2r_path=args.fgr2r,
        vlnce_paths=args.vlnce,
        connectivity_dir=args.connectivity_dir,
        scene_graphs=scene_graphs,
        audionav_dataset_dir=args.audionav_dir,
        output_dir=args.output_dir,
        min_path_len=args.min_path_len,
        seed=args.seed,
    )
    total = sum(counts.values())
    print(f"wrote {args.output_dir}: {total} dialog episodes over {len(counts)} scans")


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--output", default="")
    p.add_argument("--episodes", type=int, default=200)
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--side", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    # --from-r2r mode
    p.add_argument("--from-r2r", action="store_true")
    p.add_argument("--fgr2r", help="FGR2R_{split}.json")
    p.add_argument("--vlnce", nargs="+", help="VLN-CE {split}.json.gz files")
    p.add_argument("--connectivity-dir", help="MatterSim connectivity jsons")
    p.add_argument("--metadata-dir", help="points.txt/graph.pkl tree, one dir per scan")
    p.add_argument("--audionav-dir", help="semantic audionav split dir (content/*.json.gz)")
    p.add_argument("--output-dir", help="dialog_approx output split dir")
    p.add_argument("--min-path-len", type=int, default=7)
    args = p.parse_args(argv)

    if args.from_r2r:
        _from_r2r(args)
        return
    if not args.output:
        p.error("--output is required in synthetic mode")

    rng = np.random.RandomState(args.seed)
    tables = [build_scene_tables(make_grid_scene(rng, side=args.side)) for _ in range(args.scenes)]
    episodes = make_episodes(rng, tables, args.episodes, min_hops=2, max_hops=20)
    speaker = Speaker([t.positions for t in tables], backend="template", device="cpu")

    for ep in episodes:
        path = shortest_path_prefix(tables[ep.scene_id], ep.start_node, ep.goal_node, max_len=4)
        heading = (270 - ep.start_rot_idx * 90) % 360
        ep.sub_instr = speaker.instruction_text(
            [{"heading": heading, "scene": ep.scene_id, "path": path, "category": ep.category}]
        )[0]
        if len(path) > 1:
            ep.dialog_node = path[-1]

    EpisodeDataset(episodes).to_json_gz(args.output)
    print(f"wrote {args.output}: {len(episodes)} dialog episodes")


if __name__ == "__main__":
    main()
