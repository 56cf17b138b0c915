"""Evaluate the neural speaker against the template ground truth (BLEU-4).

PyTorch-port counterpart of ``scripts/eval_speaker.py`` (the reference's
speaker eval entry point, ss_baselines/savi/dialog/speaker/tasks/R2R/
eval_speaker.py: decode val paths, score corpus BLEU against the human
instructions): train the seq2seq speaker on template supervision over
fixed synthetic scene graphs (optionally with the panorama visual feature
bank), then score its decodes against the template channel on held-out
random paths, through ``dialog/speaker/{train_speaker,eval_speaker,
pano_features}.py`` on ``--device``. ``--pano`` encodes the frames with the
port's own ``PanoramaEncoder`` weights (a ``torch.Generator`` seeded with
``--seed``); the JAX script draws its encoder from ``jax.random``, so the
features differ between the packages (ROADMAP, reference behaviours).

Usage:
  python -m avlen_tpu_torch.scripts.eval_speaker [--steps 2000] [--scenes 2] [--side 6]
      [--pano] [--num-paths 200] [--output runs/speaker_eval.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from avlen_tpu_torch.dialog.speaker.eval_speaker import evaluate_neural_vs_template
from avlen_tpu_torch.dialog.speaker.pano_features import PanoramaEncoder, precompute_panorama_features
from avlen_tpu_torch.dialog.speaker.speaker import Speaker
from avlen_tpu_torch.dialog.speaker.train_speaker import train_speaker
from avlen_tpu_torch.sim.graph import build_scene_tables
from avlen_tpu_torch.sim.synthetic import make_frames, make_grid_scene
from avlen_tpu_torch.utils.platform import require_device


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Runs the command line ``argv``; returns the scores it prints (and
    writes to ``--output``)."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--side", type=int, default=6)
    p.add_argument("--pano", action="store_true", help="use panorama visual features")
    p.add_argument("--num-paths", type=int, default=200)
    p.add_argument("--num-pairs", type=int, default=None,
                   help="training pairs (default max(8*batch, 512))")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--beam", type=int, default=1, help="beam size (1 = greedy)")
    p.add_argument("--output", default="")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    require_device(args.device)

    rng = np.random.RandomState(args.seed)
    graphs = [make_grid_scene(rng, side=args.side) for _ in range(args.scenes)]
    tables = [build_scene_tables(g) for g in graphs]

    pano = None
    if args.pano:
        n_max = max(t.num_nodes for t in tables)
        rgb = np.zeros((len(tables), n_max, 4, 32, 32, 3), np.uint8)
        for i, t in enumerate(tables):
            r, _ = make_frames(rng, t.num_nodes, 32)
            rgb[i, : t.num_nodes] = r
        enc = PanoramaEncoder(generator=torch.Generator().manual_seed(args.seed))
        pano = precompute_panorama_features(rgb, enc, device=args.device)
        print(f"panorama feature bank: {pano.shape}")

    params, vocab, acc = train_speaker(
        tables, num_steps=args.steps, pano_features=pano, seed=args.seed,
        num_pairs=args.num_pairs, device=args.device,
    )
    print(f"teacher-forced token accuracy: {acc:.3f}")

    neural = Speaker(
        [t.positions for t in tables], backend="neural", vocab=vocab,
        neural_params=params, pano_features=pano, beam_size=args.beam, device=args.device,
    )
    template = Speaker([t.positions for t in tables], backend="template", vocab=vocab, device=args.device)
    res = evaluate_neural_vs_template(
        neural, template, tables, num_paths=args.num_paths, seed=args.seed + 1
    )
    res["token_acc"] = acc
    res["beam_size"] = args.beam
    print("speaker eval:", json.dumps(res))
    if args.output:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        with open(args.output, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
