"""Experiment CLI.

PyTorch counterpart of ``avlen_tpu/run.py`` (reference
ss_baselines/savi/run.py:25-158):

    python -m avlen_tpu_torch.run --run-type {train,eval} --exp-config <yaml>
        [--model-dir DIR] [--eval-best] [--overwrite] [--prev-ckpt-ind N]
        [--device cuda|cpu] [KEY VALUE ...]

The trainer is chosen by ``TRAINER_NAME`` from the registry; ``--eval-best``
names the checkpoint with the best ``val/spl`` in the run's event files.
``--device`` is ``cuda`` unless ``cpu`` is asked for; without a card a cuda
run raises rather than falling back to the CPU, and so does a card that
is not of the Hopper capability the kernels are built for.

Under torchrun (``python -m torch.distributed.run --nproc_per_node N -m
avlen_tpu_torch.run ...``, or ``avlen_tpu_torch/scripts/slurm_train.sh``)
every rank joins the process group (NCCL with a card a rank, gloo for
ranks that share a card and on the CPU; ``parallel/mesh.py``) on the card
``LOCAL_RANK`` names, and training is data-parallel over the ranks
(``parallel/ddppo.py``); ranks other than 0 log warnings only, and an
eval runs on rank 0 alone.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional

import avlen_tpu_torch.rl.trainers  # noqa: F401  (registers the trainers)
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.core.registry import registry
from avlen_tpu_torch.parallel.mesh import joined_process_group, rank_device
from avlen_tpu_torch.utils.logging import logger
from avlen_tpu_torch.utils.platform import require_device, require_sm90a
from avlen_tpu_torch.utils.tb import read_scalars


def find_best_ckpt_idx(event_dir_path: str, scalar: str = "val/spl"):
    """The checkpoint index with the best eval scalar in the event files
    (run.py:126-154); None when no event holds it."""
    events = read_scalars(event_dir_path).get(scalar)
    if not events:
        return None
    step, _ = max(events, key=lambda e: e[1])
    return step


def main(argv: Optional[List[str]] = None):
    """Runs the command line ``argv``; returns the trainer."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--run-type", choices=["train", "eval"], default="train")
    parser.add_argument("--exp-config", type=str, default=None)
    parser.add_argument("--model-dir", type=str, default=None)
    parser.add_argument("--eval-best", action="store_true", default=False)
    parser.add_argument("--overwrite", action="store_true", default=False)
    parser.add_argument("--prev-ckpt-ind", type=int, default=-1)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    require_device(args.device)
    device = rank_device(args.device)
    if args.device == "cuda":
        require_sm90a(device)
    with joined_process_group(args.device) as rank:
        level = logger.level
        if rank > 0:
            logger.setLevel(logging.WARNING)
        try:
            return _run(args, device, rank)
        finally:
            logger.setLevel(level)


def _run(args, device, rank: int):
    config = get_config(
        args.exp_config, args.opts or None, args.model_dir, args.run_type, args.overwrite
    )
    trainer_cls = registry.get_trainer(config.TRAINER_NAME)
    trainer = trainer_cls(config, device=device)

    os.makedirs(config.MODEL_DIR, exist_ok=True)
    if config.LOG_FILE and rank == 0:
        os.makedirs(os.path.dirname(config.LOG_FILE) or ".", exist_ok=True)
        logger.add_filehandler(config.LOG_FILE)

    if args.run_type == "train":
        trainer.train()
    elif rank == 0:
        if args.eval_best:
            best = find_best_ckpt_idx(config.TENSORBOARD_DIR)
            if best is not None:
                logger.info(f"best checkpoint index: {best}")
        trainer.eval()
    return trainer


if __name__ == "__main__":
    main()
