"""Preemption handling: signal hooks + interrupted-state save/requeue
(a copy of avlen_tpu/utils/preemption.py over the port's checkpoints).

Capability match for the reference's SLURM-centric elastic layer
(ss_baselines/savi/ddppo/algo/ddp_utils.py:26-122: SIGUSR1 → save full
interrupted state to ~/.interrupted_states/$SLURM_JOBID.pth and
`scontrol requeue`; SIGINT/SIGTERM/SIGUSR2 → clean exit): register
handlers, poll `should_exit()` in the train loop, save a resumable
snapshot, requeue when running under SLURM.
"""

from __future__ import annotations

import os
import signal
import subprocess
from typing import Any, Dict, Optional

from avlen_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from avlen_tpu_torch.utils.logging import logger

EXIT = {"requested": False, "requeue": False}

INTERRUPTED_STATE_DIR = os.path.join(os.path.expanduser("~"), ".interrupted_states")


def _interrupted_state_path() -> str:
    job = os.environ.get("SLURM_JOB_ID", "local")
    return os.path.join(INTERRUPTED_STATE_DIR, f"{job}.pth")


def register_signal_handlers() -> None:
    """(ddp_utils.py:43-67)."""

    def clean_exit(signum, frame):
        logger.info(f"signal {signum}: exiting cleanly")
        EXIT["requested"] = True
        EXIT["requeue"] = False

    def requeue(signum, frame):
        logger.info(f"signal {signum}: requeue requested")
        EXIT["requested"] = True
        EXIT["requeue"] = True

    signal.signal(signal.SIGINT, clean_exit)
    signal.signal(signal.SIGTERM, clean_exit)
    signal.signal(signal.SIGUSR2, clean_exit)
    signal.signal(signal.SIGUSR1, requeue)


def should_exit() -> bool:
    return EXIT["requested"]


def save_interrupted_state(state: Dict[str, Any]) -> str:
    """(ddp_utils.py:70-99)."""
    os.makedirs(INTERRUPTED_STATE_DIR, exist_ok=True)
    path = _interrupted_state_path()
    save_checkpoint(os.path.dirname(path), os.path.basename(path), state)
    logger.info(f"saved interrupted state to {path}")
    return path


def load_interrupted_state() -> Optional[Dict[str, Any]]:
    path = _interrupted_state_path()
    if os.path.exists(path):
        return load_checkpoint(path)
    return None


def requeue_job() -> None:
    """(ddp_utils.py:101-122)."""
    if not EXIT["requeue"]:
        return
    job = os.environ.get("SLURM_JOB_ID")
    if job and os.environ.get("SLURM_PROCID", "0") == "0":
        logger.info(f"scontrol requeue {job}")
        subprocess.run(["scontrol", "requeue", job], check=False)
