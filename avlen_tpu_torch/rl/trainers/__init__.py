"""Trainers of the port, registered by name (``registry.get_trainer``):
only ``"savi"`` so far; any other TRAINER_NAME raises the registry's
KeyError, which lists the known names."""

from avlen_tpu_torch.rl.trainers.base import BaseRLTrainer
from avlen_tpu_torch.rl.trainers.savi import SaviTrainer

__all__ = ["BaseRLTrainer", "SaviTrainer"]
