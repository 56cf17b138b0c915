"""Trainers of the port, registered by name (``registry.get_trainer``), the
JAX package's four: ``"AVNavTrainer"``, ``"AVWanTrainer"``, ``"savi"`` and
``"ddppo"`` (``ddppo_trainer``: the SAVi trainer for the rnn/smt policy
types, else the AVLEN interactive trainer); any other TRAINER_NAME raises
the registry's KeyError, which lists the known names."""

from avlen_tpu_torch.rl.trainers.avnav import AVNavTrainer
from avlen_tpu_torch.rl.trainers.avwan import AVWanTrainer
from avlen_tpu_torch.rl.trainers.base import BaseRLTrainer
from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer
from avlen_tpu_torch.rl.trainers.savi import SaviTrainer

__all__ = ["AVNavTrainer", "AVWanTrainer", "BaseRLTrainer", "InteractiveDDPPOTrainer", "SaviTrainer"]
