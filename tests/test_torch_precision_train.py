"""``TPU.PRECISION bfloat16`` through the four trainers of the port on tiny
worlds, on the CPU: SAVi (savi.yaml), AVLEN (savi_interactive_2nd_stage.yaml,
π_q's PPO and π_l's replay CE), AV-Nav and AV-WAN each set up with their
towers at bfloat16, run one collect and one update with finite losses, and
write a checkpoint whose trees are all float32 and load back exactly."""

import copy

import numpy as np
import pytest
import torch

from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.models.layers import Conv2d
from avlen_tpu_torch.rl.trainers.avnav import AVNavTrainer
from avlen_tpu_torch.rl.trainers.avwan import AVWanTrainer
from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer
from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
from avlen_tpu_torch.utils.checkpoint import load_checkpoint
from avlen_tpu_torch.utils.flax_bridge import _flatten, load_flax_params
from tests.test_torch_avnav import AVNAV, SPLIT
from tests.test_torch_avwan import AVWAN, TRAIN
from tests.test_torch_interactive_update import STAGE2
from tests.test_torch_interactive_update import TINY as AVLEN_TINY
from tests.test_torch_slice import OPTS as SAVI_TINY
from tests.test_torch_slice import SAVI

torch.set_num_threads(1)

STACKS = {  # trainer, config, tiny opts, the policies the checkpoint holds
    "savi": (SaviTrainer, SAVI, SAVI_TINY, ("policy",)),
    "avlen": (InteractiveDDPPOTrainer, STAGE2, AVLEN_TINY + ["RL.PPO.num_steps", "6"], ("option_policy",)),
    "avnav": (AVNavTrainer, AVNAV, SPLIT, ("policy",)),
    "avwan": (AVWanTrainer, AVWAN, TRAIN, ("policy",)),
}


@pytest.mark.parametrize("stack", list(STACKS))
def test_trainer_runs_at_bfloat16_and_checkpoints_float32(stack, tmp_path):
    cls, yaml, opts, held = STACKS[stack]
    cfg = get_config(yaml, opts=list(opts) + ["TPU.PRECISION", "bfloat16",
                                              "CHECKPOINT_FOLDER", str(tmp_path)])
    tr = cls(cfg, device="cpu")
    tr._setup()
    assert tr.compute_dtype() == torch.bfloat16
    convs = [m for name in held for m in getattr(tr, name).modules() if isinstance(m, Conv2d)]
    assert convs and all(m.compute_dtype == torch.bfloat16 for m in convs)

    _, batch = tr.collect()
    stats = tr.update(batch)
    assert stats and all(torch.isfinite(v).all() for v in stats.values()), stats
    for name in held:
        assert all(p.dtype == torch.float32 for p in getattr(tr, name).parameters())

    ckpt = load_checkpoint(tr.save_checkpoint("ckpt.0.pth"))
    leaves = _flatten(ckpt["state_dict"])
    assert leaves and all(np.asarray(v).dtype == np.float32 for v in leaves.values())
    policy = getattr(tr, held[0])
    back = copy.deepcopy(policy)
    with torch.no_grad():
        for p in back.parameters():
            p.zero_()
    load_flax_params(back, ckpt["state_dict"])
    for (name, want), got in zip(policy.state_dict().items(), back.state_dict().values()):
        assert torch.equal(got, want), name
