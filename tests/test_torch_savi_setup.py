"""``SaviTrainer._setup`` of the port chooses the pretrained weights as the
JAX trainer does (avlen_tpu/rl/trainers/savi.py:104-145): DDPPO's
``pretrained_weights`` when DDPPO.pretrained is on, else the SMT
``pretrained_path``; the belief predictor's path only under
use_belief_predictor. A chosen path that does not exist raises
FileNotFoundError as in JAX; one that exists is a real checkpoint (a
critic head only) whose leaves ``_setup`` merges into the policy of a tiny
world; a path JAX never reads raises nothing.
Also: TPU.PRECISION bfloat16 sets up, and a name outside JAX's table
raises its ValueError; the sequential ring replay (``batched_eval`` off)
sets up as JAX's does."""

import numpy as np
import pytest
import torch

from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.rl.trainers import savi
from avlen_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

SAVI = "configs/semantic_audionav/savi/savi.yaml"
TINY = [  # a world of 4 x 4 nodes, 3 envs, d_model 32
    "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "20",
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "2000",
    "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "16",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "8000",
    "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
    "NUM_PROCESSES", "3",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "4",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "32",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", "4",
]
LOADS = "loads"  # the case sets up a tiny world and merges the checkpoint


class _PastTheChecks(Exception):
    pass


def _setup(tmp_path, monkeypatch, opts, loads=False):
    """Run _setup until it would build the env, or (``loads``) all of it on
    a tiny world."""
    def stop(*args, **kwargs):
        raise _PastTheChecks

    if not loads:
        monkeypatch.setattr(savi, "construct_batched_env", stop)
    missing = str(tmp_path / "missing.pth")
    critic = {"kernel": np.full((32, 1), 0.25, np.float32), "bias": np.full((1,), -0.5, np.float32)}
    existing = save_checkpoint(str(tmp_path), "ckpt.pth", {"state_dict": {"params": {"critic": {"Dense_0": critic}}}})
    opts = [existing if o == "EXISTING" else missing if o == "MISSING" else o for o in opts]
    tr = savi.SaviTrainer(get_config(SAVI, opts=(TINY + opts) if loads else opts), device="cpu")
    tr._setup()
    return tr


@pytest.mark.parametrize("opts,raises", [
    # DDPPO's weights are chosen: the SMT path is never read in JAX
    (["RL.DDPPO.pretrained", "True", "RL.DDPPO.pretrained_weights", "EXISTING",
      "RL.PPO.SCENE_MEMORY_TRANSFORMER.pretrained_path", "MISSING"], LOADS),
    # a DDPPO path without DDPPO.pretrained, or no SMT path: nothing to load
    (["RL.DDPPO.pretrained_weights", "MISSING"], _PastTheChecks),
    (["RL.DDPPO.pretrained", "True", "RL.PPO.SCENE_MEMORY_TRANSFORMER.use_pretrained", "False",
      "RL.PPO.SCENE_MEMORY_TRANSFORMER.pretrained_path", "MISSING"], _PastTheChecks),
    # the belief path without the belief predictor is never read
    (["RL.PPO.use_belief_predictor", "False", "RL.PPO.BELIEF_PREDICTOR.pretrained_path", "MISSING"],
     _PastTheChecks),
    # what JAX reads and cannot find
    (["RL.PPO.BELIEF_PREDICTOR.pretrained_path", "MISSING"], FileNotFoundError),
    (["RL.PPO.SCENE_MEMORY_TRANSFORMER.pretrained_path", "MISSING"], FileNotFoundError),
    (["RL.DDPPO.pretrained", "True", "RL.PPO.SCENE_MEMORY_TRANSFORMER.pretrained_path", "MISSING"],
     FileNotFoundError),
    (["RL.PPO.SCENE_MEMORY_TRANSFORMER.pretrained_path", "EXISTING"], LOADS),
    (["TPU.PRECISION", "bfloat16"], _PastTheChecks),
    (["TPU.PRECISION", "int8"], ValueError),
    (["RL.PPO.SCENE_MEMORY_TRANSFORMER.batched_eval", "False"], _PastTheChecks),
])
def test_setup_reads_the_paths_jax_reads(tmp_path, monkeypatch, opts, raises):
    if raises == LOADS:
        tr = _setup(tmp_path, monkeypatch, opts, loads=True)
        assert tr.pretrained_counts == (2, 2)  # the critic's leaves; action_head and net kept fresh
        np.testing.assert_array_equal(tr.policy.critic.Dense_0.weight.detach().numpy(), np.full((1, 32), 0.25))
        assert torch.equal(tr.policy.critic.Dense_0.bias, torch.tensor([-0.5]))
        return
    with pytest.raises(raises):
        _setup(tmp_path, monkeypatch, opts)
