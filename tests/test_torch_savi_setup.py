"""``SaviTrainer._setup`` of the port chooses the pretrained weights as the
JAX trainer does (avlen_tpu/rl/trainers/savi.py:104-145): DDPPO's
``pretrained_weights`` when DDPPO.pretrained is on, else the SMT
``pretrained_path``; the belief predictor's path only under
use_belief_predictor. A chosen path that does not exist raises
FileNotFoundError as in JAX; one that exists raises NotImplementedError
until checkpoint loading is ported; a path JAX never reads raises nothing.
Also: a precision other than float32 is refused, not run in float32, and
so is the sequential ring replay (``batched_eval`` off), which no config
asks for."""

import pytest

from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.rl.trainers import savi

SAVI = "configs/semantic_audionav/savi/savi.yaml"


class _PastTheChecks(Exception):
    pass


def _setup(tmp_path, monkeypatch, opts):
    """Run _setup until it would build the env."""
    def stop(*args, **kwargs):
        raise _PastTheChecks

    monkeypatch.setattr(savi, "construct_batched_env", stop)
    missing = str(tmp_path / "missing.pth")
    existing = tmp_path / "ckpt.pth"
    existing.write_bytes(b"")
    opts = [str(existing) if o == "EXISTING" else missing if o == "MISSING" else o for o in opts]
    savi.SaviTrainer(get_config(SAVI, opts=opts), device="cpu")._setup()


@pytest.mark.parametrize("opts,raises", [
    # DDPPO's weights are chosen: the SMT path is never read in JAX
    (["RL.DDPPO.pretrained", "True", "RL.DDPPO.pretrained_weights", "EXISTING",
      "RL.PPO.SCENE_MEMORY_TRANSFORMER.pretrained_path", "MISSING"], NotImplementedError),
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
    (["RL.PPO.SCENE_MEMORY_TRANSFORMER.pretrained_path", "EXISTING"], NotImplementedError),
    (["TPU.PRECISION", "bfloat16"], NotImplementedError),
    (["RL.PPO.SCENE_MEMORY_TRANSFORMER.batched_eval", "False"], NotImplementedError),
])
def test_setup_reads_the_paths_jax_reads(tmp_path, monkeypatch, opts, raises):
    with pytest.raises(raises):
        _setup(tmp_path, monkeypatch, opts)
