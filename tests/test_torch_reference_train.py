"""The port's AV-Nav and SAVi trainers train from reference-format data on
the CPU: each, taken from the trainer registry at tiny widths over a copy
of the fixture tree tests/data/reference_tree with every RIR served by the
host store (``DENSE_RIR_MAX_BYTES 0``, the spectrogram bank off, so each
step renders through the time-domain audio path), collects a rollout with
non-silent spectrograms and takes one update with finite parameters that
moved. Also: SAVi's update with the sequential ring replay
(``SCENE_MEMORY_TRANSFORMER.batched_eval False``) equals the batched one on
the same batch and minibatch indices (losses, the gradients each Adam
holds and the parameters within 1e-5)."""

import numpy as np
import pytest
import torch

from avlen_tpu_torch import run
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.data.reference import HostRIRStore
from avlen_tpu_torch.rl.ppo import make_optimizer
from chip_smoke import adam_gradients
from tests.test_torch_reference_env import copy_fixture, reference_opts

torch.set_num_threads(1)

AVNAV = "configs/audionav/av_nav/audiogoal_depth.yaml"
SAVI = "configs/semantic_audionav/savi/savi.yaml"
HOST = [
    "TASK_CONFIG.SIMULATOR.AUDIO.DENSE_RIR_MAX_BYTES", "0",
    "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
    "RL.PPO.num_steps", "8",
    "RL.PPO.num_mini_batch", "2",
    "RL.PPO.ppo_epoch", "2",
]
TINY = {
    "AVNavTrainer": ("RL.PPO.hidden_size", "32"),
    "savi": ("RL.PPO.hidden_size", "32",
             "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "32",
             "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "4",
             "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", "2",
             "RL.PPO.SCENE_MEMORY_TRANSFORMER.use_pretrained", "False"),
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return copy_fixture(tmp_path_factory.mktemp("reference"))


def trainer(tree, name: str, yaml: str):
    cfg = get_config(yaml, opts=reference_opts(tree, HOST + list(TINY[name])))
    tr = run.registry.get_trainer(name)(cfg, device="cpu")
    tr._setup()
    assert isinstance(tr.env.bank.rir, HostRIRStore)
    assert tr.env.bank.spec_bank is None
    return tr


def _params(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def trains_once(tr, perms):
    before = _params(tr.policy)
    _, batch = tr.collect()
    spec = batch.obs["spectrogram"]
    assert torch.isfinite(spec).all() and float(spec.abs().sum()) > 0
    stats = tr.update(batch, perms=perms)
    for k, v in stats.items():
        assert torch.isfinite(v).all(), k
    after = _params(tr.policy)
    for n, p in after.items():
        assert torch.isfinite(p).all(), n
    assert any(not torch.equal(p, before[n]) for n, p in after.items())
    return batch


def test_avnav_trains_from_reference_tree(tree):
    tr = trainer(tree, "AVNavTrainer", AVNAV)
    trains_once(tr, perms=[np.array([1, 0]), np.array([0, 1])])


def test_savi_trains_from_reference_tree_and_replays_the_ring_either_way(tree):
    tr = trainer(tree, "savi", SAVI)
    batch = trains_once(tr, perms=[np.array([1, 0]), np.array([0, 1])])
    smt = tr.config.RL.PPO.SCENE_MEMORY_TRANSFORMER
    assert smt.batched_eval and smt.memory_size < tr.num_steps  # the ring wraps within the rollout
    assert (batch.masks == 0).any()  # and an episode ends inside it

    # one update with the batched re-evaluation and one with the sequential
    # replay, from the same parameters, batch and minibatch indices
    tr.belief_optimizer = None
    start = _params(tr.policy)
    perms = [np.array([0, 1]), np.array([1, 0])]
    runs = []
    for batched in (True, False):
        tr.config.defrost()
        smt.batched_eval = batched
        tr.config.freeze()
        with torch.no_grad():
            for n, p in tr.policy.named_parameters():
                p.copy_(start[n])
        tr.optimizer = make_optimizer(tr.policy.parameters(), tr.ppo_cfg)
        stats = tr.update(batch, perms=perms)
        runs.append((stats, adam_gradients(tr.policy, tr.optimizer.adam), _params(tr.policy)))
    (s_on, g_on, p_on), (s_off, g_off, p_off) = runs
    assert set(s_on) == set(s_off) == {"value_loss", "action_loss", "entropy"}
    for k in s_on:
        np.testing.assert_allclose(s_off[k].item(), s_on[k].item(), atol=1e-5, rtol=0, err_msg=k)
    live = 0
    for n in g_on:
        np.testing.assert_allclose(g_off[n].numpy(), g_on[n].numpy(), atol=1e-5, rtol=0, err_msg=f"gradient {n}")
        np.testing.assert_allclose(p_off[n].numpy(), p_on[n].numpy(), atol=1e-5, rtol=0, err_msg=f"parameter {n}")
        live += int(g_on[n].abs().max() > 1e-4)
    assert live >= 8
