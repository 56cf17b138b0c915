"""``InteractiveDDPPOTrainer`` of the port (avlen_tpu_torch/rl/trainers/
interactive.py) on a tiny world of savi_interactive_1st_stage.yaml with the
template speaker (no speaker checkpoint ships): ``_setup`` builds the
instruction bank, the three policies and the belief predictor, and a short
collect gives finite values and log-probs. As in the JAX trainer, GOAL_CKPT_PATH,
VLN_CKPT_PATH and the belief predictor's ``pretrained_path`` load (whole
state dicts, files the JAX package writes) exactly when the file exists and
are skipped otherwise; the goal checkpoint here is a SAVi trainer's policy,
which TRAINER_NAME ddppo with ``policy_type`` smt gives. ``update`` on
the collect trains π_q alone in stage 1 (no REPLAY_STORE); the training
loop, eval and dialog pretraining have files of their own
(tests/test_torch_interactive_{train,eval,update}.py,
tests/test_torch_dialog_pretrain.py)."""

import numpy as np
import pytest
import torch

from avlen_tpu.utils import checkpoint as jckpt
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.core.registry import registry
from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer
from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
from avlen_tpu_torch.utils.flax_bridge import _flatten, to_flax_params

torch.set_num_threads(1)

STAGE1 = "configs/semantic_audionav/savi/savi_interactive_1st_stage.yaml"
SAVI = "configs/semantic_audionav/savi/savi.yaml"
WORLD = [  # a world of 4 x 4 nodes, 3 envs, d_model 32
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
TINY = WORLD + ["RL.PPO.CLIP_WIDTH", "64", "RL.PPO.CLIP_LAYERS", "2", "SPEAKER.BACKEND", "template"]


def _trainer(opts=(), config=STAGE1):
    return InteractiveDDPPOTrainer(get_config(config, opts=TINY + list(opts)), device="cpu")


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """A trainer whose three configured paths do not exist, after one collect."""
    missing = str(tmp_path_factory.mktemp("none") / "missing.pth")
    tr = _trainer(["GOAL_CKPT_PATH", missing, "VLN_CKPT_PATH", missing,
                   "RL.PPO.BELIEF_PREDICTOR.pretrained_path", missing, "QS_METHOD", "never"])
    tr._setup()
    carry, traj = tr.collect(n=8)
    return tr, carry, traj


def test_setup_and_collect(fresh):
    tr, carry, traj = fresh
    assert tr.loaded == {}
    n = max(t.num_nodes for t in tr.env.scene_tables)
    assert tuple(tr.instr_bank.shape) == (2, n, 4, n, 77) and tr.instr_bank.dtype == torch.int32
    assert tr.bank_bytes == 2 * n * 4 * n * 77 * 4 and tr.bank_seconds > 0
    assert (tr.feat_goal_size, tr.feat_option_size) == (276, 308)
    assert traj["actions"].shape == (8, 3) and traj["dialog_clip"].shape == (8, 3, 512)
    for k in ("values_option", "log_probs_option", "rewards", "logits_vln", "feat_vln_dialog", "dialog_clip",
              "bootstrap_value"):
        assert torch.isfinite(traj[k]).all(), k
    starts = int((traj["queried"] & (traj["rl_mask"] == 1)).any(dim=1).sum())
    assert tr.clip_calls == starts
    assert carry.mem_option.features.shape == (3, 4, 308)
    assert carry.mem_vln_dialog.features.shape == (3, tr.config.NUM_DIALOG_STEPS, 32)
    # the trainer's carry advanced; an explicit carry leaves it
    assert tr.carry is carry
    tr.collect(carry=carry, n=2)
    assert tr.carry is carry


def test_eval_collect_takes_the_configured_query_strategy(fresh):
    """deterministic=True is eval mode: QS_METHOD (here never) replaces π_q's
    choice, as the JAX trainer's collect does (ppo_trainer.py:1333-1356)."""
    tr, carry, _ = fresh
    _, traj = tr.collect(carry=carry, deterministic=True, n=6)
    # windows open in the carry run out; no query starts
    assert not (traj["queried"] & (traj["rl_mask"] == 1)).any()
    assert not traj["queried"][3:].any()


@pytest.fixture(scope="module")
def delegating():
    """TRAINER_NAME ddppo on savi.yaml (policy_type smt), set up."""
    tr = registry.get_trainer("ddppo")(get_config(SAVI, opts=WORLD + ["TRAINER_NAME", "ddppo", "SEED", "5"]),
                                       device="cpu")
    tr._setup()
    return tr


def test_ddppo_with_smt_delegates_to_savi(delegating):
    assert type(delegating) is SaviTrainer and delegating.memory_size == 4
    stage1 = registry.get_trainer("ddppo")(get_config(STAGE1, opts=TINY), device="cpu")
    assert type(stage1) is InteractiveDDPPOTrainer


@pytest.fixture(scope="module")
def loaded(fresh, delegating, tmp_path_factory):
    """Checkpoints written by the JAX package: the SAVi trainer's policy as
    π_g, π_l and the belief predictor of ``fresh`` perturbed; then a trainer
    set up from them."""
    tr, _, _ = fresh
    d = tmp_path_factory.mktemp("ckpts")
    trees = {
        "goal": to_flax_params(delegating.policy),
        "dialog": to_flax_params(tr.dialog_policy, {n: p + 0.25 for n, p in tr.dialog_policy.named_parameters()}),
        "belief": to_flax_params(tr.belief_net, {n: p - 0.5 for n, p in tr.belief_net.named_parameters()}),
    }
    paths = {k: jckpt.save_checkpoint(str(d), f"{k}.pth", {"state_dict": v}) for k, v in trees.items()}
    tr2 = _trainer(["GOAL_CKPT_PATH", paths["goal"], "VLN_CKPT_PATH", paths["dialog"],
                    "RL.PPO.BELIEF_PREDICTOR.pretrained_path", paths["belief"]])
    tr2._setup()
    return tr2, trees, paths


def test_checkpoints_load_whole_where_they_exist(loaded):
    tr, trees, paths = loaded
    assert tr.loaded == paths
    for key, module in (("goal", tr.goal_policy), ("dialog", tr.dialog_policy), ("belief", tr.belief_net)):
        got, want = _flatten(to_flax_params(module)), _flatten(trees[key])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{key}: {k}")
    _, traj = tr.collect(n=3)
    assert torch.isfinite(traj["values_option"]).all()


def test_update_trains_pi_q_on_the_collect(fresh):
    """Last in the file: it moves π_q's parameters."""
    tr, _, traj = fresh
    before = {n: p.detach().clone() for n, p in tr.option_policy.named_parameters()}
    stats = tr.update(traj)
    assert set(stats) == {"value_loss", "action_loss", "entropy", "unct_loss"}  # no REPLAY_STORE in stage 1
    assert all(torch.isfinite(v) for v in stats.values())
    assert tr.optimizer_q.count == 2 * 2 and not tr.optimizer_l.state
    moved = {n.split(".")[0] for n, p in tr.option_policy.named_parameters() if not torch.equal(p, before[n])}
    assert moved == {"net", "action_head", "critic", "uncertainty"}
