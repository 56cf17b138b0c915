"""AVLEN's update on the port against the JAX package on the CPU:
``InteractiveDDPPOTrainer.update`` (GAE → ``ppo_update_interactive`` →
π_l's replay CE, savi_interactive_2nd_stage.yaml's REPLAY_STORE) on a
port-collected trajectory of a tiny world, with real ``OptionPolicy`` /
``DialogPolicy`` weights (π_l without the RGB-D towers and π_q with the
depth tower only, so that the JAX gradients compile quickly) carried to the
JAX modules through the bridge: losses 1e-5, the gradients each Adam's
first moment holds 5e-4 + 1e-3·|g|, parameters 1e-5 (PERF.md §2). One
optimizer step each (ppo_epoch 1, num_mini_batch 1), so that JAX compiles
one gradient of each policy (~15 s for π_q's): the epochs and minibatches
with JAX's permutations are held by tests/test_torch_ppo_interactive.py,
and π_l's pretraining CE (every step, not only the queried ones) there
too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avlen_tpu.models.dialog_policy import AudioNavDialogNet as JaxDialogNet
from avlen_tpu.models.dialog_policy import DialogPolicy as JaxDialogPolicy
from avlen_tpu.models.memory import SMTMemory as JaxMemory
from avlen_tpu.models.option_policy import AudioNavOptionNet as JaxOptionNet
from avlen_tpu.models.option_policy import OptionPolicy as JaxOptionPolicy
from avlen_tpu.rl import ppo as jppo
from avlen_tpu.rl import ppo_interactive as jpi
from avlen_tpu.rl.gae import compute_gae as jax_gae
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.models.dialog_policy import AudioNavDialogNet, DialogPolicy
from avlen_tpu_torch.models.memory import SMTMemory
from avlen_tpu_torch.models.option_policy import AudioNavOptionNet, OptionPolicy
from avlen_tpu_torch.rl import ppo
from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer
from avlen_tpu_torch.utils.flax_bridge import to_flax_params
from chip_smoke import adam_gradients
from tests.test_torch_slice import _adam_gradients, _pairs

torch.set_num_threads(1)

STAGE2 = "configs/semantic_audionav/savi/savi_interactive_2nd_stage.yaml"


def _run_jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_llvm_disable_expensive_passes": True})(*args)


TINY = [
    "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4", "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "20",
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "2000", "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "16",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "8000", "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
    "NUM_PROCESSES", "3", "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "4",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "32", "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", "4",
    "RL.PPO.CLIP_WIDTH", "32", "RL.PPO.CLIP_LAYERS", "1", "SPEAKER.BACKEND", "template",
    "GOAL_CKPT_PATH", "", "VLN_CKPT_PATH", "", "RESUME_CHECKPOINT", "False",
    "RL.PPO.ppo_epoch", "1", "RL.PPO.num_mini_batch", "1",
]
T_UPDATE = 8


def _towers_free(tr):
    """The trainer's three policies rebuilt without the RGB tower, π_g and
    π_l without the depth tower either (real modules, port init), its
    optimizers and carry made anew for them."""
    cfg = tr.config
    common = dict(spectrogram_hw=tr.env.spec_config.out_shape[:2], num_actions=4, d_model=32, nhead=4,
                  use_rgb=False, use_depth=False,
                  pretraining=cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER.pretraining)
    g = torch.Generator().manual_seed(4)
    from avlen_tpu_torch.models.smt_policy import AudioNavSMTNet, SMTPolicy

    tr.goal_policy = SMTPolicy(AudioNavSMTNet(use_belief_as_goal=True, generator=g, **common), generator=g).eval()
    tr.dialog_policy = DialogPolicy(AudioNavDialogNet(clip_width=32, clip_layers=1, generator=g, **common),
                                    generator=g).eval()
    # π_q's net always runs its visual encoder (as JAX's does): the depth tower only
    tr.option_policy = OptionPolicy(AudioNavOptionNet(query_count_emb_size=cfg.QUERY_COUNT_EMB_SIZE, generator=g,
                                                      **dict(common, use_depth=True)), generator=g).eval()
    tr.feat_goal_size, tr.feat_option_size = tr.goal_policy.net.feature_size, tr.option_policy.net.feature_size
    tr.optimizer_q = ppo.make_optimizer(tr.option_policy.parameters(), tr.ppo_cfg)
    tr.optimizer_l = torch.optim.Adam(tr.dialog_policy.parameters(), lr=1e-5, eps=tr.ppo_cfg.eps)
    tr.carry = tr.reset()
    return common


def _to_jax(x):
    if isinstance(x, dict):
        return {k: _to_jax(v) for k, v in x.items()}
    if isinstance(x, SMTMemory):
        return JaxMemory(*(_to_jax(v) for v in x))
    if isinstance(x, tuple):
        return tuple(_to_jax(v) for v in x)
    a = x.numpy()
    return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)


@pytest.fixture(scope="module")
def trained():
    """One port update from the same start as JAX's."""
    tr = InteractiveDDPPOTrainer(get_config(STAGE2, opts=TINY), device="cpu")
    tr._setup()
    common = _towers_free(tr)
    cfg = tr.config
    jopt_net = JaxOptionPolicy(net=JaxOptionNet(query_count_emb_size=cfg.QUERY_COUNT_EMB_SIZE,
                                                **dict(common, use_depth=True)))
    jdlg_net = JaxDialogPolicy(net=JaxDialogNet(clip_width=32, clip_layers=1, **common))
    # copies: a numpy view of a torch parameter would let JAX read the
    # port's in-place update
    p_opt, p_dlg = (jax.tree.map(np.array, to_flax_params(m)) for m in (tr.option_policy, tr.dialog_policy))

    _, traj = tr.collect(n=T_UPDATE)
    jtraj = _to_jax({k: v for k, v in traj.items() if k != "metrics"})
    key = jax.random.key(9)
    perms = [np.array(jax.random.permutation(jax.random.split(key)[1], 3))]

    jcfg = jppo.PPOConfig(**dataclasses.asdict(tr.ppo_cfg))
    chunk = cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER.batched_eval_chunk

    def step_q(p, *a):
        return jopt_net.apply(p, *a, method=JaxOptionPolicy.evaluate_step)

    def step_l(p, obs, pa, mf, mv, smf, smv, dialog, step, actions, dclip=None):
        return jdlg_net.apply(p, obs, pa, mf, mv, smf, smv, dialog, step, actions,
                              dialog_clip=None if dclip is not None and dclip.shape[-1] == 0 else dclip,
                              method=JaxDialogPolicy.evaluate_step)

    def jax_update(po, pd, t):
        adv, ret = jax_gae(t["rewards"], t["values_option"], t["bootstrap_value"],
                           1.0 - t["dones"].astype(jnp.float32), jcfg.gamma, jcfg.tau)
        opt_q, opt_l = jppo.make_optimizer(jcfg), optax.adam(1e-5, eps=jcfg.eps)
        po2, sq, stats = jpi.ppo_update_interactive(po, opt_q.init(po), t, adv, ret, key, step_q, opt_q, jcfg,
                                                    unct_coef=cfg.RL.PPO.unct_coef, batched_chunk=chunk)
        pd2, sl, dloss = jpi.dialog_supervised_update(pd, opt_l.init(pd), t, step_l, opt_l, replay_only=True,
                                                      batched_chunk=chunk)
        return po2, sq, dict(stats, dialog_loss=dloss), pd2, sl

    want = jax.block_until_ready(_run_jit(jax_update, p_opt, p_dlg, jtraj))

    stats = tr.update(traj, perms=perms)
    got_q = (dict(tr.option_policy.named_parameters()), adam_gradients(tr.option_policy, tr.optimizer_q.adam))
    got_l = (dict(tr.dialog_policy.named_parameters()), adam_gradients(tr.dialog_policy, tr.optimizer_l))
    return tr, traj, stats, got_q, got_l, want


def test_update_losses_match_jax(trained):
    tr, traj, stats, _, _, want = trained
    jstats = want[2]
    assert set(stats) == set(jstats) == {"value_loss", "action_loss", "entropy", "unct_loss", "dialog_loss"}
    for k in jstats:
        np.testing.assert_allclose(stats[k].item(), float(jstats[k]), atol=1e-5, rtol=0, err_msg=k)
    assert tr.optimizer_q.count == tr.ppo_cfg.ppo_epoch * tr.ppo_cfg.num_mini_batch
    # the trajectory exercised both heads: queries and π_l's replay steps
    assert traj["queried"].any() and (traj["rl_mask"] == 0).any()


@pytest.mark.parametrize("which", ["option", "dialog_replay"])
def test_update_gradients_and_parameters_match_jax(trained, which):
    _, _, _, got_q, got_l, want = trained
    (params, grads), jparams, jstate = {
        "option": (got_q, want[0], want[1]),
        "dialog_replay": (got_l, want[3], want[4]),
    }[which]
    live = 0
    for name, got, w in _pairs(grads, _adam_gradients(jstate)):
        np.testing.assert_allclose(got, w, atol=5e-4, rtol=1e-3, err_msg=f"gradient {name}")
        live += int(np.abs(w).max() > 1e-4)
    assert live > 10
    clip_grads = [name for name, g in grads.items() if name.startswith("net.clip.") and g.abs().max() > 0]
    assert not clip_grads  # the frozen tower
    for name, got, w in _pairs(params, jparams):
        np.testing.assert_allclose(got, w, atol=1e-5, rtol=0, err_msg=name)
