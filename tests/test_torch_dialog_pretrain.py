"""π_l pretraining on the port (DIALOG_TRAINING), on the CPU.

* The env's no-query step: ``env.step(state, a, None)`` equals JAX's
  ``_step_impl_noquery`` on a world whose reward takes the query terms.
* ``collect_rollout_dialog_pretrain`` against JAX's with stub π_l and CLIP
  callables on the same world, with and without dataset ``sub_instr``
  rows: every integer and float of the trajectory equal (the port runs the
  CLIP stub where a window starts only; JAX every step).
* ``run.main`` trains savi_pretraining_dialog_training.yaml on a tiny world
  (finite CE, ``vln/ckpt.N.pth`` holding π_l's Flax tree and the config,
  as the JAX trainer writes it) and evals the checkpoint under the dialog
  protocol: π_l's action accuracy and CE against the oracle over the split's
  episodes, each once; the checkpoint loads as π_l and never as π_q."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from avlen_tpu.core.episodes import pack_episodes
from avlen_tpu.models.belief_predictor import init_belief_state as jax_init_belief_state
from avlen_tpu.models.memory import init_memory as jax_init_memory
from avlen_tpu.rl import rollout_interactive as jri
from avlen_tpu.sim.env import BatchedAudioNavEnv as JaxEnv
from avlen_tpu.sim.env import EnvConfig as JaxEnvConfig
from avlen_tpu.sim.env import RewardConfig as JaxRewardConfig
from avlen_tpu.sim.synthetic import make_episodes, make_scene_bank
from avlen_tpu_torch import run
from avlen_tpu_torch.models.belief_predictor import init_belief_state
from avlen_tpu_torch.models.memory import init_memory
from avlen_tpu_torch.rl import rollout_interactive as ri
from avlen_tpu_torch.sim.env import BatchedAudioNavEnv, EnvConfig, RewardConfig
from avlen_tpu_torch.utils.checkpoint import load_checkpoint
from avlen_tpu_torch.utils.flax_bridge import _flatten, scene_bank_from_jax, to_flax_params
from avlen_tpu_torch.utils.tb import read_scalars

torch.set_num_threads(1)

B, FEAT, WINDOW, T_STEPS, CLIP_W = 2, 8, 3, 14, 6


def _run_jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_llvm_disable_expensive_passes": True})(*args)


@pytest.fixture(scope="module")
def world():
    bank, tables = make_scene_bank(np.random.RandomState(0), num_scenes=1, side=6, rir_length=200,
                                   sampling_rate=2000, with_frames=False)
    eps = make_episodes(np.random.RandomState(1), tables, 8, min_hops=3, max_hops=8)
    packed = pack_episodes(eps, num_envs=B)
    reward = dict(with_query_constraint=True, num_total_query=5, query_reward=-0.2,
                  consecutive_constraint_reward=True)
    jenv = JaxEnv(bank, packed, JaxEnvConfig(max_episode_steps=50, sensors=("spectrogram", "pose"),
                                              reward=JaxRewardConfig(**reward)))
    tenv = BatchedAudioNavEnv(scene_bank_from_jax(bank, "cpu"), packed,
                              EnvConfig(max_episode_steps=50, sensors=("spectrogram", "pose"),
                                        reward=RewardConfig(**reward)))
    n = tables[0].num_nodes
    bank_np = np.tile(np.arange(1, n * 4 * n + 1).reshape(1, n, 4, n, 1).astype(np.int32), (1, 1, 1, 1, 77))
    num_eps = int(np.asarray(jenv.eps["scene"]).shape[0])
    sub = np.zeros((num_eps, 77), np.int32)
    sub[::2] = 10_000 + np.arange(0, num_eps, 2)[:, None]  # every other episode carries a dataset instruction
    return jenv, tenv, bank_np, sub


def test_noquery_step_matches_jax(world):
    jenv, tenv, _, _ = world
    jstate, _ = jenv.reset()
    tstate, _ = tenv.reset()
    step = jax.jit(jenv._step_impl_noquery)
    ends = 0
    for t in range(16):
        a = tenv.oracle_action(tstate)
        np.testing.assert_array_equal(a.numpy(), np.asarray(jenv.oracle_action(jstate)))
        jstate, jout = step(jstate, jnp.asarray(a.numpy(), jnp.int32))
        tstate, tout = tenv.step(tstate, a, None)
        np.testing.assert_array_equal(tout.done.numpy(), np.asarray(jout.done))
        np.testing.assert_allclose(tout.reward.numpy(), np.asarray(jout.reward), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(tout.obs["pose"].numpy(), np.asarray(jout.obs["pose"]))
        np.testing.assert_allclose(tout.obs["spectrogram"].numpy(), np.asarray(jout.obs["spectrogram"]),
                                   atol=2e-3, rtol=0)
        for f in ("node", "rot", "ep_i", "step_count"):
            np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)), err_msg=f)
        ends += int(tout.done.sum())
    assert ends > 0


# stub π_l: scales are powers of two, so that a fused multiply-add rounds as
# a multiply and an add do and both packages' floats agree bit for bit
def _jax_act_dialog(obs, pa, mf, mv, smf, smv, dialog, step, key, dclip=None):
    x = jnp.concatenate([obs["pose"], obs["pose"] * 0.5], -1)
    mem = (mf * mv[..., None]).sum(1)
    smem = (smf * smv[..., None]).sum(1)
    extra = dclip[:, :1] if dclip is not None else jnp.zeros_like(x[:, :1])
    logits = jnp.concatenate([mem[:, :1], smem[:, 1:2], dialog[:, :1].astype(jnp.float32) * 0.0078125 + extra,
                              step[:, None].astype(jnp.float32)], -1)
    x_att = x * 0.25 + smem
    b = x.shape[0]
    return jnp.zeros((b,), jnp.int32), jnp.zeros((b,)), jnp.zeros((b,)), x, x_att, logits


def _port_act_dialog(obs, pa, mf, mv, smf, smv, dialog, step, dclip=None):
    x = torch.cat([obs["pose"], obs["pose"] * 0.5], -1)
    mem = (mf * mv[..., None]).sum(1)
    smem = (smf * smv[..., None]).sum(1)
    extra = dclip[:, :1] if dclip is not None else torch.zeros_like(x[:, :1])
    logits = torch.cat([mem[:, :1], smem[:, 1:2], dialog[:, :1].float() * 0.0078125 + extra, step[:, None].float()], -1)
    x_att = x * 0.25 + smem
    b = x.shape[0]
    return torch.zeros(b, dtype=torch.long), torch.zeros(b), torch.zeros(b), x, x_att, logits


@pytest.mark.parametrize("with_sub_instr", [False, True])
def test_dialog_pretrain_rollout_equals_jax(world, with_sub_instr):
    jenv, tenv, bank_np, sub = world
    state, obs = jenv.reset()
    carry = jri.InteractiveCarry(
        env_state=state, obs=obs, prev_action=jnp.zeros((B,), jnp.int32),
        masks=jnp.zeros((B,), jnp.float32), masks_vln=jnp.zeros((B,), jnp.float32),
        mem_goal=jax_init_memory(B, 4, FEAT), mem_option=jax_init_memory(B, 4, FEAT),
        mem_vln=jax_init_memory(B, WINDOW, FEAT), mem_vln_dialog=jax_init_memory(B, WINDOW, FEAT),
        belief=jax_init_belief_state(B), track=jri.init_query_track(B, clip_width=CLIP_W), key=jax.random.key(0))

    def jclip(tokens):
        return jnp.tile(tokens[:, :1].astype(jnp.float32) * 0.0009765625, (1, CLIP_W))

    jsub = jnp.asarray(sub) if with_sub_instr else None
    _, jtraj = _run_jit(lambda c, bank: jri.collect_rollout_dialog_pretrain(
        _jax_act_dialog, jenv._step_impl_noquery, jenv.oracle_action, None, c, bank, WINDOW, T_STEPS,
        sub_instr_bank=jsub, clip_embed=jclip), carry, jnp.asarray(bank_np))

    tstate, tobs = tenv.reset()
    tcarry = ri.InteractiveCarry(
        env_state=tstate, obs=tobs, prev_action=torch.zeros(B, dtype=torch.long), masks=torch.zeros(B),
        masks_vln=torch.zeros(B), mem_goal=init_memory(B, 4, FEAT, device="cpu"),
        mem_option=init_memory(B, 4, FEAT, device="cpu"), mem_vln=init_memory(B, WINDOW, FEAT, device="cpu"),
        mem_vln_dialog=init_memory(B, WINDOW, FEAT, device="cpu"), belief=init_belief_state(B, device="cpu"),
        track=ri.init_query_track(B, clip_width=CLIP_W, device="cpu"))
    calls = []

    def tclip(tokens):
        calls.append(1)
        return tokens[:, :1].float().mul(0.0009765625).repeat(1, CLIP_W)

    _, traj = ri.collect_rollout_dialog_pretrain(
        _port_act_dialog, lambda s, a: tenv.step(s, a, None), tenv.oracle_action, None, tcarry,
        torch.as_tensor(bank_np), WINDOW, T_STEPS,
        sub_instr_bank=torch.as_tensor(sub) if with_sub_instr else None, clip_embed=tclip)

    for k in ("o_action", "dones", "agent_step", "masks_vln", "dialog", "queried", "o_mask"):
        np.testing.assert_array_equal(traj[k].numpy(), np.asarray(jtraj[k]).astype(traj[k].numpy().dtype),
                                      err_msg=k)
    np.testing.assert_array_equal(traj["obs"]["__prev_action"].numpy(), np.asarray(jtraj["obs"]["__prev_action"]))
    for k in ("logits_vln", "feat_vln", "feat_vln_dialog", "dialog_clip"):
        np.testing.assert_array_equal(traj[k].numpy(), np.asarray(jtraj[k]), err_msg=k)
    np.testing.assert_array_equal(traj["metrics"]["success"].numpy(), np.asarray(jtraj["metrics"]["success"]))
    assert traj["dones"].any() and traj["masks_vln"].eq(0).sum() > traj["dones"].sum()
    starts = traj["agent_step"].eq(0).any(dim=1).sum().item()
    assert len(calls) == starts < T_STEPS  # the tower runs where some window starts only
    from_ds = (traj["dialog"][..., 0] >= 10_000).any().item()
    assert from_ds == with_sub_instr


DIALOG = "configs/semantic_audionav/savi/savi_pretraining_dialog_training.yaml"
TINY = [
    "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4", "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "8",
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "2000", "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "16",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "8000", "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "32", "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", "4",
    "RL.PPO.CLIP_WIDTH", "32", "RL.PPO.CLIP_LAYERS", "1", "SPEAKER.BANK_MODE", "callback", "LOG_INTERVAL", "1",
    "VIDEO_OPTION", "[]", "EVAL.SPLIT", "train",
]


@pytest.fixture(scope="module")
def dialog_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dialog")
    try:
        main = ["--exp-config", DIALOG, "--model-dir", str(d), "--device", "cpu", *TINY]
        trained = run.main(["--run-type", "train", *main, "NUM_UPDATES_DIALOG", "2", "CHECKPOINT_INTERVAL_DIALOG", "1"])
        ckpts = sorted(os.listdir(d / "data" / "vln"))
        path = str(d / "data" / "vln" / "ckpt.1.pth")
        evaluated = run.main(["--run-type", "eval", *main, "EVAL_CKPT_PATH_DIR", path])
        yield trained, ckpts, load_checkpoint(path), evaluated, read_scalars(str(d / "tb"))
    finally:
        shutil.rmtree(d, ignore_errors=True)


def test_dialog_training_writes_the_vln_checkpoint(dialog_runs):
    trained, ckpts, ckpt, _, scalars = dialog_runs
    assert trained.dialog_mode and trained.num_updates_done == 2
    assert trained.num_steps_done == 2 * 3 * 8  # updates x num_steps x NUM_PROCESSES
    assert len(trained.dialog_losses) == 2 and all(np.isfinite(trained.dialog_losses))
    assert [v for _, v in scalars["Policy/dialog_loss"]] == pytest.approx(trained.dialog_losses)
    assert ckpts == ["ckpt.0.pth", "ckpt.1.pth"]  # every update
    assert set(ckpt) == {"state_dict", "config"}
    assert _flatten(ckpt["state_dict"]).keys() == _flatten(to_flax_params(trained.dialog_policy)).keys()
    assert trained.optimizer_l.state and trained.optimizer_q.count == 0  # π_l trained, π_q not


def test_dialog_eval_reports_accuracy_and_loads_pi_l_only(dialog_runs):
    trained, _, ckpt, evaluated, scalars = dialog_runs
    ids = evaluated._last_eval_episode_ids
    assert len(ids) == len(set(ids)) == int(evaluated.env.eps["scene"].shape[0])
    acc, ce = scalars["val_dialog/action_accuracy"][0][1], scalars["val_dialog/action_ce"][0][1]
    assert 0.0 <= acc <= 1.0 and np.isfinite(ce) and ce > 0
    assert scalars["val_dialog/episodes_evaluated"] == [(0, float(len(ids)))]
    # the vln checkpoint is π_l: loaded there exactly, π_q left at its init
    assert chip_smoke._max_tree_diff(to_flax_params(evaluated.dialog_policy), ckpt["state_dict"]) == 0
    assert chip_smoke._max_tree_diff(to_flax_params(evaluated.option_policy),
                                     to_flax_params(trained.option_policy)) == 0
