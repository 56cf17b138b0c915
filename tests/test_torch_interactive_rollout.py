"""The port's interactive rollout (avlen_tpu_torch/rl/rollout_interactive.py)
against the JAX package's with the stub policies of tests/test_interactive.py
in both packages, on the same world (the JAX scene bank carried across):
for every query strategy (ours, uniform, jask, never, and random where its
draw cannot matter: a query probability of 1 or 0), with the query budget
and gap, the radius gate, ``oracle_when_queried`` / ``allow_stop`` and a
CLIP-embedding stub, the trajectories are equal: ``rl_mask``, the query
flags and counts, the dialog steps, ``masks_vln``, the gathered tokens, the
oracle and muxed actions, ``o_mask``, the uncertainty ground truth, the
query-state encodings and the rewards. Then the five assertions of
tests/test_interactive.py, held against the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlen_tpu.core.episodes import pack_episodes
from avlen_tpu.models.belief_predictor import init_belief_state as jax_init_belief_state
from avlen_tpu.models.memory import init_memory as jax_init_memory
from avlen_tpu.rl import rollout_interactive as jri
from avlen_tpu.sim.env import BatchedAudioNavEnv as JaxEnv
from avlen_tpu.sim.env import EnvConfig as JaxEnvConfig
from avlen_tpu.sim.env import RewardConfig as JaxRewardConfig
from avlen_tpu.sim.synthetic import make_episodes, make_scene_bank
from avlen_tpu_torch.models.belief_predictor import init_belief_state
from avlen_tpu_torch.models.memory import init_memory
from avlen_tpu_torch.rl import rollout_interactive as ri
from avlen_tpu_torch.sim.env import BatchedAudioNavEnv, EnvConfig, RewardConfig
from avlen_tpu_torch.utils.flax_bridge import scene_bank_from_jax

torch.set_num_threads(1)

B = 2
FEAT = 8
QC = 16
NUM_DIALOG_STEPS = 3
QUERY_STEPS = {2, 7}  # episode steps at which the stub option policy queries
T_STEPS = 14
CLIP_W = 512


@pytest.fixture(scope="module")
def world():
    bank, tables = make_scene_bank(
        np.random.RandomState(0), num_scenes=1, side=6, rir_length=200,
        sampling_rate=2000, with_frames=False,
    )
    eps = make_episodes(np.random.RandomState(1), tables, 8, min_hops=6, max_hops=20)
    packed = pack_episodes(eps, num_envs=B)
    reward = dict(with_query_constraint=True, num_total_query=5, query_reward=-0.2,
                  consecutive_constraint_reward=True)
    jenv = JaxEnv(bank, packed, JaxEnvConfig(max_episode_steps=50, sensors=("spectrogram", "pose"),
                                              reward=JaxRewardConfig(**reward)))
    tenv = BatchedAudioNavEnv(scene_bank_from_jax(bank, "cpu"), packed,
                              EnvConfig(max_episode_steps=50, sensors=("spectrogram", "pose"),
                                        reward=RewardConfig(**reward)))
    n = tables[0].num_nodes
    bank_np = np.tile(np.arange(n * 4 * n).reshape(1, n, 4, n, 1).astype(np.int32), (1, 1, 1, 1, 77))
    return jenv, tenv, bank_np


def _jax_fns(env, with_clip):
    """The stub policies of tests/test_interactive.py: π_q queries at episode
    steps QUERY_STEPS, π_g turns left with logits whose top-2 prob gap is
    ~0.37, π_l moves forward; the CLIP stub embeds the first token."""

    def act_option(obs, pa, mf, mv, qs, lqi, key):
        t = obs["pose"][:, 3].astype(jnp.int32)
        want = jnp.zeros_like(t, bool)
        for q in QUERY_STEPS:
            want = want | (t == q)
        b = t.shape[0]
        return want.astype(jnp.int32), jnp.zeros((b,)), jnp.zeros((b,)), jnp.zeros((b, FEAT + QC)), \
            jnp.zeros((b, 2)), jnp.zeros((b, 2))

    def act_goal(obs, pa, mf, mv, key):
        b = obs["pose"].shape[0]
        logits = jnp.tile(jnp.asarray([[0.0, 0.05, 1.0, 0.0]]), (b, 1))
        return jnp.full((b,), 2, jnp.int32), jnp.zeros((b,)), jnp.zeros((b,)), jnp.zeros((b, FEAT)), logits

    def act_dialog(obs, pa, mf, mv, smf, smv, dialog, step, key, dclip=None):
        b = obs["pose"].shape[0]
        return jnp.full((b,), 1, jnp.int32), jnp.zeros((b,)), jnp.zeros((b,)), jnp.zeros((b, FEAT)), \
            jnp.zeros((b, FEAT)), jnp.zeros((b, 4))

    def value_option(obs, pa, mf, mv, qs, lqi):
        return jnp.zeros((obs["pose"].shape[0],))

    def clip_embed(tokens):
        return jnp.tile(tokens[:, :1].astype(jnp.float32), (1, CLIP_W))

    return jri.InteractiveFns(act_option=act_option, act_goal=act_goal, act_dialog=act_dialog,
                              value_option=value_option, oracle_action=env.oracle_action,
                              env_step=env._step_impl, belief_fn=None,
                              clip_embed=clip_embed if with_clip else None)


def _port_fns(env, with_clip, clip_calls):
    def act_option(obs, pa, mf, mv, qs, lqi):
        t = obs["pose"][:, 3].long()
        want = torch.zeros_like(t, dtype=torch.bool)
        for q in QUERY_STEPS:
            want = want | (t == q)
        b = t.shape[0]
        return want.long(), torch.zeros(b), torch.zeros(b), torch.zeros(b, FEAT + QC), torch.zeros(b, 2), \
            torch.zeros(b, 2)

    def act_goal(obs, pa, mf, mv):
        b = obs["pose"].shape[0]
        logits = torch.tensor([[0.0, 0.05, 1.0, 0.0]]).repeat(b, 1)
        return torch.full((b,), 2), torch.zeros(b), torch.zeros(b), torch.zeros(b, FEAT), logits

    def act_dialog(obs, pa, mf, mv, smf, smv, dialog, step, dclip=None):
        b = obs["pose"].shape[0]
        return torch.full((b,), 1), torch.zeros(b), torch.zeros(b), torch.zeros(b, FEAT), \
            torch.zeros(b, FEAT), torch.zeros(b, 4)

    def value_option(obs, pa, mf, mv, qs, lqi):
        return torch.zeros(obs["pose"].shape[0])

    def clip_embed(tokens):
        clip_calls.append(1)
        return tokens[:, :1].float().repeat(1, CLIP_W)

    return ri.InteractiveFns(act_option=act_option, act_goal=act_goal, act_dialog=act_dialog,
                             value_option=value_option, oracle_action=env.oracle_action,
                             env_step=lambda s, a, q: env.step(s, a, q), belief_fn=None,
                             clip_embed=clip_embed if with_clip else None)


def _jax_collect(jenv, bank_np, cfg, with_clip):
    state, obs = jenv.reset()
    carry = jri.InteractiveCarry(
        env_state=state, obs=obs, prev_action=jnp.zeros((B,), jnp.int32),
        masks=jnp.zeros((B,), jnp.float32), masks_vln=jnp.zeros((B,), jnp.float32),
        mem_goal=jax_init_memory(B, 4, FEAT), mem_option=jax_init_memory(B, 4, FEAT + QC),
        mem_vln=jax_init_memory(B, NUM_DIALOG_STEPS, FEAT),
        mem_vln_dialog=jax_init_memory(B, NUM_DIALOG_STEPS, FEAT),
        belief=jax_init_belief_state(B), track=jri.init_query_track(B), key=jax.random.key(0),
    )
    fns = _jax_fns(jenv, with_clip)
    pe = jnp.asarray(jri.sinusoidal_pe(151, QC))
    run = jax.jit(lambda c, bank: jri.collect_rollout_interactive(fns, c, bank, pe, cfg, T_STEPS))
    args = (carry, jnp.asarray(bank_np))
    return run.lower(*args).compile(compiler_options={"xla_llvm_disable_expensive_passes": True})(*args)


def _port_collect(tenv, bank, cfg, with_clip=False, callable_bank=False, clip_calls=None):
    state, obs = tenv.reset()
    carry = ri.InteractiveCarry(
        env_state=state, obs=obs, prev_action=torch.zeros(B, dtype=torch.long),
        masks=torch.zeros(B), masks_vln=torch.zeros(B),
        mem_goal=init_memory(B, 4, FEAT, device="cpu"), mem_option=init_memory(B, 4, FEAT + QC, device="cpu"),
        mem_vln=init_memory(B, NUM_DIALOG_STEPS, FEAT, device="cpu"),
        mem_vln_dialog=init_memory(B, NUM_DIALOG_STEPS, FEAT, device="cpu"),
        belief=init_belief_state(B, device="cpu"), track=ri.init_query_track(B, device="cpu"),
    )
    fns = _port_fns(tenv, with_clip, clip_calls if clip_calls is not None else [])
    bank_t = torch.as_tensor(bank)
    instr = bank_t
    if callable_bank:
        def instr(env_state, newly):  # the host-speaker shape: zeros where no query starts
            rows = bank_t[env_state.scene, env_state.node, env_state.rot, env_state.goal_node]
            return torch.where(newly[:, None], rows, 0)
    pe = torch.as_tensor(ri.sinusoidal_pe(151, QC))
    return ri.collect_rollout_interactive(fns, carry, instr, pe, cfg, T_STEPS,
                                          generator=torch.Generator().manual_seed(0))


EXACT = ("rl_mask", "queried", "query_count", "agent_step", "masks", "masks_vln", "dialog", "o_action",
         "actions", "actions_option", "o_mask", "ucnt_gt", "dones", "rewards")

STRATEGIES = {
    "ours": dict(),
    "ours_oracle": dict(oracle_when_queried=True),
    "ours_oracle_stop": dict(oracle_when_queried=True, allow_stop=True),
    "ours_limited": dict(limit_query=True, how_many_query=1, enforced_gap=3),
    "ours_radius": dict(query_within_radius=False, query_radius=3.0),
    "uniform": dict(qs_method="uniform", uniform_interval=4, limit_query=True, how_many_query=2),
    "jask": dict(qs_method="jask", jask_margin=0.5),
    "jask_none": dict(qs_method="jask"),
    "never": dict(qs_method="never"),
    # the random draw cannot change the result: probability 1 (10 of 10
    # eligible steps) and 0
    "random_all": dict(qs_method="random", how_many_query=10, random_end=30, random_step=3),
    "random_none": dict(qs_method="random", how_many_query=0),
}


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_trajectory_equals_jax(world, name):
    jenv, tenv, bank_np = world
    with_clip = name in ("ours", "uniform")
    cfg_kw = dict(num_dialog_steps=NUM_DIALOG_STEPS, consecutive_reward=-0.5, **STRATEGIES[name])
    _, jtraj = _jax_collect(jenv, bank_np, jri.InteractiveConfig(**cfg_kw), with_clip)
    _, traj = _port_collect(tenv, bank_np, ri.InteractiveConfig(**cfg_kw), with_clip)
    for k in EXACT:
        np.testing.assert_array_equal(traj[k].numpy(), np.asarray(jtraj[k]).astype(traj[k].numpy().dtype),
                                      err_msg=k)
    for k in ("query_state", "last_query_info", "dialog_clip"):
        np.testing.assert_array_equal(traj[k].numpy(), np.asarray(jtraj[k]), err_msg=k)
    assert traj["queried"].any() == (name not in ("never", "random_none", "jask_none"))


def test_callable_source_equals_bank_and_clip_runs_on_query_starts(world):
    _, tenv, bank_np = world
    cfg = ri.InteractiveConfig(num_dialog_steps=NUM_DIALOG_STEPS)
    calls = []
    _, a = _port_collect(tenv, bank_np, cfg, with_clip=True, clip_calls=calls)
    _, b = _port_collect(tenv, bank_np, cfg, with_clip=True, callable_bank=True)
    for k in EXACT + ("dialog_clip",):
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    starts = int(((a["queried"]) & (a["rl_mask"] == 1)).any(dim=1).sum())
    assert len(calls) == starts > 0


@pytest.fixture(scope="module")
def port_runs(world):
    _, tenv, bank_np = world
    return {w: _port_collect(tenv, bank_np, ri.InteractiveConfig(num_dialog_steps=NUM_DIALOG_STEPS,
                                                                oracle_when_queried=w))[1]
            for w in (False, True)}


def _np(traj):
    return {k: v.numpy() for k, v in traj.items() if torch.is_tensor(v)}


def test_query_windows_and_masks(port_runs):
    tr = _np(port_runs[False])
    queried, rl_mask, masks_vln, agent_step, dones = (
        tr[k] for k in ("queried", "rl_mask", "masks_vln", "agent_step", "dones"))
    checked = 0
    for b in range(B):
        if dones[:10, b].any():
            continue
        checked += 1
        assert not queried[0, b] and not queried[1, b]
        assert rl_mask[0, b] == 1 and rl_mask[1, b] == 1
        assert queried[2, b] and queried[3, b] and queried[4, b]
        assert rl_mask[2, b] == 1 and rl_mask[3, b] == 0 and rl_mask[4, b] == 0
        assert not queried[5, b]
        assert rl_mask[5, b] == 1
        np.testing.assert_array_equal(agent_step[2:5, b], [0, 1, 2])
        assert masks_vln[0, b] == 0
        assert masks_vln[2, b] == 1 and masks_vln[3, b] == 1 and masks_vln[4, b] == 1
        assert masks_vln[5, b] == 0
        assert masks_vln[6, b] == 1
        assert queried[7, b] and queried[8, b] and queried[9, b]
        assert rl_mask[7, b] == 1
    assert checked


def test_instruction_gather_and_dialog_persistence(port_runs):
    tr = _np(port_runs[False])
    dialog, dones = tr["dialog"], tr["dones"]
    for b in range(B):
        if dones[:6, b].any():
            continue
        assert (dialog[1, b] == 0).all()
        q = dialog[2, b]
        assert (q != 0).any()
        np.testing.assert_array_equal(dialog[3, b], q)
        np.testing.assert_array_equal(dialog[4, b], q)
        assert (dialog[5, b] == 0).all()


def test_action_mux_oracle_vs_dialog(port_runs):
    tr = _np(port_runs[True])
    for b in range(B):
        if tr["dones"][:6, b].any():
            continue
        for t in (2, 3, 4):
            if tr["o_action"][t, b] != 0:
                assert tr["actions"][t, b] == tr["o_action"][t, b]
        assert tr["actions"][0, b] == 2 and tr["actions"][1, b] == 2
    tr = _np(port_runs[False])
    for b in range(B):
        if tr["dones"][:6, b].any():
            continue
        for t in (2, 3, 4):
            expect = tr["o_action"][t, b] if tr["o_action"][t, b] == 0 else 1
            assert tr["actions"][t, b] == expect


def test_query_state_encodings(port_runs):
    tr = _np(port_runs[False])
    pe = ri.sinusoidal_pe(151, QC)
    np.testing.assert_array_equal(pe, jri.sinusoidal_pe(151, QC))
    for b in range(B):
        if tr["dones"][:10, b].any():
            continue
        np.testing.assert_allclose(tr["query_state"][1, b], pe[0], atol=1e-6)
        np.testing.assert_allclose(tr["query_state"][3, b], pe[1], atol=1e-6)
        assert tr["query_count"][2, b] == 1 and tr["query_count"][7, b] == 2


def test_ucnt_gt_from_goal_prob_gap(port_runs):
    assert (port_runs[False]["ucnt_gt"] == 0).all()


def test_unknown_strategy_raises(world):
    _, tenv, bank_np = world
    with pytest.raises(ValueError, match="query strategy"):
        _port_collect(tenv, bank_np, dataclasses.replace(ri.InteractiveConfig(), qs_method="sometimes"))
