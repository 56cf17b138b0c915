"""AVLEN interactive rollout: π_q option selection, oracle instructions,
π_g / π_l action multiplexing.

PyTorch counterpart of ``avlen_tpu/rl/rollout_interactive.py``
(``collect_rollout_interactive``; reference ``_collect_rollout_step``,
ss_baselines/savi/ppo/ppo_trainer.py:323-897; and
``collect_rollout_dialog_pretrain``, π_l pretraining's oracle-driven
rollout). The JAX ``lax.scan``
becomes a Python loop over env steps; oracle actions come from the graph
tables, oracle instructions from the token bank (a gather) or the host
speaker (a callable), the query bookkeeping is a ``QueryTrack`` of integer
tensors, and the four external memories (goal / option / vln /
vln-dialog-state, savi/models/rollout_storage.py:145-173) are rings.

Semantics, step for step as in JAX (citations there):
* episode-boundary resets of the track and the memories;
* the belief update, then the query-state encodings;
* π_q, then π_g (hoisted above the query decision, which 'jask' reads);
* the query strategies ours / random / uniform / jask / never, the radius
  gate and the ``limit_query`` budget and gap;
* the consecutive-query reward, ``rl_mask`` = 1 on goal steps and query
  starts;
* the instruction gather, and the frozen CLIP embedding of the rows whose
  query starts: the tower runs only on a step where some query starts (a
  branch on ``newly.any()``, JAX's ``lax.cond``), so it costs a host sync
  a step;
* π_l, the uncertainty ground truth (top-2 goal-prob gap < 0.1), the action
  mux with ``oracle_when_queried`` / ``allow_stop``, the env step with the
  query terms, the dialog-window end and the four ring inserts.

Randomness (policy sampling through the callables, the 'random' strategy's
draw and the distance-constraint draw) comes from explicit
``torch.Generator``s; the draws differ from ``jax.random``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import scipy.special
import torch

from avlen_tpu_torch.models.belief_predictor import BeliefState
from avlen_tpu_torch.models.memory import SMTMemory, insert, reset_where
from avlen_tpu_torch.rl.rollout import stack_steps
from avlen_tpu_torch.sim.env import QueryInfo


def sinusoidal_pe(max_len: int, dim: int) -> np.ndarray:
    """Query-count positional table (ddppo_trainer.py:505-513)."""
    position = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


class QueryTrack(NamedTuple):
    queried: torch.Tensor  # (B,) bool: inside a dialog window
    dialog_step: torch.Tensor  # (B,) step within the window
    total_step: torch.Tensor  # (B,) episode step counter
    last_query_step: torch.Tensor  # (B,)
    query_count: torch.Tensor  # (B,)
    current_dialog: torch.Tensor  # (B, 77) int32 tokens of the window's instruction
    current_clip: torch.Tensor  # (B, clip embed_dim) f32 frozen CLIP embedding of current_dialog


def init_query_track(batch: int, context_length: int = 77, clip_width: int = 512,
                     device="cuda") -> QueryTrack:
    def z():
        return torch.zeros((batch,), dtype=torch.long, device=device)

    return QueryTrack(
        queried=torch.zeros((batch,), dtype=torch.bool, device=device),
        dialog_step=z(),
        total_step=z(),
        last_query_step=z(),
        query_count=z(),
        current_dialog=torch.zeros((batch, context_length), dtype=torch.int32, device=device),
        current_clip=torch.zeros((batch, clip_width), dtype=torch.float32, device=device),
    )


class InteractiveCarry(NamedTuple):
    env_state: Any
    obs: Dict[str, torch.Tensor]
    prev_action: torch.Tensor
    masks: torch.Tensor  # (B,) episode mask (0 at episode start)
    masks_vln: torch.Tensor  # (B,) dialog-window mask
    mem_goal: SMTMemory
    mem_option: SMTMemory
    mem_vln: SMTMemory
    mem_vln_dialog: SMTMemory  # state memory of π_l's SMT states
    belief: BeliefState
    track: QueryTrack


@dataclasses.dataclass(frozen=True)
class InteractiveConfig:
    num_dialog_steps: int = 3
    num_total_query: int = 5
    consecutive_reward: float = -0.5
    query_within_radius: bool = True
    oracle_when_queried: bool = False
    allow_stop: bool = False
    query_radius: float = 3.0
    pe_max: int = 151
    deterministic: bool = False
    # eval-time query strategy (ppo_trainer.py:1333-1356): ours | random |
    # uniform | jask | never; budget and gap enforced under limit_query
    qs_method: str = "ours"
    limit_query: bool = False
    how_many_query: int = 3
    enforced_gap: int = 1
    uniform_interval: int = 10  # uniform: steps {0, U, 2U, ...}
    random_end: int = 30  # random: budget/|eligible| per step of range(0, end, step)
    random_step: int = 3
    jask_margin: float = 0.1  # jask: query when π_g's top-2 prob gap is under this
    # distance-sampled query reward draw (environments.py:126-133)
    with_distance_constraint: bool = False
    distance_distribution_type: str = "gaussian"  # gaussian | beta
    dist_mean: float = 0.0
    dist_sd: float = 0.5
    dist_alpha: float = 2.0
    dist_beta: float = 2.0


@dataclasses.dataclass(frozen=True)
class InteractiveFns:
    """The policies and env as callables (sampling generators inside)."""

    act_option: Callable  # (obs, pa, mem_f, mem_v, qs, lqi) -> (a, lp, v, x_mem, logits, unct)
    act_goal: Callable  # (obs, pa, mem_f, mem_v) -> (a, lp, v, x, logits)
    act_dialog: Callable  # (obs, pa, mem_f, mem_v, smem_f, smem_v, dialog, step[, dclip]) -> (a, lp, v, x, x_att, logits)
    value_option: Callable  # (obs, pa, mem_f, mem_v, qs, lqi) -> v
    oracle_action: Callable  # (env_state) -> (B,)
    env_step: Callable  # (env_state, actions, QueryInfo) -> (env_state, StepOutput)
    belief_fn: Optional[Callable] = None  # (belief_state, obs, new_ep) -> (state, cat, loc)
    # (B, 77) tokens -> (B, clip embed_dim) FROZEN CLIP features; when set the
    # rollout embeds on query starts only, carries the embedding and stores it
    clip_embed: Optional[Callable] = None


def _uniform(generator: Optional[torch.Generator], b: int, device) -> torch.Tensor:
    """(b,) uniform [0, 1) draws on the generator's device, moved to ``device``."""
    gen_dev = generator.device if generator is not None else "cpu"
    return torch.rand((b,), generator=generator, device=gen_dev).to(device)


def _distance_sample(cfg: InteractiveConfig, generator, b: int, device) -> torch.Tensor:
    if not cfg.with_distance_constraint:
        return torch.zeros((b,), dtype=torch.float32, device=device)
    if cfg.distance_distribution_type == "gaussian":
        gen_dev = generator.device if generator is not None else "cpu"
        z = torch.randn((b,), generator=generator, device=gen_dev).to(device)
        return cfg.dist_mean + cfg.dist_sd * z
    # beta by inverting its CDF at uniform draws
    u = _uniform(generator, b, "cpu").double().numpy()
    return torch.as_tensor(scipy.special.betaincinv(cfg.dist_alpha, cfg.dist_beta, u),
                           dtype=torch.float32, device=device)


def query_encodings(track: QueryTrack, pe_table: torch.Tensor, pe_max: int):
    """(query_state, last_query_info): the query-count and since-last-query
    rows of the positional table (ppo_trainer.py:404-420)."""
    diff = torch.where(track.query_count >= 2, track.total_step - track.last_query_step,
                       torch.full_like(track.total_step, pe_max - 1))
    return (pe_table[torch.clamp(track.query_count, 0, pe_max - 1)],
            pe_table[torch.clamp(diff, 0, pe_max - 1)])


@torch.no_grad()
def collect_rollout_interactive(
    fns: InteractiveFns,
    carry: InteractiveCarry,
    instr_bank,  # (S, N, 4, N, 77) int32 bank OR callable (env_state, newly) -> (B, 77)
    pe_table: torch.Tensor,  # (pe_max, qc_emb)
    cfg: InteractiveConfig,
    num_steps: int,
    generator: Optional[torch.Generator] = None,
):
    """Returns (carry, traj dict of stacked (T, B, ...) tensors, with
    ``initial_memories`` and π_q's ``bootstrap_value``)."""
    init_memories = (carry.mem_goal, carry.mem_option, carry.mem_vln, carry.mem_vln_dialog)
    c = carry
    steps = []
    for _ in range(num_steps):
        new_ep = c.masks == 0
        t = c.track
        b = c.masks.shape[0]
        dev = c.masks.device
        zero = torch.zeros((), dtype=torch.long, device=dev)

        # ---- episode-boundary resets (ppo_trainer.py:397-407)
        t = QueryTrack(
            queried=t.queried & ~new_ep,
            dialog_step=torch.where(new_ep, zero, t.dialog_step),
            total_step=torch.where(new_ep, zero, t.total_step),
            last_query_step=torch.where(new_ep, zero, t.last_query_step),
            query_count=torch.where(new_ep, zero, t.query_count),
            current_dialog=torch.where(new_ep[:, None], 0, t.current_dialog),
            current_clip=torch.where(new_ep[:, None], 0.0, t.current_clip),
        )
        vln_reset = new_ep | (c.masks_vln == 0)
        mem_goal = reset_where(c.mem_goal, new_ep)
        mem_option = reset_where(c.mem_option, new_ep)
        mem_vln = reset_where(c.mem_vln, vln_reset)
        mem_vln_dialog = reset_where(c.mem_vln_dialog, vln_reset)
        prev_action = torch.where(new_ep, torch.zeros_like(c.prev_action), c.prev_action)

        obs = dict(c.obs)
        belief_state = c.belief
        if fns.belief_fn is not None:
            belief_state, cat_b, loc_b = fns.belief_fn(belief_state, obs, new_ep)
            obs["category_belief"] = cat_b
            obs["location_belief"] = loc_b

        # ---- query-state encodings, π_q, then π_g (ppo_trainer.py:404-458, 600-607)
        query_state, last_query_info = query_encodings(t, pe_table, cfg.pe_max)
        a_opt, lp_opt, v_opt, x_mem_opt, logits_opt, unct_logits = fns.act_option(
            obs, prev_action, mem_option.features, mem_option.valid, query_state, last_query_info)
        a_goal, lp_goal, v_goal, x_goal, logits_goal = fns.act_goal(
            obs, prev_action, mem_goal.features, mem_goal.valid)

        env_state = c.env_state
        dtg = env_state.prev_dtg  # geodesic at the current node (pre-step)

        # ---- query decision by strategy (ppo_trainer.py:2036-2100)
        if cfg.qs_method == "ours":
            wants_query = a_opt == 1
        elif cfg.qs_method == "random":
            n_eligible = max(1, -(-cfg.random_end // cfg.random_step))
            eligible = (t.total_step < cfg.random_end) & (t.total_step % cfg.random_step == 0)
            wants_query = eligible & (_uniform(generator, b, dev) < cfg.how_many_query / n_eligible)
        elif cfg.qs_method == "uniform":
            wants_query = (t.total_step % cfg.uniform_interval) == 0
        elif cfg.qs_method == "jask":
            top2_goal = torch.topk(torch.softmax(logits_goal, dim=-1), 2, dim=-1).values
            wants_query = (top2_goal[:, 0] - top2_goal[:, 1]) < cfg.jask_margin
        elif cfg.qs_method == "never":
            wants_query = torch.zeros((b,), dtype=torch.bool, device=dev)
        else:
            raise ValueError(f"unknown query strategy {cfg.qs_method!r}")

        dist_ok = torch.ones((b,), dtype=torch.bool, device=dev) if cfg.query_within_radius else (dtg > cfg.query_radius)
        allowed = torch.ones((b,), dtype=torch.bool, device=dev)
        if cfg.limit_query:
            gap_ok = (t.total_step - t.last_query_step) > cfg.enforced_gap
            allowed = (t.query_count < cfg.how_many_query) & (gap_ok | (t.query_count == 0))
        newly = (~t.queried) & wants_query & dist_ok & allowed
        queried = t.queried | newly
        query_count = t.query_count + newly.long()

        # ---- consecutive-query shaping (ppo_trainer.py:524-535)
        diff2 = t.total_step - (t.last_query_step + 2)
        cons = torch.where(
            newly & (query_count >= 2) & (diff2 <= 10),
            cfg.consecutive_reward / torch.clamp(diff2, min=1).float(),
            torch.zeros((), device=dev),
        )
        last_query_step = torch.where(newly, t.total_step, t.last_query_step)
        rl_mask = ((~queried) | newly).float()

        # ---- oracle instruction (ppo_trainer.py:538-562)
        if callable(instr_bank):
            tokens = instr_bank(env_state, newly)
        else:
            tokens = instr_bank[env_state.scene, env_state.node, env_state.rot, env_state.goal_node]
        current_dialog = torch.where(newly[:, None], tokens, t.current_dialog)
        if fns.clip_embed is not None:
            # the frozen tower runs only when some env's query starts this step
            if bool(newly.any()):
                fresh_clip = fns.clip_embed(tokens).to(t.current_clip.dtype)
                current_clip = torch.where(newly[:, None], fresh_clip, t.current_clip)
            else:
                current_clip = t.current_clip
        else:
            current_clip = None
        agent_step = t.dialog_step

        # ---- π_l (ppo_trainer.py:608-637)
        dialog_extra = () if current_clip is None else (current_clip,)
        a_vln, lp_vln, v_vln, x_vln, x_att_dialog, logits_vln = fns.act_dialog(
            obs, prev_action, mem_vln.features, mem_vln.valid, mem_vln_dialog.features,
            mem_vln_dialog.valid, current_dialog, agent_step, *dialog_extra)

        o_action = fns.oracle_action(env_state)

        # uncertainty ground truth: top-2 goal prob gap (ppo_trainer.py:646-652)
        top2 = torch.topk(torch.softmax(logits_goal, dim=-1), 2, dim=-1).values
        ucnt_gt = ((top2[:, 0] - top2[:, 1]) < 0.1).long()

        # ---- action mux (ppo_trainer.py:654-694)
        oracle_stop = o_action == 0
        a_vln = a_vln.to(o_action.dtype)
        if cfg.oracle_when_queried:
            on_stop = o_action if cfg.allow_stop else a_vln
            a_q = torch.where(oracle_stop, on_stop, o_action)
        else:
            a_q = torch.where(oracle_stop, o_action, a_vln)
        actions = torch.where(queried, a_q, a_goal.to(a_q.dtype))
        o_mask = (~(queried & oracle_stop)).float()

        dist_sample = _distance_sample(cfg, generator, b, dev)
        env_state2, out = fns.env_step(
            env_state, actions,
            QueryInfo(is_queried=queried, query_num=query_count, cons_reward=cons, dist_sample=dist_sample),
        )

        # ---- dialog window bookkeeping (ppo_trainer.py:760-772)
        dialog_step2 = torch.where(queried, t.dialog_step + 1, t.dialog_step)
        window_over = queried & (dialog_step2 >= cfg.num_dialog_steps)
        dialog_next = torch.where(window_over[:, None], 0, current_dialog)
        clip_next = (torch.where(window_over[:, None], 0.0, current_clip)
                     if current_clip is not None else t.current_clip)
        track_next = QueryTrack(
            queried=queried & ~window_over,
            dialog_step=torch.where(window_over, zero, dialog_step2),
            total_step=torch.where(out.done, zero, t.total_step + 1),
            last_query_step=last_query_step,
            query_count=query_count,
            current_dialog=dialog_next,
            current_clip=clip_next,
        )
        masks_vln_next = (~(window_over | out.done)).float()

        steps.append(dict(
            obs={**obs, "__prev_action": prev_action},
            actions=actions,
            actions_option=a_opt,
            log_probs_option=lp_opt,
            values_option=v_opt,
            feat_goal=x_goal,
            feat_option=x_mem_opt,
            feat_vln=x_vln,
            feat_vln_dialog=x_att_dialog.detach(),
            dialog=current_dialog,
            dialog_clip=(current_clip if current_clip is not None
                         else torch.zeros((b, 0), dtype=torch.float32, device=dev)),
            agent_step=agent_step,
            query_state=query_state,
            last_query_info=last_query_info,
            rl_mask=rl_mask,
            o_action=o_action,
            o_mask=o_mask,
            ucnt_gt=ucnt_gt,
            queried=queried,
            logits_vln=logits_vln,
            rewards=out.reward,
            masks=c.masks,
            masks_vln=torch.where(vln_reset, torch.zeros_like(c.masks_vln), c.masks_vln),
            dones=out.done,
            query_count=query_count,
            metrics=dict(out.metrics),
        ))
        c = InteractiveCarry(
            env_state=env_state2,
            obs=out.obs,
            prev_action=actions,
            masks=1.0 - out.done.float(),
            masks_vln=masks_vln_next,
            mem_goal=insert(mem_goal, x_goal),
            mem_option=insert(mem_option, x_mem_opt),
            mem_vln=insert(mem_vln, x_vln),
            mem_vln_dialog=insert(mem_vln_dialog, x_att_dialog),
            belief=belief_state,
            track=track_next,
        )

    traj = stack_steps(steps)
    traj["initial_memories"] = init_memories

    # bootstrap value of π_q from the post-rollout state
    t = c.track
    new_ep = c.masks == 0
    obs_b = dict(c.obs)
    if fns.belief_fn is not None:
        _, cat_b, loc_b = fns.belief_fn(c.belief, obs_b, new_ep)
        obs_b["category_belief"] = cat_b
        obs_b["location_belief"] = loc_b
    mem_o = reset_where(c.mem_option, new_ep)
    pa = torch.where(new_ep, torch.zeros_like(c.prev_action), c.prev_action)
    qs, lqi = query_encodings(t, pe_table, cfg.pe_max)
    traj["bootstrap_value"] = fns.value_option(obs_b, pa, mem_o.features, mem_o.valid, qs, lqi)
    return c, traj


@torch.no_grad()
def collect_rollout_dialog_pretrain(
    act_dialog: Callable,  # (obs, pa, mf, mv, smf, smv, dialog, step[, dclip]) -> (a, lp, v, x, x_att, logits)
    env_step_noquery: Callable,  # (env_state, actions) -> (env_state, StepOutput)
    oracle_action: Callable,  # (env_state) -> (B,)
    belief_fn: Optional[Callable],
    carry: InteractiveCarry,
    instr_bank,  # (S, N, 4, N, 77) bank OR callable (env_state, window_start) -> (B, 77)
    num_dialog_steps: int,
    num_steps: int,
    sub_instr_bank: Optional[torch.Tensor] = None,  # (E, 77) dataset instructions, zero rows absent
    clip_embed: Optional[Callable] = None,
):
    """π_l pretraining rollout (DIALOG_TRAINING, ddppo_trainer.py:181-298,
    881-891 + ppo_trainer.py:354-369): the oracle's actions drive the agent
    through the env's no-query step. Each window of ``num_dialog_steps``
    takes its instruction where it starts (a new episode, or the last
    window closed): the episode's dataset ``sub_instr`` row where non-zero,
    else the oracle bank or host source. ``masks_vln`` closes each window,
    so both π_l memories reset. The frozen CLIP embedding of each step's
    instruction is stored; the tower runs on the steps where some window
    starts and the embedding is carried through the window (JAX embeds every
    step: the same values). Returns (carry, traj) with ``initial_memories``."""
    init_memories = (carry.mem_goal, carry.mem_option, carry.mem_vln, carry.mem_vln_dialog)
    c = carry
    steps = []
    for _ in range(num_steps):
        new_ep = c.masks == 0
        t = c.track
        b = c.masks.shape[0]
        dev = c.masks.device
        zero = torch.zeros((), dtype=torch.long, device=dev)
        window_start = new_ep | (t.dialog_step == 0)
        vln_reset = new_ep | (c.masks_vln == 0)
        mem_vln = reset_where(c.mem_vln, vln_reset)
        mem_vln_dialog = reset_where(c.mem_vln_dialog, vln_reset)
        prev_action = torch.where(new_ep, torch.zeros_like(c.prev_action), c.prev_action)

        obs = dict(c.obs)
        belief_state = c.belief
        if belief_fn is not None:
            belief_state, cat_b, loc_b = belief_fn(belief_state, obs, new_ep)
            obs["category_belief"] = cat_b
            obs["location_belief"] = loc_b

        env_state = c.env_state
        if callable(instr_bank):
            tokens = instr_bank(env_state, window_start)
        else:
            tokens = instr_bank[env_state.scene, env_state.node, env_state.rot, env_state.goal_node]
        if sub_instr_bank is not None:
            ds_tokens = sub_instr_bank[env_state.ep_i]
            tokens = torch.where((ds_tokens != 0).any(dim=-1)[:, None], ds_tokens, tokens)
        current_dialog = torch.where(window_start[:, None], tokens, t.current_dialog)
        agent_step = torch.where(new_ep, zero, t.dialog_step)

        current_clip = None
        if clip_embed is not None:
            current_clip = t.current_clip
            if bool(window_start.any()):
                fresh = clip_embed(current_dialog).to(t.current_clip.dtype)
                current_clip = torch.where(window_start[:, None], fresh, t.current_clip)
        dialog_extra = () if current_clip is None else (current_clip,)
        _, _, _, x_vln, x_att_dialog, logits = act_dialog(
            obs, prev_action, mem_vln.features, mem_vln.valid, mem_vln_dialog.features, mem_vln_dialog.valid,
            current_dialog, agent_step, *dialog_extra)
        o_action = oracle_action(env_state)
        env_state2, out = env_step_noquery(env_state, o_action)

        step2 = agent_step + 1
        closes = (step2 >= num_dialog_steps) | out.done
        track_next = t._replace(
            dialog_step=torch.where(closes, zero, step2),
            total_step=torch.where(out.done, zero, t.total_step + 1),
            current_dialog=torch.where(closes[:, None], 0, current_dialog),
            current_clip=t.current_clip if current_clip is None else torch.where(closes[:, None], 0.0, current_clip),
        )
        steps.append(dict(
            obs={**obs, "__prev_action": prev_action},
            feat_vln=x_vln,
            feat_vln_dialog=x_att_dialog.detach(),
            dialog=current_dialog,
            dialog_clip=(current_clip if current_clip is not None
                         else torch.zeros((b, 0), dtype=torch.float32, device=dev)),
            agent_step=agent_step,
            o_action=o_action,
            o_mask=torch.ones_like(o_action, dtype=torch.float32),
            queried=torch.ones_like(out.done),
            masks_vln=torch.where(vln_reset, torch.zeros_like(c.masks_vln), c.masks_vln),
            logits_vln=logits,
            dones=out.done,
            metrics=dict(out.metrics),
        ))
        c = c._replace(
            env_state=env_state2,
            obs=out.obs,
            prev_action=o_action,
            masks=1.0 - out.done.float(),
            masks_vln=(~closes).float(),
            mem_vln=insert(mem_vln, x_vln),
            mem_vln_dialog=insert(mem_vln_dialog, x_att_dialog),
            belief=belief_state,
            track=track_next,
        )

    traj = stack_steps(steps)
    traj["initial_memories"] = init_memories
    return c, traj
