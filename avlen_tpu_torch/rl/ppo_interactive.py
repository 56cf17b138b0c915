"""AVLEN updates: π_q's PPO with ``rl_mask`` gating and the uncertainty CE,
and π_l's supervised (replay) update.

PyTorch counterpart of ``avlen_tpu/rl/ppo_interactive.py`` (reference
ss_baselines/savi/ppo/ppo.py:99-289):

* ``ppo_update_interactive``: the clipped surrogate gated by ``rl_mask`` and
  normalised by ``max(Σ rl_mask, 1)``, the clipped value loss (a plain mean
  over all steps), the entropy bonus (a plain mean), and the uncertainty
  head's cross-entropy against ``ucnt_gt`` weighted by ``unct_coef``;
  ``ppo_epoch × min(num_mini_batch, B)`` optimizer steps, each over a
  minibatch of env slots, the ring memory re-evaluated per step
  (``evaluate_option_sequence``) or ``chunk`` steps at a time
  (``evaluate_option_sequence_batched``);
* ``dialog_supervised_update``: one optimizer step of π_l's class-weighted
  CE against the oracle actions, ``Σ ce·w / max(Σ w, 1)`` with ``w =
  o_mask · [queried] · DIALOG_CLASS_WEIGHTS[o_action]`` (STOP excluded);
  ``replay_only`` keeps the queried steps (the REPLAY_STORE flow), dialog
  pretraining takes every ``o_mask`` step. π_l's two ring memories (its
  SMT features and its SMT states) are re-evaluated together.

The JAX package runs an update as one jit with ``jax.checkpoint`` per step;
here it is an eager loop whose re-evaluation runs the SMT kernel forward
and its plain version in the backward (``ops/smt_cuda.py``), nothing
rematerialised.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from avlen_tpu_torch.models.memory import SMTMemory, insert, reset_where
from avlen_tpu_torch.rl.ppo import PPOConfig, _select0
from avlen_tpu_torch.rl.rollout_smt import batched_ring_eval

DIALOG_CLASS_WEIGHTS = (0.0, 1.0 / 3, 1.0 / 3, 1.0 / 3)


def _split_obs(traj_obs: Dict[str, torch.Tensor]):
    return {k: v for k, v in traj_obs.items() if not k.startswith("__")}, traj_obs["__prev_action"]


def evaluate_option_sequence(
    evaluate_step: Callable,  # (obs, pa, mf, mv, qs, lqi, actions) -> (v, lp, ent, logits, unct, x)
    traj_obs: Dict[str, torch.Tensor],  # (T, Bm, ...) with __prev_action
    feat_option: torch.Tensor,  # (T, Bm, F) stored memory entries
    query_state: torch.Tensor,
    last_query_info: torch.Tensor,
    masks: torch.Tensor,  # (T, Bm)
    actions_option: torch.Tensor,
    initial_memory: SMTMemory,
):
    """π_q's re-evaluation one step at a time: reset where ``masks == 0``,
    evaluate, insert the stored entry. The reference the batched version is
    held to. Returns (values, log_probs, entropy, uncertainty logits)."""
    sensor_obs, prev_actions = _split_obs(traj_obs)
    mem = initial_memory
    outs = []
    for t in range(masks.shape[0]):
        mem = reset_where(mem, masks[t] == 0)
        v, lp, ent, _, unct, _ = evaluate_step(
            {k: x[t] for k, x in sensor_obs.items()}, prev_actions[t], mem.features, mem.valid,
            query_state[t], last_query_info[t], actions_option[t])
        mem = insert(mem, feat_option[t])
        outs.append((v, lp, ent, unct))
    return tuple(torch.stack(x) for x in zip(*outs))


def evaluate_option_sequence_batched(
    evaluate_step: Callable,
    traj_obs: Dict[str, torch.Tensor],
    feat_option: torch.Tensor,
    query_state: torch.Tensor,
    last_query_info: torch.Tensor,
    masks: torch.Tensor,
    actions_option: torch.Tensor,
    initial_memory: SMTMemory,
    chunk: int = 15,
    compute_dtype: Optional[torch.dtype] = None,
):
    """``evaluate_option_sequence``, ``chunk`` steps a call
    (``batched_ring_eval``, its pool cast to ``compute_dtype``): the same
    ring views, the same outputs at float32."""
    sensor_obs, prev_actions = _split_obs(traj_obs)

    def eval_fn(inp, views):
        obs_f, pa_f, qs_f, lqi_f, a_f = inp
        (mem, mem_valid), = views
        v, lp, ent, _, unct, _ = evaluate_step(obs_f, pa_f, mem, mem_valid, qs_f, lqi_f, a_f)
        return v, lp, ent, unct

    return batched_ring_eval(
        eval_fn,
        (sensor_obs, prev_actions, query_state, last_query_info, actions_option),
        [(initial_memory, feat_option, masks)],
        chunk=chunk,
        compute_dtype=compute_dtype,
    )


def ppo_update_interactive(
    evaluate_step: Callable,  # π_q's evaluate_step over the optimizer's parameters
    optimizer,  # make_optimizer's (or any with zero_grad and step)
    traj: Dict,
    advantages: torch.Tensor,  # (T, B)
    returns: torch.Tensor,  # (T, B)
    config: PPOConfig,
    unct_coef: float = 0.5,
    generator: Optional[torch.Generator] = None,
    perms: Optional[Sequence] = None,
    batched_chunk: int = 0,
    compute_dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """One π_q PPO update in place on the optimizer's parameters. Each epoch
    draws a permutation of the B env slots from ``generator`` (a CPU
    generator) or takes ``perms[epoch]``, cut into ``min(num_mini_batch, B)``
    minibatches. ``batched_chunk`` > 0 re-evaluates that many steps a call,
    the ring views' pool cast to ``compute_dtype`` (TPU.PRECISION). Returns
    value_loss, action_loss, entropy and unct_loss averaged over the
    optimizer steps, as tensors."""
    b = traj["actions_option"].shape[1]
    num_mb = min(config.num_mini_batch, b)
    mb_size = b // num_mb
    dev = traj["actions_option"].device

    adv = advantages
    if config.use_normalized_advantage:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-5)

    if batched_chunk > 0:
        def eval_seq(*args):
            return evaluate_option_sequence_batched(evaluate_step, *args, chunk=batched_chunk,
                                                    compute_dtype=compute_dtype)
    else:
        def eval_seq(*args):
            return evaluate_option_sequence(evaluate_step, *args)

    sums = {k: torch.zeros((), device=dev) for k in ("value_loss", "action_loss", "entropy", "unct_loss")}
    for e in range(config.ppo_epoch):
        perm = perms[e] if perms is not None else torch.randperm(b, generator=generator)
        perm = torch.as_tensor(perm, device=dev).long()
        for m in range(num_mb):
            idx = perm[m * mb_size : (m + 1) * mb_size]

            def sel(x):
                return x.index_select(1, idx)

            v, lp, ent, unct = eval_seq(
                {k: sel(x) for k, x in traj["obs"].items()},
                sel(traj["feat_option"]), sel(traj["query_state"]), sel(traj["last_query_info"]),
                sel(traj["masks"]), sel(traj["actions_option"]),
                _select0(traj["initial_memories"][1], idx),
            )
            old_lp, old_v = sel(traj["log_probs_option"]), sel(traj["values_option"])
            rl, a_t, r_t = sel(traj["rl_mask"]), sel(adv), sel(returns)

            ratio = torch.exp(lp - old_lp)
            surr1 = ratio * a_t * rl
            surr2 = torch.clamp(ratio, 1 - config.clip_param, 1 + config.clip_param) * a_t * rl
            action_loss = -torch.minimum(surr1, surr2).sum() / torch.clamp(rl.sum(), min=1.0)
            v_clip = old_v + torch.clamp(v - old_v, -config.clip_param, config.clip_param)
            value_loss = 0.5 * torch.maximum((v - r_t) ** 2, (v_clip - r_t) ** 2).mean()
            ent_mean = ent.mean()
            unct_loss = F.cross_entropy(unct.reshape(-1, 2), sel(traj["ucnt_gt"]).reshape(-1).long())
            total = (value_loss * config.value_loss_coef + action_loss - ent_mean * config.entropy_coef
                     + unct_coef * unct_loss)

            optimizer.zero_grad()
            total.backward()
            optimizer.step()
            for k, x in (("value_loss", value_loss), ("action_loss", action_loss), ("entropy", ent_mean),
                         ("unct_loss", unct_loss)):
                sums[k] += x.detach()
    n = config.ppo_epoch * num_mb
    return {k: x / n for k, x in sums.items()}


# ---------------------------------------------------------------------------
def _dialog_clip(dialog_clip: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A width-0 ``dialog_clip`` means no stored embedding: the tower runs
    in the call (as the JAX trainer's ``update_l`` falls back)."""
    return None if dialog_clip is None or dialog_clip.shape[-1] == 0 else dialog_clip


def evaluate_dialog_sequence(
    evaluate_step: Callable,  # (obs, pa, mf, mv, smf, smv, dialog, step, actions, dclip) -> (v, lp, ent, logits, x, x_att)
    traj_obs: Dict[str, torch.Tensor],
    feat_vln: torch.Tensor,
    feat_vln_dialog: torch.Tensor,
    dialog: torch.Tensor,  # (T, Bm, 77)
    agent_step: torch.Tensor,  # (T, Bm)
    masks_vln: torch.Tensor,  # (T, Bm)
    actions: torch.Tensor,
    initial_mem_vln: SMTMemory,
    initial_mem_vln_dialog: SMTMemory,
    dialog_clip: Optional[torch.Tensor] = None,  # (T, Bm, clip_width | 0)
) -> torch.Tensor:
    """π_l's re-evaluation one step at a time over its two ring memories,
    both reset where ``masks_vln == 0``. The reference the batched version
    is held to. Returns the logits (T, Bm, A)."""
    sensor_obs, prev_actions = _split_obs(traj_obs)
    dialog_clip = _dialog_clip(dialog_clip)
    mem, smem = initial_mem_vln, initial_mem_vln_dialog
    logits = []
    for t in range(masks_vln.shape[0]):
        reset = masks_vln[t] == 0
        mem, smem = reset_where(mem, reset), reset_where(smem, reset)
        out = evaluate_step(
            {k: x[t] for k, x in sensor_obs.items()}, prev_actions[t], mem.features, mem.valid,
            smem.features, smem.valid, dialog[t], agent_step[t], actions[t],
            None if dialog_clip is None else dialog_clip[t])
        logits.append(out[3])
        mem, smem = insert(mem, feat_vln[t]), insert(smem, feat_vln_dialog[t])
    return torch.stack(logits)


def evaluate_dialog_sequence_batched(
    evaluate_step: Callable,
    traj_obs: Dict[str, torch.Tensor],
    feat_vln: torch.Tensor,
    feat_vln_dialog: torch.Tensor,
    dialog: torch.Tensor,
    agent_step: torch.Tensor,
    masks_vln: torch.Tensor,
    actions: torch.Tensor,
    initial_mem_vln: SMTMemory,
    initial_mem_vln_dialog: SMTMemory,
    chunk: int = 15,
    dialog_clip: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``evaluate_dialog_sequence``, ``chunk`` steps a call: both ring
    memories' views gathered (``batched_ring_eval``, the pools cast to
    ``compute_dtype``)."""
    sensor_obs, prev_actions = _split_obs(traj_obs)
    dialog_clip = _dialog_clip(dialog_clip)

    def eval_fn(inp, views):
        obs_f, pa_f, d_f, dc_f, st_f, a_f = inp
        (mem, mv), (smem, smv) = views
        return (evaluate_step(obs_f, pa_f, mem, mv, smem, smv, d_f, st_f, a_f, dc_f)[3],)

    (logits,) = batched_ring_eval(
        eval_fn,
        (sensor_obs, prev_actions, dialog, dialog_clip, agent_step, actions),
        [(initial_mem_vln, feat_vln, masks_vln), (initial_mem_vln_dialog, feat_vln_dialog, masks_vln)],
        chunk=chunk,
        compute_dtype=compute_dtype,
    )
    return logits


def dialog_loss(logits: torch.Tensor, traj: Dict, replay_only: bool) -> torch.Tensor:
    """``Σ ce·w / max(Σ w, 1)``: not ``F.cross_entropy(weight=...)``, which
    divides by Σ w with no floor."""
    o_action = traj["o_action"].long()
    w = traj["o_mask"].float()
    if replay_only:
        w = w * traj["queried"].float()
    w = w * torch.tensor(DIALOG_CLASS_WEIGHTS, dtype=torch.float32, device=o_action.device)[o_action]
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), o_action.reshape(-1),
                         reduction="none").reshape(o_action.shape)
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


def dialog_supervised_update(
    evaluate_step: Callable,  # π_l's evaluate_step over the optimizer's parameters
    optimizer: torch.optim.Optimizer,
    traj: Dict,
    replay_only: bool = True,
    batched_chunk: int = 0,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """One optimizer step of π_l's class-weighted CE against the oracle
    actions over the whole trajectory (update_dialog, savi/ppo/ppo.py:
    99-154). The stored ``dialog_clip`` embeddings stand for the frozen
    CLIP tower, which gets no gradient. Returns the loss."""
    args = (traj["obs"], traj["feat_vln"], traj["feat_vln_dialog"], traj["dialog"], traj["agent_step"],
            traj["masks_vln"], traj["o_action"], traj["initial_memories"][2], traj["initial_memories"][3])
    if batched_chunk > 0:
        logits = evaluate_dialog_sequence_batched(evaluate_step, *args, chunk=batched_chunk,
                                                  dialog_clip=traj.get("dialog_clip"),
                                                  compute_dtype=compute_dtype)
    else:
        logits = evaluate_dialog_sequence(evaluate_step, *args, dialog_clip=traj.get("dialog_clip"))
    loss = dialog_loss(logits, traj, replay_only)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()
