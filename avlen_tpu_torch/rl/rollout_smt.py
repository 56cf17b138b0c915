"""Rollout collection and PPO re-evaluation for SMT (external-memory) policies.

PyTorch counterpart of ``avlen_tpu/rl/rollout_smt.py``. Collection: the JAX
``lax.scan`` becomes a Python loop over env steps; the ring memory lives in
the carry, and each step refreshes the beliefs before acting (reference
ppo_trainer.py:890-894), acts, inserts the step feature into the ring and
steps the env. The per-step outputs are stacked into a ``RolloutBatch``.

Re-evaluation replays the stored step features into the ring instead of
keeping the reference's T+1 memory snapshots
(savi/models/rollout_storage.py:145-173): ``reconstruct_memory_views`` gives
the closed-form index map from (step, env, slot) to the stored feature the
slot held, and ``batched_ring_eval`` gathers the views of ``chunk`` steps at
once and evaluates them as one (chunk·B)-row batch: at savi.yaml's shapes
(chunk 15, 8 envs a minibatch) one SMT encode of 120 rows.

The JAX package rematerialises each chunk in the backward pass
(``jax.checkpoint``). Here nothing is: what autograd keeps of a chunk is
small (the (chunk·B, M+1, F) entries the SMT encode saves, ~21 MB at
savi.yaml's shapes, ~210 MB a minibatch), so each chunk runs the SMT kernel
once forward and its plain version once in the backward: 80 kernel launches
an update at savi.yaml's 4 epochs × 2 minibatches × 10 chunks, where
rematerialising would make 160.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from avlen_tpu_torch.models.belief_predictor import BeliefState
from avlen_tpu_torch.models.memory import SMTMemory, insert, reset_where
from avlen_tpu_torch.rl.rollout import RolloutBatch, stack_steps


class SMTCarry(NamedTuple):
    env_state: Any
    obs: Dict[str, torch.Tensor]
    prev_action: torch.Tensor  # (B,)
    masks: torch.Tensor  # (B,) f32 — 0 at episode start
    memory: SMTMemory
    belief: BeliefState


@torch.no_grad()
def collect_rollout_smt(
    env_step: Callable,  # (env_state, actions) -> (env_state, StepOutput)
    act_fn: Callable,  # (obs, prev_a, mem_feats, mem_valid) -> (a, lp, v, x, logits)
    value_fn: Callable,  # (obs, prev_a, mem_feats, mem_valid) -> v
    belief_fn: Optional[Callable],  # (belief_state, obs, new_episode) -> (state, cat, loc)
    carry: SMTCarry,
    num_steps: int,
):
    """Returns (carry, RolloutBatch); the SMT extras ride in the stored obs
    under reserved keys: __prev_action, __feature."""
    initial_memory = carry.memory
    c = carry
    steps = []
    for _ in range(num_steps):
        new_ep = c.masks == 0
        memory = reset_where(c.memory, new_ep)
        prev_action = torch.where(new_ep, torch.zeros_like(c.prev_action), c.prev_action)
        obs = dict(c.obs)
        belief_state = c.belief
        if belief_fn is not None:
            belief_state, cat_belief, loc_belief = belief_fn(belief_state, obs, new_ep)
            obs["category_belief"] = cat_belief
            obs["location_belief"] = loc_belief

        action, logp, value, x, _ = act_fn(obs, prev_action, memory.features, memory.valid)
        memory = insert(memory, x)
        env_state, out = env_step(c.env_state, action)
        masks_next = 1.0 - out.done.float()
        steps.append(dict(
            obs={**obs, "__prev_action": prev_action, "__feature": x},
            actions=action,
            log_probs=logp,
            values=value,
            rewards=out.reward,
            masks=c.masks,
            dones=out.done,
            metrics=out.metrics,
        ))
        c = SMTCarry(env_state, out.obs, action, masks_next, memory, belief_state)

    # bootstrap value from the post-rollout state
    new_ep = c.masks == 0
    memory_b = reset_where(c.memory, new_ep)
    prev_a_b = torch.where(new_ep, torch.zeros_like(c.prev_action), c.prev_action)
    obs_b = dict(c.obs)
    if belief_fn is not None:
        _, cat_b, loc_b = belief_fn(c.belief, obs_b, new_ep)
        obs_b["category_belief"] = cat_b
        obs_b["location_belief"] = loc_b
    bootstrap = value_fn(obs_b, prev_a_b, memory_b.features, memory_b.valid)

    batch = RolloutBatch(
        **stack_steps(steps),
        initial_hidden=initial_memory,
        bootstrap_value=bootstrap,
    )
    return c, batch


def reconstruct_memory_views(
    initial_memory: SMTMemory,
    features_seq: torch.Tensor,  # (T, B, F) stored step features
    masks_seq: torch.Tensor,  # (T, B) 0 at episode start
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form ring replay: the index map from (step t, env b, slot j)
    to the feature slot j held when step t was evaluated.

    The sequential semantics (reset_where → evaluate → insert, each step)
    put in slot j at step t the stored feature of step ``s* = t-1 -
    ((t-1 - base_t - j) mod M)``, where ``base_t`` is the latest reset step
    r ≤ t (the ring restarts at slot 0 there), or ``-idx0`` when there was
    none (inserts continue the pre-rollout ring). A slot whose s* predates
    the episode segment holds the pre-rollout entry (segment 0 only, where
    the initial ring is still alive) or nothing.

    Returns ``(content_idx, valid)``: content_idx (T, B, M) long indices into
    ``cat([features_seq, initial ring slots, one zero row])`` along its
    (T+M+1)-long first axis, and valid (T, B, M) like memory.valid."""
    t_len, b = masks_seq.shape
    m = initial_memory.features.shape[1]
    steps = torch.arange(t_len, device=masks_seq.device)[:, None]  # (T, 1)

    reset_at = torch.where(masks_seq == 0, steps, -1)  # (T, B)
    r = torch.cummax(reset_at, dim=0).values  # latest reset step ≤ t, -1 if none
    has_reset = r >= 0
    base = torch.where(has_reset, r, -initial_memory.idx[None, :].long())
    seg_lo = r.clamp(min=0)  # first insert step visible at t

    j = torch.arange(m, device=masks_seq.device)[None, None, :]  # (1, 1, M)
    tm1 = steps[:, :, None] - 1  # (T, 1, 1)
    s_star = tm1 - torch.remainder(tm1 - base[:, :, None] - j, m)  # (T, B, M)
    ins_ok = s_star >= seg_lo[:, :, None]
    init_ok = (~has_reset)[:, :, None] & (initial_memory.valid > 0)[None, :, :] & ~ins_ok
    content_idx = torch.where(ins_ok, s_star, torch.where(init_ok, t_len + j, t_len + m))
    valid = (ins_ok | init_ok).to(initial_memory.valid.dtype)
    return content_idx, valid


def _tree_map(fn, tree):
    """fn over the tensors of nested dicts, tuples and lists (None kept)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _first_leaf(tree) -> torch.Tensor:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return next(x for x in (_first_leaf(v) for v in tree) if x is not None)
    return tree


def ring_eval_chunk(chunk: int, t_len: int) -> int:
    """The steps ``batched_ring_eval`` takes a batch: the largest divisor
    of ``t_len`` not above ``chunk``."""
    while t_len % chunk:
        chunk -= 1
    return chunk


def batched_ring_eval(
    eval_fn: Callable,  # (flat inputs, [(mem_feats, mem_valid), ...]) -> tuple of (C·B, ...)
    inputs,  # tensors (T, B, ...) in nested dicts/tuples, passed flattened to eval_fn
    memories: Sequence,  # (initial SMTMemory, features_seq (T,B,F), masks_seq (T,B)) each
    chunk: int = 15,
):
    """T-parallel ring-replay evaluation: each step's memory views are
    gathered from the stored features (reconstruct_memory_views) and
    ``eval_fn`` runs on (chunk·B)-row batches instead of T steps of B rows.
    ``chunk`` falls to the largest divisor of T not above it. Several ring
    memories are supported (the AVLEN interactive policies carry two).
    Returns eval_fn's outputs (a tuple) reshaped to (T, B, ...)."""
    t_len, b = _first_leaf(inputs).shape[:2]
    chunk = ring_eval_chunk(chunk, t_len)

    plans = []  # (pool (T+M+1, B, F) time-major, content_idx (T,B,M), valid (T,B,M))
    for mem0, feats, masks in memories:
        content_idx, valid = reconstruct_memory_views(mem0, feats, masks)
        pool = torch.cat([feats, mem0.features.transpose(0, 1), torch.zeros_like(feats[:1])], dim=0)
        plans.append((pool, content_idx, valid))
    env_ids = torch.arange(b, device=_first_leaf(inputs).device)[None, :, None]  # (1, B, 1)

    outs = []
    for s in range(0, t_len, chunk):
        views = []
        for pool, content_idx, valid in plans:
            idx_c = content_idx[s : s + chunk]
            m = idx_c.shape[-1]
            # the (C, B, M) index into the time-major pool gathers the views
            # in the C-major row order eval_fn consumes
            mem = pool[idx_c, env_ids]  # (C, B, M, F)
            views.append((mem.reshape(chunk * b, m, -1), valid[s : s + chunk].reshape(chunk * b, m)))
        flat = _tree_map(lambda x: x[s : s + chunk].reshape((chunk * b,) + x.shape[2:]), inputs)
        out = eval_fn(flat, views)
        outs.append(_tree_map(lambda x: x.reshape((chunk, b) + x.shape[1:]), out))
    return tuple(None if parts[0] is None else torch.cat(parts, dim=0) for parts in zip(*outs))


def _sensor_obs(obs_seq: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    # __feature stays in the step obs: evaluate_step_frozen consumes it (the
    # freeze_encoders path); the recompute path ignores it
    return {k: v for k, v in obs_seq.items() if not k.startswith("__") or k == "__feature"}


def evaluate_sequence_smt_batched(
    evaluate_step: Callable,  # (obs, prev_a, mem_feats, mem_valid, actions) -> (v, lp, ent, logits, x)
    obs_seq: Dict[str, torch.Tensor],  # (T, Bm, ...) with __prev_action/__feature
    initial_memory: SMTMemory,
    masks_seq: torch.Tensor,  # (T, Bm)
    actions_seq: torch.Tensor,  # (T, Bm)
    chunk: int = 15,
):
    """evaluate_sequence_smt, T-parallel (batched_ring_eval): the same
    per-step memory views as the sequential replay, the same outputs."""

    def eval_fn(inp, views):
        obs_f, pa_f, a_f = inp
        (mem, mem_valid), = views
        v, lp, ent, logits, _ = evaluate_step(obs_f, pa_f, mem, mem_valid, a_f)
        return v, lp, ent, logits

    return batched_ring_eval(
        eval_fn,
        (_sensor_obs(obs_seq), obs_seq["__prev_action"], actions_seq),
        [(initial_memory, obs_seq["__feature"], masks_seq)],
        chunk=chunk,
    )


def evaluate_sequence_smt(
    evaluate_step: Callable,  # (obs, prev_a, mem_feats, mem_valid, actions) -> (v, lp, ent, logits, x)
    obs_seq: Dict[str, torch.Tensor],  # (T, Bm, ...) with __prev_action/__feature
    initial_memory: SMTMemory,
    masks_seq: torch.Tensor,  # (T, Bm)
    actions_seq: torch.Tensor,  # (T, Bm)
):
    """PPO re-evaluation replaying the stored features into the ring one
    step at a time, as the JAX package does with ``batched_eval`` off; here
    the reference that ``evaluate_sequence_smt_batched`` is held to (the
    trainer re-evaluates batched only). Returns (values, log_probs,
    entropy, logits), each (T, Bm, ...)."""
    features = obs_seq["__feature"]
    sensor_obs = _sensor_obs(obs_seq)
    mem = initial_memory
    outs = []
    for t in range(masks_seq.shape[0]):
        mem = reset_where(mem, masks_seq[t] == 0)
        v, lp, ent, logits, _ = evaluate_step(
            {k: x[t] for k, x in sensor_obs.items()}, obs_seq["__prev_action"][t],
            mem.features, mem.valid, actions_seq[t],
        )
        mem = insert(mem, features[t])
        outs.append((v, lp, ent, logits))
    return tuple(torch.stack(x) for x in zip(*outs))
