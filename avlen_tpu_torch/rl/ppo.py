"""PPO update: clipped surrogate, clipped value loss and entropy bonus.

PyTorch counterpart of ``avlen_tpu/rl/ppo.py`` (reference
ss_baselines/savi/ppo/ppo.py:157-289): per-epoch minibatches of env slots,
the clipped importance-ratio surrogate, the clipped value loss (0.5 × the
larger of the clipped and unclipped squared errors), the entropy bonus,
optional advantage normalisation, and Adam(lr, eps) behind global-norm
clipping. The JAX package runs the whole update as one jit; here it is an
eager loop of ``ppo_epoch × num_mini_batch`` optimizer steps.

The optimizer keeps optax's arithmetic where it differs from PyTorch's
habit: the gradients are scaled by ``max_norm/‖g‖`` only when ``‖g‖ ≥
max_norm`` (``optax.clip_by_global_norm``; ``clip_grad_norm_`` scales by
``max_norm/(‖g‖ + 1e-6)`` always), and the linear learning-rate decay is
evaluated at the count of optimizer steps taken before the step
(``optax.linear_schedule``), over a horizon of ``NUM_UPDATES × ppo_epoch ×
num_mini_batch`` steps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

from avlen_tpu_torch.rl.rollout import RolloutBatch


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    clip_param: float = 0.2
    ppo_epoch: int = 4
    num_mini_batch: int = 2
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.01
    lr: float = 7e-4
    eps: float = 1e-5
    max_grad_norm: float = 0.5
    gamma: float = 0.99
    tau: float = 0.95
    use_gae: bool = True
    use_normalized_advantage: bool = False
    use_clipped_value_loss: bool = True
    # linear decay to 0 over lr_decay_steps OPTIMIZER steps (reference:
    # LambdaLR with linear_decay(update, NUM_UPDATES), ppo_trainer.py:1176-1178)
    use_linear_lr_decay: bool = False
    lr_decay_steps: int = 0


def ppo_config_from(config) -> PPOConfig:
    """PPOConfig from a config tree; the decay horizon counts the configured
    num_mini_batch, not the one a small batch caps it to (as the JAX
    package's ``ppo_config_from`` does)."""
    p = config.RL.PPO
    return PPOConfig(
        clip_param=p.clip_param,
        ppo_epoch=p.ppo_epoch,
        num_mini_batch=p.num_mini_batch,
        value_loss_coef=p.value_loss_coef,
        entropy_coef=p.entropy_coef,
        lr=p.lr,
        eps=p.eps,
        max_grad_norm=p.max_grad_norm,
        gamma=p.gamma,
        tau=p.tau,
        use_gae=p.use_gae,
        use_normalized_advantage=p.use_normalized_advantage,
        use_linear_lr_decay=p.use_linear_lr_decay,
        lr_decay_steps=config.NUM_UPDATES * p.ppo_epoch * p.num_mini_batch,
    )


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by max_norm/‖g‖ where ‖g‖ ≥ max_norm, as
    ``optax.clip_by_global_norm``; returns ‖g‖ before clipping. No host sync."""
    norm = torch.nn.utils.get_total_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


class _PPOOptimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, eps))``,
    with ``lr`` a linear schedule under ``use_linear_lr_decay``. Parameters
    whose gradient is None (frozen towers) are left as they are, as Adam
    leaves a parameter whose gradient is always zero. Made by
    ``make_optimizer``."""

    def __init__(self, params: Iterable[torch.nn.Parameter], config: PPOConfig):
        self.config = config
        self.params = [p for p in params if p.requires_grad]
        self.adam = torch.optim.Adam(self.params, lr=config.lr, eps=config.eps)
        self.count = 0  # optimizer steps taken

    def lr(self) -> float:
        """The learning rate of the next step."""
        c = self.config
        if c.use_linear_lr_decay and c.lr_decay_steps > 0:
            return c.lr * (1.0 - min(self.count, c.lr_decay_steps) / c.lr_decay_steps)
        return c.lr

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip, then one Adam step; returns the gradient norm before clipping."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = clip_by_global_norm_(grads, self.config.max_grad_norm)
        for group in self.adam.param_groups:
            group["lr"] = self.lr()
        self.adam.step()
        self.count += 1
        return norm


def make_optimizer(params: Iterable[torch.nn.Parameter], config: PPOConfig) -> _PPOOptimizer:
    return _PPOOptimizer(params, config)


def optimizer_params(optimizer) -> Sequence[torch.nn.Parameter]:
    """The parameters an optimizer steps: ``make_optimizer``'s ``params``,
    or a ``torch.optim`` optimizer's param groups."""
    if isinstance(optimizer, _PPOOptimizer):
        return optimizer.params
    return [p for group in optimizer.param_groups for p in group["params"]]


def identity_grad_reduce(params: Sequence[torch.nn.Parameter]) -> None:
    """The default ``grad_reduce``: one process, nothing to average. DD-PPO
    passes ``parallel.ddppo.all_reduce_mean_grads`` over its mesh, which
    averages the parameters' ``.grad`` in place (JAX's ``lax.pmean``)."""


def ppo_loss(
    evaluate_actions: Callable,  # (obs (T,Bm,..), h0, masks, actions) -> (v, lp, ent, logits)
    obs,
    actions: torch.Tensor,
    old_log_probs: torch.Tensor,
    initial_hidden,
    masks: torch.Tensor,
    returns: torch.Tensor,
    advantages: torch.Tensor,
    old_values: torch.Tensor,
    config: PPOConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    values, log_probs, entropy, _ = evaluate_actions(obs, initial_hidden, masks, actions)

    ratio = torch.exp(log_probs - old_log_probs)
    surr1 = ratio * advantages
    surr2 = torch.clamp(ratio, 1.0 - config.clip_param, 1.0 + config.clip_param) * advantages
    action_loss = -torch.minimum(surr1, surr2).mean()

    if config.use_clipped_value_loss:
        value_pred_clipped = old_values + torch.clamp(values - old_values, -config.clip_param, config.clip_param)
        vl1 = (values - returns) ** 2
        vl2 = (value_pred_clipped - returns) ** 2
        value_loss = 0.5 * torch.maximum(vl1, vl2).mean()
    else:
        value_loss = 0.5 * ((returns - values) ** 2).mean()

    ent = entropy.mean()
    total = value_loss * config.value_loss_coef + action_loss - ent * config.entropy_coef
    return total, {"value_loss": value_loss, "action_loss": action_loss, "entropy": ent}


def _select0(hidden, idx: torch.Tensor):
    """Env slots ``idx`` of an initial hidden state whose env dim is axis 0
    (a tensor or a NamedTuple of them, such as the SMT ring memory)."""
    if isinstance(hidden, torch.Tensor):
        return hidden.index_select(0, idx)
    return type(hidden)(*(_select0(x, idx) for x in hidden))


def ppo_update(
    batch: RolloutBatch,
    advantages: torch.Tensor,  # (T, B)
    returns: torch.Tensor,  # (T, B)
    evaluate_actions: Callable,  # (obs (T,Bm,..), h0, masks, actions) -> (v, lp, ent, logits)
    optimizer: _PPOOptimizer,
    config: PPOConfig,
    generator: Optional[torch.Generator] = None,
    perms: Optional[Sequence] = None,
    grad_reduce: Callable = identity_grad_reduce,
) -> Dict[str, torch.Tensor]:
    """One PPO update in place on the optimizer's parameters. Each epoch
    draws a fresh permutation of the B env slots from ``generator`` (a CPU
    generator), or takes ``perms[epoch]``, and cuts it into ``min(
    num_mini_batch, B)`` minibatches of ``B // that`` slots. Each
    minibatch's gradients go through ``grad_reduce`` (the optimizer's
    parameters) before the clip and the Adam step, as in JAX. Returns the
    losses averaged over the ``ppo_epoch × num_mb`` steps, as tensors."""
    t, b = batch.actions.shape
    num_mb = min(config.num_mini_batch, b)
    mb_size = b // num_mb
    dev = batch.actions.device

    adv = advantages
    if config.use_normalized_advantage:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-5)

    sums = {k: torch.zeros((), device=dev) for k in ("value_loss", "action_loss", "entropy")}
    for e in range(config.ppo_epoch):
        perm = perms[e] if perms is not None else torch.randperm(b, generator=generator)
        perm = torch.as_tensor(perm, device=dev).long()
        for m in range(num_mb):
            idx = perm[m * mb_size : (m + 1) * mb_size]

            def sel(x):
                return x.index_select(1, idx)

            optimizer.zero_grad()
            loss, aux = ppo_loss(
                evaluate_actions,
                {k: sel(v) for k, v in batch.obs.items()},
                sel(batch.actions),
                sel(batch.log_probs),
                _select0(batch.initial_hidden, idx),
                sel(batch.masks),
                sel(returns),
                sel(adv),
                sel(batch.values),
                config,
            )
            loss.backward()
            grad_reduce(optimizer_params(optimizer))
            optimizer.step()
            for k in sums:
                sums[k] += aux[k].detach()
    n = config.ppo_epoch * num_mb
    return {k: v / n for k, v in sums.items()}
