"""Run a function on gloo ranks of the CPU for the port's DD-PPO tests.

``run_ranks(fn, world, tmp_path, *args)`` spawns ``world`` processes
(``torch.multiprocessing.spawn``), joins each to a gloo group through a
``file://`` rendezvous in ``tmp_path`` (no TCP port, so parallel test
workers cannot collide), with torchrun's environment variables set as the
port reads them, calls ``fn(rank, *args)`` and returns every rank's result
in rank order. ``fn`` must be importable by name: the children import its
module afresh, so keep it in a module that does not import JAX.
"""

import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, init_file, out_dir, fn, args):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    try:
        result = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def run_ranks(fn, world, tmp_path, *args):
    out_dir = os.path.join(str(tmp_path), "ranks")
    os.makedirs(out_dir, exist_ok=True)
    init_file = os.path.join(str(tmp_path), "rendezvous")
    mp.spawn(_entry, args=(world, init_file, out_dir, fn, args), nprocs=world, join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(world)]


# -- rank programs of tests/test_torch_ddppo.py ----------------------------
def grads_rank(rank, params, obs, actions, adv):
    """The gradient of -mean(log π(a|o)·adv) on this rank's half of the
    batch, averaged over the ranks by ``all_reduce_mean_grads``."""
    from avlen_tpu_torch.parallel.ddppo import all_reduce_mean_grads, env_slots
    from avlen_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    lo, hi = env_slots(obs.shape[0], mesh)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    o, a, ad = (torch.as_tensor(x[lo:hi]) for x in (obs, actions, adv))
    logits = o @ p["w"] + p["b"]
    lp = torch.log_softmax(logits, -1)[torch.arange(o.shape[0]), a.long()]
    (-(lp * ad).mean()).backward()
    all_reduce_mean_grads(list(p.values()), mesh)
    return {k: v.grad.numpy() for k, v in p.items()}


def gru_ppo_rank(rank, flax_params, net_kwargs, batch, perms, ppo_kwargs):
    """One ``ppo_update`` of the AV-Nav policy (the GRU stack) from
    ``flax_params`` on this rank's env slots of ``batch`` (numpy, time-major;
    ``adv``/``ret`` global), with this rank's permutations and the mesh's
    ``grad_reduce``; the stats averaged over ranks. Returns (the policy's
    Flax tree, stats)."""
    from avlen_tpu_torch.models.policy import AudioNavBaselineNet, Policy
    from avlen_tpu_torch.parallel.ddppo import all_reduce_mean_stats, env_slots, make_grad_reduce
    from avlen_tpu_torch.parallel.mesh import make_mesh
    from avlen_tpu_torch.rl.ppo import PPOConfig, make_optimizer, ppo_update
    from avlen_tpu_torch.rl.rollout import RolloutBatch
    from avlen_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_params

    mesh = make_mesh()
    policy = Policy(AudioNavBaselineNet(**net_kwargs), 4)
    load_flax_params(policy, flax_params)
    cfg = PPOConfig(**ppo_kwargs)
    opt = make_optimizer(policy.parameters(), cfg)
    lo, hi = env_slots(batch["actions"].shape[1], mesh)

    def t(x):
        return torch.as_tensor(x[:, lo:hi])

    local = RolloutBatch(obs={k: t(v) for k, v in batch["obs"].items()}, actions=t(batch["actions"]).long(),
                         log_probs=t(batch["log_probs"]), values=t(batch["values"]), rewards=t(batch["rewards"]),
                         masks=t(batch["masks"]), dones=t(batch["dones"]), metrics={},
                         initial_hidden=torch.as_tensor(batch["initial_hidden"][lo:hi]),
                         bootstrap_value=torch.as_tensor(batch["bootstrap_value"][lo:hi]))
    stats = ppo_update(local, t(batch["adv"]), t(batch["ret"]), policy.evaluate_actions, opt, cfg,
                       perms=[torch.as_tensor(p) for p in perms[rank]], grad_reduce=make_grad_reduce(mesh))
    stats = all_reduce_mean_stats(stats, mesh)
    return to_flax_params(policy), {k: float(v) for k, v in stats.items()}
