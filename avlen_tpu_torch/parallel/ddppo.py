"""DD-PPO over a ``torch.distributed`` process group.

PyTorch counterpart of ``avlen_tpu/parallel/ddppo.py`` (reference
ss_baselines/savi/ddppo/algo/ddppo.py:49-100, ddppo_trainer.py:515-1200).
The JAX package runs (rollout → GAE → PPO) as one SPMD program under
``shard_map``, each device on its shard of the env slots, with a
``lax.pmean`` of the gradients inside every minibatch. Here each rank is a
process that owns env slots ``[r·B/n, (r+1)·B/n)`` (``env_slots``: the
trainers build the world for all B slots and keep their own rows of the
episode order; ``shard_pytree`` takes them from a global pytree), runs the same eager collect and update, and averages the
gradients with one flat ``all_reduce`` a minibatch
(``all_reduce_mean_grads``) between ``backward()`` and the clip + Adam
step, which is ``pmean``'s place in ``ppo_update``. ``DistributedDataParallel``
is not used: it would rename the parameters that checkpoints and the Flax
bridge key on, and its bucketing has no counterpart in the JAX program.

What stays as in JAX: parameters and optimizer states are the same on
every rank (broadcast from rank 0 after setup and resume, then kept equal
by the averaged gradients); advantage normalisation and the minibatch
permutations are per shard; the stats are averaged over ranks. What
differs: RNG is per rank by seeding each rank's generators at a fixed
stride (``rank_seed``), so rank 0 draws what one process draws; and the
batch a superstep returns stays rank-local (its observations are the bulk
of a rollout): ``gather_pytree`` assembles the leaves that a caller reads
over all B envs, as the trainers do for rank 0's episode window. The
TPU-only ``binder`` (asset banks as runtime arguments) and ``donate``
(buffer donation) have no counterpart, and neither have JAX's three
superstep constructors: the trainers build every loop on the one
``make_superstep`` (the mesh, or None for one process), since an eager
torch step composes its collect and update itself, where JAX's
``make_local_superstep``/``make_sharded_superstep``/``make_ddppo_step``
each set up a jitted or ``shard_map``-ped program.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, ContextManager, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from avlen_tpu_torch.parallel.mesh import Mesh
from avlen_tpu_torch.rl.ppo import identity_grad_reduce

# rank r seeds each generator at its single-process seed + RANK_SEED_STRIDE·r
RANK_SEED_STRIDE = 100_003


def rank_seed(seed: int, mesh: Optional[Mesh]) -> int:
    return seed + (RANK_SEED_STRIDE * mesh.rank if mesh is not None else 0)


# -- pytrees ---------------------------------------------------------------
def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves (tensors, arrays, anything not a dict, list or
    tuple) of ``tree`` and the same-shaped ``rest``; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _leaf_spec(shape, num_envs: int, num_steps: Optional[int]) -> Optional[int]:
    if num_steps is not None and len(shape) >= 2 and shape[0] == num_steps and shape[1] == num_envs:
        return 1  # time-major rollout tensor (T, B, ...)
    if len(shape) >= 1 and shape[0] == num_envs:
        return 0  # env-leading state tensor (B, ...)
    return None


def infer_env_specs(tree, num_envs: int, num_steps: Optional[int] = None):
    """The env axis of every leaf (JAX's PartitionSpec rule): 1 for
    time-major ``(T, B, ...)`` leaves, 0 for env-leading ``(B, ...)``
    leaves, None (replicated) for everything else, scalars and generators
    among them. Matching is by shape, as in JAX."""
    def spec(x):
        shape = getattr(x, "shape", None)
        return None if shape is None else _leaf_spec(tuple(shape), num_envs, num_steps)

    return tree_map(spec, tree)


def env_slots(num_envs: int, mesh: Mesh):
    """Rank ``mesh.rank``'s env slots ``[r·B/n, (r+1)·B/n)`` as (lo, hi)."""
    n = mesh.axis_size("data")
    if num_envs % n:
        raise ValueError(f"num_envs={num_envs} not divisible by mesh axis 'data' size {n}")
    per = num_envs // n
    return mesh.rank * per, (mesh.rank + 1) * per


def shard_pytree(tree, spec_tree, mesh: Mesh):
    """This rank's slice of every leaf along its env axis (a global pytree
    built on every rank → the rank-local one)."""
    def take(x, axis):
        if axis is None:
            return x
        lo, hi = env_slots(x.shape[axis], mesh)
        return x[lo:hi] if axis == 0 else x[:, lo:hi]

    return tree_map(take, tree, spec_tree)


def _comm(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` where the mesh's backend can gather it: gloo gathers host
    tensors only."""
    return x.cpu() if dist.get_backend() == "gloo" else x


def gather_pytree(tree, spec_tree, mesh: Mesh):
    """The global pytree on every rank: an ``all_gather`` of each leaf with
    an env axis, concatenated in rank order along it; leaves without one
    are returned as they are. Collective: every rank of the mesh calls it."""
    def gather(x, axis):
        if axis is None:
            return x
        src = _comm(x.contiguous(), mesh)
        parts = [torch.empty_like(src) for _ in range(mesh.axis_size("data"))]
        dist.all_gather(parts, src)
        return torch.cat(parts, dim=axis).to(x.device)

    return tree_map(gather, tree, spec_tree)


# -- collectives over parameters and stats ---------------------------------
def _flat_all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Average ``tensors`` over the mesh in place, one ``all_reduce`` per
    dtype of one flat buffer."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    n = mesh.axis_size("data")
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(n)
        for t, part in zip(group, torch.split(flat, [t.numel() for t in group])):
            t.copy_(part.view_as(t))


def all_reduce_mean_grads(params: Sequence[torch.nn.Parameter], mesh: Mesh) -> None:
    """``pmean`` of the gradients: the non-None ``.grad`` of ``params``
    averaged over the mesh's ranks in place. The same code on every rank
    gives every rank the same set of non-None gradients."""
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        _flat_all_reduce_mean(grads, mesh)


def make_grad_reduce(mesh: Optional[Mesh]) -> Callable:
    """The ``grad_reduce`` of ``ppo_update`` and its kin: the identity
    without a mesh, else ``all_reduce_mean_grads`` over it (the module's
    name, looked up at each call, so that a caller can time it)."""
    if mesh is None:
        return identity_grad_reduce
    return lambda params: all_reduce_mean_grads(params, mesh)


def all_reduce_mean_stats(stats: Dict[str, Any], mesh: Optional[Mesh]) -> Dict[str, Any]:
    """The stats dict's tensors averaged over the mesh (JAX's ``pmean`` of
    ``stats``); the identity without a mesh."""
    if mesh is None or not stats:
        return stats
    keys = list(stats)
    dev = next((v.device for v in stats.values() if isinstance(v, torch.Tensor)), torch.device("cpu"))
    flat = torch.stack([torch.as_tensor(stats[k], dtype=torch.float32, device=dev).reshape(()) for k in keys])
    _flat_all_reduce_mean([flat], mesh)
    return dict(zip(keys, flat.unbind()))


def broadcast_modules(modules: Sequence[Optional[torch.nn.Module]], mesh: Optional[Mesh]) -> None:
    """Every rank takes rank 0's parameters and buffers of ``modules``."""
    if mesh is None:
        return
    tensors = [t for m in modules if m is not None for t in (*m.parameters(), *m.buffers())]
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=0)
            for t, part in zip(group, torch.split(flat, [t.numel() for t in group])):
                t.copy_(part.view_as(t))


def any_rank(flag: bool, mesh: Optional[Mesh], device) -> bool:
    """True on every rank when ``flag`` is true on any (a preemption
    request, so that every rank stops at the same update)."""
    if mesh is None:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        dist.barrier()


# -- supersteps ------------------------------------------------------------
Timer = Optional[Callable[[str], ContextManager]]


def _untimed(name: str) -> ContextManager:
    return contextlib.nullcontext()


def make_superstep(collect: Callable, update: Callable, mesh: Optional[Mesh], timer: Timer = None) -> Callable:
    """(rollout → update) on this rank's env slots, with ``grad_reduce`` =
    ``all_reduce_mean_grads`` over ``mesh`` and the stats averaged over it;
    without a mesh, the identity ``grad_reduce`` and no collective (JAX's
    ``make_local_superstep``). ``collect(train_state, carry) -> (carry,
    batch)`` runs per env, with no collective; ``update(train_state, batch,
    key, grad_reduce) -> (train_state, stats)``. ``key`` (a
    ``torch.Generator`` for the minibatch permutations, or None for the
    caller's own) goes to ``update`` as it is: each rank's generators are
    seeded apart (``rank_seed``).

    Returns ``step_fn(train_state, carry, key=None) -> (train_state, carry,
    batch, stats)`` with ``batch`` rank-local. ``timer(name)``, when given,
    is a context around the collect (``"collect_time"``) and the update
    (``"update_time"``)."""
    timer = timer or _untimed
    grad_reduce = make_grad_reduce(mesh)

    def step_fn(train_state, carry, key=None):
        with timer("collect_time"):
            carry, batch = collect(train_state, carry)
        with timer("update_time"):
            train_state, stats = update(train_state, batch, key, grad_reduce)
            stats = all_reduce_mean_stats(stats, mesh)
        return train_state, carry, batch, stats

    return step_fn
