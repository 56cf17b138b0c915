"""Process-group bring-up and the data-parallel mesh.

PyTorch counterpart of ``avlen_tpu/parallel/mesh.py`` (reference
ss_baselines/savi/ddppo/algo/ddp_utils.py:129-182). The JAX package builds
a ``jax.sharding.Mesh`` over the devices of one SPMD program; here each
rank of a ``torch.distributed`` group is one process that holds its own
slice of the env slots, so a mesh is a small description (axis names,
shape, this process's rank, the world size) with the same arithmetic.

Backend rule: NCCL when every rank of the node has a card of its own, gloo
otherwise, i.e. for two ranks on one card (NCCL refuses two ranks on one
GPU) and for the CPU. ``RL.DDPPO.distrib_backend`` keeps the value the
config tree copies from the JAX package and is not read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The first ``size`` ranks of the process group, laid out as ``shape``
    over ``axis_names``; ``rank`` is this process's. The collectives of
    ``parallel/ddppo.py`` run over the default group, so a mesh they use
    spans every rank (the trainers refuse a smaller one)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    world_size: int

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(axis_names: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None,
              world_size: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """JAX's ``make_mesh`` over ranks: ``shape`` defaults to all ranks on
    the first axis, a -1 takes what the fixed axes leave, and a fixed shape
    uses the first ``prod(shape)`` ranks."""
    cur_rank, cur_world = world()
    n = cur_world if world_size is None else int(world_size)
    if shape is None:
        shape = [-1] + [1] * (len(axis_names) - 1)
    shape = [int(s) for s in shape]
    if -1 in shape:
        fixed = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = max(n // max(fixed, 1), 1)
    return Mesh(tuple(axis_names), tuple(shape), cur_rank if rank is None else int(rank), n)


def backend_for(device_type: str) -> str:
    """NCCL when each local rank has a card of its own, else gloo."""
    if device_type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def rank_device(device_type: str) -> Union[str, torch.device]:
    """The device of this process: ``cuda:{LOCAL_RANK % device_count}``
    under torchrun, else ``device_type`` as given."""
    if device_type == "cuda" and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    return device_type


def init_distributed_if_needed(device_type: str = "cuda", init_method: str = "env://") -> Tuple[int, int]:
    """Join the process group that torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``): a no-op
    without them, or when a group exists already, as JAX's is without
    ``JAX_COORDINATOR_ADDRESS``. Returns (rank, world size)."""
    if dist.is_initialized() or "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return world()
    backend = backend_for(device_type)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device_type))
    dist.init_process_group(backend, init_method=init_method, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return world()


@contextlib.contextmanager
def joined_process_group(device_type: str = "cuda") -> Iterator[int]:
    """``init_distributed_if_needed`` for the block, yielding this rank; a
    group joined here is left at the block's end (one made by the caller
    stays)."""
    joined = not dist.is_initialized()
    rank, _ = init_distributed_if_needed(device_type)
    try:
        yield rank
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()
