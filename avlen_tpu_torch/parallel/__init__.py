from avlen_tpu_torch.parallel.ddppo import (
    all_reduce_mean_grads,
    gather_pytree,
    infer_env_specs,
    make_superstep,
    shard_pytree,
)
from avlen_tpu_torch.parallel.mesh import init_distributed_if_needed, make_mesh

__all__ = [
    "make_mesh",
    "init_distributed_if_needed",
    "all_reduce_mean_grads",
    "gather_pytree",
    "infer_env_specs",
    "make_superstep",
    "shard_pytree",
]
