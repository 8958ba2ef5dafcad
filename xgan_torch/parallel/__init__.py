"""Data and tensor parallelism across ranks (role of xgan/parallel)."""
from xgan_torch.parallel.mesh import MeshContext, all_reduce_grads, \
    all_reduce_sum, init_from_env, shutdown

__all__ = ["MeshContext", "all_reduce_grads", "all_reduce_sum",
           "init_from_env", "shutdown"]
