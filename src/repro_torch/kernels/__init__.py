from .ops import (KERNELS, bvss_pull, bvss_push, bvss_spmm,
                  bvss_spmm_minplus, bvss_spmm_minplus_local, bvss_spmm_t,
                  bvss_spmm_t_local, bvss_spmm_w, bvss_spmm_w_local,
                  finalize_pack_sweep, launch_counts, pull_vss_kernel,
                  push_vss_kernel, reset_launch_counts, use_kernel)
from . import ref

__all__ = ["KERNELS", "bvss_pull", "bvss_push", "bvss_spmm",
           "bvss_spmm_w", "bvss_spmm_t", "bvss_spmm_minplus",
           "bvss_spmm_w_local", "bvss_spmm_t_local", "bvss_spmm_minplus_local",
           "finalize_pack_sweep", "launch_counts", "pull_vss_kernel",
           "push_vss_kernel", "reset_launch_counts", "use_kernel", "ref"]
