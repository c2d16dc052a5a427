from .ops import (KERNELS, bvss_pull, bvss_push, finalize_pack_sweep,
                  launch_counts, pull_vss_kernel, push_vss_kernel,
                  reset_launch_counts, use_kernel)
from . import ref

__all__ = ["KERNELS", "bvss_pull", "bvss_push", "finalize_pack_sweep",
           "launch_counts", "pull_vss_kernel", "push_vss_kernel",
           "reset_launch_counts", "use_kernel", "ref"]
