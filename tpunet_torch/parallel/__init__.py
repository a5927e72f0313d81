"""Parallelism over ``torch.distributed``: the process group, rank and
device binding, barriers and the counted collectives (``dist``, port of
``tpunet/parallel/dist.py``), the process mesh and its axis groups
(``mesh``) and the rule table of tensor parallelism, ZeRO-1 and FSDP
(``tp``, expert parallelism's rules included); sequence parallelism's
differentiable hops and all-to-alls, and expert parallelism's
``gather_from_group``, are in ``dist``; pipeline parallelism's schedule
tables and per-rank executor are in ``pp``, its hops
(``dist.pipe_hop``) in ``dist``."""

from tpunet_torch.parallel.dist import (all_reduce, all_reduce_sum,  # noqa: F401
                                        destroy, initialize_distributed,
                                        is_initialized, local_device,
                                        process_count, process_index,
                                        sync_hosts)
