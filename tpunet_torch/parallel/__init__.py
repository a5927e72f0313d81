"""Data parallelism over ``torch.distributed``: the process group, rank
and device binding, barriers and the counted all-reduces (``dist``),
port of ``tpunet/parallel/dist.py``. TP, FSDP, ZeRO-1, SP, PP and MoE
come with ROADMAP Queue A item 8."""

from tpunet_torch.parallel.dist import (all_reduce, all_reduce_sum,  # noqa: F401
                                        destroy, initialize_distributed,
                                        is_initialized, local_device,
                                        process_count, process_index,
                                        sync_hosts)
