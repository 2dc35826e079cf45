"""Multi-host start-up (counterpart of smmb_tpu/parallel/multihost.py).

One process per rank on each host; every process calls
``initialize_multihost`` once, before any collective, with the TCP address
of the coordinator (rank 0's host and a free port), the process count and
its own index, and the backend ("nccl" between cards, "gloo" on CPUs).
Nothing in a machine tells a program of its cluster, so every argument is
explicit. Afterwards ``parallel.mesh.make_mesh`` builds the same meshes
over the whole world, and every function of the parallel layer runs
unchanged across the hosts.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist


def initialize_multihost(coordinator_address: str, num_processes: int, process_id: int, *,
                         backend: str, timeout_s: float = 600.0) -> dict:
    """``init_process_group`` over a TCP coordinator ("host:port"); returns
    a summary for logging. A second call in an initialised process changes
    nothing; a failure to reach the coordinator raises (it never falls back
    to a one-process world)."""
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s))
    local = torch.cuda.device_count() if backend == "nccl" else 1
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": local,
        "global_devices": dist.get_world_size(),
        "backend": str(dist.get_backend()),
    }


def is_primary() -> bool:
    """True on the process that should write artifacts and logs (rank 0,
    or a process with no world)."""
    return not dist.is_initialized() or dist.get_rank() == 0
