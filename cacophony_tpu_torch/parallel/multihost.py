"""Process-group initialization for runs over several processes
(cacophony_tpu/parallel/multihost.py).

One process drives one device.  `initialize_multihost()` joins the
process group once per process, before any mesh is built; `make_mesh`
then spans every rank.  Launch with torchrun, which sets the rendezvous in
the environment:

    torchrun --nproc-per-node N -m cacophony_tpu_torch.train.runner ... --dp N
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _info() -> dict:
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {"process_index": dist.get_rank() if dist.is_initialized() else 0,
            "process_count": count, "local_devices": 1, "global_devices": count}


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *, device="cuda") -> dict:
    """`torch.distributed.init_process_group` (NCCL for a CUDA device, gloo
    for the CPU) with the rendezvous from the arguments or from torchrun's
    environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE; LOCAL_RANK
    picks this process's card).  `coordinator_address` is "host:port", a
    "tcp://" or a "file://" URL.

    With no coordinator and no environment the initialization is skipped
    when one process is expected (`num_processes` None or 1), and raises
    otherwise.  A group that is already initialized is kept.  Any other
    failure of the rendezvous raises: a run over several processes never
    degrades into separate single-process runs.

    → {process_index, process_count, local_devices, global_devices}: this
    rank, the world size, the devices this process drives (one), and the
    devices of the group (one a rank)."""
    if dist.is_initialized():
        return _info()
    env = all(k in os.environ for k in _ENV)
    if coordinator_address is None and not env:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes expected, but no coordinator address "
                             f"was given and {', '.join(_ENV)} are not all set")
        return _info()
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError('initialize_multihost on cuda: no CUDA device; pass device="cpu"')
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    init = "env://"
    if coordinator_address is not None:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    world = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init,
                            world_size=world, rank=rank)
    return _info()
