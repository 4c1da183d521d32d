"""Multi-process data parallelism of the port (counterpart of
unscene3d_tpu/parallel/distributed.py).

The JAX package runs one program per host over a 1-D `data` mesh of every
device, and its train step takes `lax.pmean` of the gradients, the losses
and the BatchNorm statistics. The port runs one process per rank instead,
one rank per card (or one rank on the CPU), joined by a `torch.distributed`
process group; `Trainer.train_step` all-reduces the same three things
(train/loop.py). The launch convention is the JAX package's, one command
per host:

  UNSCENE3D_COORDINATOR=host0:8476 \\
  UNSCENE3D_NUM_PROCESSES=2 \\
  UNSCENE3D_PROCESS_ID=<0..1> \\
  python -m unscene3d_torch.main_instance_segmentation ...

and a host with K visible cards runs K ranks (the entry point spawns them),
so the world is processes x K and a rank's global index is
`process_id * K + local_rank`. The backend is NCCL for CUDA and gloo for
the CPU. A group that fails to form raises; nothing drops to one rank.

Every rank draws the same global scene-id stream (one list per rank) and
keeps its own list (`local_slice`). The JAX package's
`global_batch_from_local` has no counterpart: each rank holds and feeds its
own batch, and no global array is assembled.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

# The process group's watchdog timeout. Rank 0 alone runs the validation,
# the test and the exports while the other ranks wait at a barrier: a
# ScanNet-val validation (312 scenes) takes minutes on one card, well under
# this. A collective that waits longer fails the run.
TIMEOUT = datetime.timedelta(minutes=60)


def free_port() -> int:
    """A TCP port on localhost that is free now (the rendezvous of the
    ranks of one host when no coordinator is given)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def env_processes() -> tuple[int, int]:
    """(UNSCENE3D_NUM_PROCESSES, UNSCENE3D_PROCESS_ID), (1, 0) when unset."""
    nproc = int(os.environ.get("UNSCENE3D_NUM_PROCESSES") or 1)
    pid = int(os.environ.get("UNSCENE3D_PROCESS_ID") or 0)
    if nproc < 1 or not 0 <= pid < nproc:
        raise ValueError(f"UNSCENE3D_PROCESS_ID={pid} with "
                         f"UNSCENE3D_NUM_PROCESSES={nproc}")
    return nproc, pid


def initialize_from_env(device, local_ranks: int = 1,
                        coordinator: str | None = None) -> bool:
    """Form the process group that the `UNSCENE3D_*` variables ask for.

    `device` is this rank's device: 'cuda:<local_rank>' (NCCL) or 'cpu'
    (gloo, one rank per process). `local_ranks` is the number of ranks this
    process's host runs; `coordinator` ("host:port") overrides
    UNSCENE3D_COORDINATOR. Returns True when a group of more than one rank
    was formed (or already exists); with one rank in all it is a no-op that
    returns False, as the JAX function does. Raises when the group cannot
    form."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    nproc, pid = env_processes()
    world = nproc * int(local_ranks)
    if world == 1:
        return False
    dev = torch.device(device)
    local_rank = (dev.index or 0) if dev.type == "cuda" else 0
    if dev.type == "cpu" and local_ranks != 1:
        raise ValueError("a CPU process runs one rank")
    if not 0 <= local_rank < local_ranks:
        raise ValueError(f"local rank {local_rank} of {local_ranks}")
    coord = coordinator or os.environ.get("UNSCENE3D_COORDINATOR")
    if not coord:
        raise ValueError(f"{world} ranks need UNSCENE3D_COORDINATOR "
                         "(host:port of process 0)")
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev           # NCCL forms its communicator now
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coord}", world_size=world,
        rank=pid * int(local_ranks) + local_rank, timeout=TIMEOUT, **kw)
    return True


def shutdown() -> None:
    """Destroy the process group, if one was formed."""
    if dist.is_initialized():
        dist.destroy_process_group()


def group():
    """The default process group, or None outside one."""
    return dist.group.WORLD if dist.is_initialized() else None


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Rank 0: the one rank that writes checkpoints, logs and exports and
    runs the evaluation."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op outside a group)."""
    if dist.is_initialized():
        dist.barrier()


def local_slice(per_rank_lists: list) -> list:
    """This rank's entry of a per-rank list (the per-shard scene-id lists
    every rank draws alike), as a list of one, which is the JAX function's
    slice for a host of one device. The input itself at world size 1."""
    world = world_size()
    if world == 1:
        return per_rank_lists
    if len(per_rank_lists) != world:
        raise ValueError(f"expected one entry per rank ({world}), got "
                         f"{len(per_rank_lists)}")
    r = rank()
    return per_rank_lists[r:r + 1]


def rank_seed(seed: int, rank: int) -> int:
    """The seed of `rank`'s own draws (augmentations, the collator's draws,
    the point samples): `seed` itself on rank 0, so that rank 0 of one rank
    is a single-process run bitwise; a 32-bit mix of both elsewhere."""
    if rank == 0:
        return int(seed)
    return (int(seed) + 0x9E3779B1 * int(rank)) % 2**32
