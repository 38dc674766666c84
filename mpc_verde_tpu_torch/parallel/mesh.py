"""Process groups and multi-host init (port of ``mpc_verde_tpu.parallel.mesh``).

The reference is strictly single-process CPU (SURVEY.md §2.4); the rebuild's
scale axis is one batch axis: thousands of independent MPC instances split
across processes, one process per card, with only scalar reductions
(convergence counts, cost sums) crossing the interconnect.  The JAX package
builds a 1-D device mesh; here the same axis is a ``torch.distributed``
process group: NCCL between CUDA devices, gloo between CPU processes.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

BATCH_AXIS = "batch"


def default_backend() -> str:
    """"nccl" where a CUDA device is present, "gloo" elsewhere."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def local_rank() -> int:
    """This process's index among the processes of its host:
    ``LOCAL_RANK`` when set (torchrun sets it), else the global rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(backend: Optional[str] = None) -> torch.device:
    """The device of this rank: ``cuda:{local_rank}`` under NCCL (made the
    current CUDA device), the CPU under gloo."""
    backend = backend or (dist.get_backend() if dist.is_initialized()
                          else default_backend())
    if backend == "nccl":
        dev = torch.device("cuda", local_rank())
        torch.cuda.set_device(dev)
        return dev
    return torch.device("cpu")


def distributed_init(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None, store=None):
    """Start ``torch.distributed`` (the JAX package's
    ``jax.distributed.initialize``) and return the default group.

    The arguments are explicit (``init_method`` such as
    ``"tcp://localhost:29500"`` or ``"file:///path"``, or a ``store``, with
    ``world_size`` and ``rank``), or read from the usual environment
    (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``, as
    torchrun sets them).  ``backend`` None is NCCL where a CUDA device is
    present and gloo elsewhere; under NCCL the rank's device is
    ``cuda:{local_rank}``.  Safe to call when already initialized: it
    returns the running group.
    """
    if dist.is_initialized():
        return dist.group.WORLD
    backend = backend or default_backend()
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if init_method is None and store is None:
        if "MASTER_ADDR" not in os.environ:
            raise ValueError(
                "distributed_init: give init_method or store with world_size "
                "and rank, or set MASTER_ADDR, MASTER_PORT, WORLD_SIZE and "
                "RANK")
        init_method = "env://"
    if world_size is None or rank is None:
        raise ValueError("distributed_init: world_size and rank are needed")
    if backend == "nccl":
        os.environ.setdefault("LOCAL_RANK", str(rank % torch.cuda.device_count()))
        rank_device("nccl")
    dist.init_process_group(backend, init_method=init_method, store=store,
                            world_size=world_size, rank=rank)
    return dist.group.WORLD


def batch_group(n_devices: Optional[int] = None):
    """The group of the first ``n_devices`` ranks (default: all of them),
    the counterpart of the JAX package's 1-D ``batch_mesh``.  Every rank
    must call it (``new_group`` is collective); a rank outside the group
    gets ``GroupMember.NON_GROUP_MEMBER``."""
    if not dist.is_initialized():
        raise RuntimeError("batch_group: call distributed_init first")
    n = dist.get_world_size()
    if n_devices is None or n_devices == n:
        return dist.group.WORLD
    if n_devices > n:
        raise ValueError(f"requested {n_devices} ranks but the world has {n}")
    return dist.new_group(ranks=list(range(n_devices)))


batch_mesh = batch_group   # the JAX package's name
