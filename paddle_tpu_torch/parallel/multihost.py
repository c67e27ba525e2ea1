"""Process-group initialization (the counterpart of
paddle_tpu/parallel/multihost.py).

The JAX package rendezvouses hosts with `jax.distributed.initialize`; the
port runs one process per device and joins them with
`torch.distributed.init_process_group`: NCCL on the cards, gloo on the CPU.
Rank, world size and the rendezvous come from the arguments or from the
launcher's environment as torchrun sets it (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR / MASTER_PORT), else from the fluid-style
PADDLE_TRAINER_ENDPOINTS / PADDLE_TRAINER_ID. The rendezvous is retried
FLAGS_dist_init_max_retry times, with decorrelated jitter seeded by the
rank, so a whole restarted job does not retry in lockstep.
"""

import os
import random
import time

import torch
import torch.distributed as dist

__all__ = ["barrier", "host_count", "host_index", "init_distributed"]


def host_count():
    """Processes in the job: the process group's world size once joined,
    else WORLD_SIZE or the PADDLE_TRAINER_ENDPOINTS list length."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if os.environ.get("WORLD_SIZE"):
        return int(os.environ["WORLD_SIZE"])
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    return len(eps.split(",")) if eps else 1


def host_index():
    """This process's rank: the process group's once joined, else RANK or
    PADDLE_TRAINER_ID."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK") or os.environ.get("PADDLE_TRAINER_ID") or 0)


def barrier():
    """Wait for every rank of the process group (none: return)."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def init_distributed(init_method=None, world_size=None, rank=None, backend=None,
                     store=None, timeout_s=None):
    """Join the job's process group once; a second call returns at once.
    `backend` None takes NCCL where CUDA is available and gloo otherwise;
    under NCCL the process takes CUDA device LOCAL_RANK (else rank modulo
    the visible cards) first. A world of one with neither a store nor an
    init method needs no rendezvous and joins nothing. Returns (rank,
    world_size)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if world_size is None:
        world_size = host_count()
    if rank is None:
        rank = host_index()
    if init_method is None and store is None:
        if os.environ.get("MASTER_ADDR"):
            init_method = "env://"
        else:
            eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
            if eps:
                init_method = "tcp://" + eps.split(",")[0]
    if init_method is None and store is None:
        if world_size > 1:
            raise ValueError("init_distributed: a world of %d needs an init method, a store "
                             "or the launcher's environment" % world_size)
        return 0, 1
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    from .. import flags as _flags
    from ..resilience import health as _health

    attempts = int(_flags.get_flags("dist_init_max_retry")["dist_init_max_retry"]) + 1
    kwargs = dict(backend=backend, world_size=world_size, rank=rank)
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = init_method
    if timeout_s is not None:
        import datetime

        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    rng = random.Random(rank)
    delay = 0.5
    for attempt in range(attempts):
        try:
            dist.init_process_group(**kwargs)
            return rank, world_size
        except (RuntimeError, ConnectionError, OSError):
            if attempt + 1 == attempts:
                raise
            _health.incr("dist_init_retries")
            # decorrelated jitter: between the base and three times the last
            delay = min(5.0, rng.uniform(0.5, delay * 3))
            time.sleep(delay)
    raise AssertionError("unreachable")
