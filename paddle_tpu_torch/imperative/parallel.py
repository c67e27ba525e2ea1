"""Eager data parallelism: ParallelEnv + DataParallel over torch.distributed
(the torch counterpart of paddle_tpu/imperative/parallel.py; reference
python/paddle/fluid/dygraph/parallel.py).

The JAX package drives every local device from one process, and its
partitioner makes the gradients global, so there `scale_loss` is the
identity and `apply_collective_grads` a no-op. The port runs one process a
card over torch.distributed, so:

- `ParallelEnv.nranks` is the world size and `local_rank` the rank (1 and
  0 without a process group); `local_device_count` is 1 and
  `data_parallel_degree` the world size. Each rank takes its chunk of the
  data (`chunks[local_rank]` of `nranks`, the reference's recipe);
- `DataParallel` broadcasts rank 0's parameters when it wraps a layer;
- `apply_collective_grads` all-reduces each parameter's gradient (a sum)
  and divides it by the world size; `scale_loss` stays the identity.

So with a loss that is a mean over equal chunks, the parameters after a
step equal the one-process run on the whole batch (the JAX contract). A
summed loss, or chunks of unequal size, gives the mean of the ranks'
gradients instead, which is not the whole batch's. At world 1 every call
is the wrapped layer's, bit for bit.
"""

import torch.distributed as dist

from .layers import Layer

__all__ = ["ParallelEnv", "Env", "prepare_context", "DataParallel"]


def _group():
    """(world size, rank) of the default process group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ParallelEnv:
    """Rank layout (reference dygraph/parallel.py Env): `nranks` processes,
    this one `local_rank`, one device each."""

    def __init__(self, devices=None):
        self.nranks, self.local_rank = _group()
        self.local_device_count = 1
        self.data_parallel_degree = self.nranks
        dev = devices[0] if devices else None
        self.dev_id = int(getattr(dev, "index", None) or 0)
        self.current_endpoint = ""
        self.trainer_endpoints = []


Env = ParallelEnv  # the reference exposed both names


class _ParallelStrategy:
    def __init__(self, env):
        self.nranks = env.nranks
        self.local_rank = env.local_rank
        self.trainer_endpoints = env.trainer_endpoints
        self.current_endpoint = env.current_endpoint


def prepare_context(strategy=None, devices=None):
    """The reference's prepare_context booted NCCL communicators; here the
    process group (parallel.init_distributed) already exists, so this
    reports the layout."""
    return strategy or _ParallelStrategy(ParallelEnv(devices))


class DataParallel(Layer):
    """Wrap an eager Layer for data-parallel training over the process group
    (reference dygraph/parallel.py DataParallel):

        model = DataParallel(MyLayer(...))
        loss = model(x_chunk, y_chunk)   # this rank's chunk of the batch
        loss.backward()
        model.apply_collective_grads()   # the mean of the ranks' grads
        optimizer.step()
    """

    def __init__(self, layers, strategy=None, devices=None):
        super().__init__()
        self._layers = layers
        self._strategy = strategy
        self._world, _ = _group()
        if self._world > 1:
            # every rank starts from rank 0's parameters
            for p in layers.parameters():
                dist.broadcast(p.value, 0)

    def parameters(self):
        return self._layers.parameters()

    def __call__(self, *inputs):
        return self._layers(*inputs)

    def forward(self, *args):  # pragma: no cover - __call__ overrides
        return self._layers.forward(*args)

    def scale_loss(self, loss):
        """The identity: apply_collective_grads averages the summed
        gradients, so each rank's loss stays its chunk's mean."""
        return loss

    def apply_collective_grads(self):
        """All-reduce every parameter's gradient over the group and divide it
        by the world size (a no-op at world 1)."""
        if self._world == 1:
            return None
        for p in self._layers.parameters():
            if p._grad is None:
                continue
            g = p._grad.contiguous().clone()
            dist.all_reduce(g)
            p._grad = g / self._world
        return None
