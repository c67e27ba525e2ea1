"""Mesh construction over torch.distributed (the counterpart of
paddle_tpu/parallel/mesh.py).

The JAX package builds one `jax.sharding.Mesh` of devices and jits one
program over it. The port runs one process per device: `make_mesh` builds a
`torch.distributed.device_mesh.DeviceMesh` over the process group's ranks,
axes in the JAX order (dp outermost), and hands back this rank's view of it,
a `Mesh`: each axis's extent (`shape`, as the JAX mesh's), this rank's
index on it and the process group of the ranks that differ from it on that
axis alone. Without a process group the mesh is the one local device, as
the JAX ParallelExecutor uses every local device, and every axis has
extent 1.

fsdp, tp and pp above 1 raise: the sharding rules and the pipeline come
with ROADMAP A6b.
"""

import threading

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["AXES", "Mesh", "MeshConfig", "current_mesh", "make_mesh"]

AXES = ("dp", "fsdp", "tp", "sp", "ep", "pp")

# the axes whose layouts come with ROADMAP A6b
_A6B = {"fsdp": "the fsdp sharding rules (parallel/sharding_rules.py)",
        "tp": "the tp sharding rules (parallel/sharding_rules.py)",
        "pp": "the pipeline (parallel/pipeline.py)"}


class MeshConfig:
    """Named mesh-axis sizes. size=-1 on one axis means 'all remaining
    devices'."""

    def __init__(self, dp=-1, fsdp=1, tp=1, sp=1, ep=1, pp=1):
        self.axes = {
            "dp": dp, "fsdp": fsdp, "tp": tp, "sp": sp, "ep": ep, "pp": pp
        }

    def resolve(self, n_devices):
        sizes = dict(self.axes)
        wild = [k for k, v in sizes.items() if v == -1]
        fixed = int(np.prod([v for v in sizes.values() if v != -1]))
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    "%d devices not divisible by fixed axes %s" % (n_devices, sizes)
                )
            sizes[wild[0]] = n_devices // fixed
        total = int(np.prod(list(sizes.values())))
        if total != n_devices:
            raise ValueError(
                "mesh %s needs %d devices, have %d" % (sizes, total, n_devices)
            )
        return sizes


_active = threading.local()


def current_mesh():
    """The innermost `with mesh:` block's mesh, or None."""
    stack = getattr(_active, "stack", None)
    return stack[-1] if stack else None


class Mesh:
    """One rank's view of a device mesh: `shape` (axis -> extent, all six
    axes), `index(axis)` (this rank's coordinate), `group(axis)` (the
    process group of the ranks that share every other coordinate; None on
    an axis of extent 1), `device` (this rank's device) and `device_mesh`
    (the DeviceMesh, None without a process group). `with mesh:` makes it
    the default of the collective wrappers."""

    def __init__(self, sizes, coords, groups, device, device_mesh=None):
        self.shape = {a: int(sizes[a]) for a in AXES}
        self._coords = dict(coords)
        self._groups = dict(groups)
        self.device = torch.device(device)
        self.device_mesh = device_mesh

    def axis_size(self, axis):
        return self.shape.get(axis, 1)

    def index(self, axis):
        return self._coords.get(axis, 0)

    def group(self, axis):
        return self._groups.get(axis) if self.axis_size(axis) > 1 else None

    def __enter__(self):
        stack = getattr(_active, "stack", None)
        if stack is None:
            stack = _active.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _active.stack.pop()


def _check_axes(config):
    """Raise for an fsdp, tp or pp extent above 1 (or left to -1)."""
    for axis, what in _A6B.items():
        n = config.axes[axis]
        if n > 1 or n == -1:
            raise NotImplementedError(
                "mesh axis %s=%d: %s is ported with ROADMAP A6b" % (axis, n, what))


def make_mesh(config=None, device=None):
    """This rank's Mesh over the default process group (dp outermost), or
    over the one local device when no process group is initialized.
    `device` is this rank's device: the CPU under gloo, else the current
    CUDA device (torchrun's LOCAL_RANK, set by init_distributed)."""
    config = config or MeshConfig()
    _check_axes(config)
    if not (dist.is_available() and dist.is_initialized()):
        sizes = config.resolve(1)
        if device is None:
            from ..place import to_device

            device = to_device(None)
        return Mesh(sizes, {}, {}, device)
    world = dist.get_world_size()
    sizes = config.resolve(world)
    backend = dist.get_backend()
    device_type = "cuda" if backend == "nccl" else "cpu"
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if device_type == "cuda" else torch.device("cpu"))
    from torch.distributed.device_mesh import DeviceMesh

    dm = DeviceMesh(device_type, torch.arange(world).reshape([sizes[a] for a in AXES]),
                    mesh_dim_names=AXES)
    coords = dict(zip(AXES, dm.get_coordinate()))
    groups = {a: dm.get_group(a) for a in AXES if sizes[a] > 1}
    return Mesh(sizes, coords, groups, device, dm)
