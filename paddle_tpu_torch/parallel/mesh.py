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

A layout may split one dimension over several axes at once (the
SpecLayout embedding's ("fsdp", "tp")), and the batch is split over dp and
fsdp together: `make_mesh` also builds the process group of every set of
two or more axes of extent above 1, which `group(axes)` returns.
"""

import itertools
import threading

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["AXES", "Mesh", "MeshConfig", "current_mesh", "make_mesh"]

AXES = ("dp", "fsdp", "tp", "sp", "ep", "pp")


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


def _axes(axes):
    """An axis name or a tuple of them as a tuple."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """One rank's view of a device mesh: `shape` (axis -> extent, all six
    axes), `index(axes)` (this rank's coordinate), `group(axes)` (the
    process group of the ranks that share every other coordinate; None
    where the axes' extent is 1), `device` (this rank's device) and
    `device_mesh` (the DeviceMesh, None without a process group). `axes`
    is an axis name or a tuple of them: over a tuple the ranks are ordered
    with its first axis outermost, as a layout that splits one dimension
    over several axes orders its pieces. `with mesh:` makes it the default
    of the collective wrappers."""

    def __init__(self, sizes, coords, groups, device, device_mesh=None, rank_coords=None):
        self.shape = {a: int(sizes[a]) for a in AXES}
        self._coords = dict(coords)
        self._groups = dict(groups)
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        # global rank -> its coordinates (the members of a group, in order)
        self._rank_coords = rank_coords or {}

    def axis_size(self, axes):
        return int(np.prod([self.shape.get(a, 1) for a in _axes(axes)]))

    def index(self, axes):
        i = 0
        for a in _axes(axes):
            i = i * self.shape.get(a, 1) + self._coords.get(a, 0)
        return i

    def group(self, axes):
        axes = _axes(axes)
        if self.axis_size(axes) == 1:
            return None
        key = tuple(a for a in AXES if a in axes and self.shape[a] > 1)
        return self._groups.get(key[0] if len(key) == 1 else key)

    def group_order(self, axes):
        """For each rank of group(axes), in the group's own rank order, its
        index over `axes` in their order: the order in which the pieces an
        all_gather over the group returns are put together."""
        axes = _axes(axes)
        key = tuple(a for a in AXES if a in axes)
        mine = {a: c for a, c in self._coords.items() if a not in axes}
        members = sorted(r for r, c in self._rank_coords.items()
                         if all(c.get(a, 0) == v for a, v in mine.items()))
        out = []
        for r in members:
            i = 0
            for a in axes:
                i = i * self.shape.get(a, 1) + self._rank_coords[r].get(a, 0)
            out.append(i)
        return out if key != axes else list(range(len(members)))

    def __enter__(self):
        stack = getattr(_active, "stack", None)
        if stack is None:
            stack = _active.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _active.stack.pop()


def _combined_groups(sizes, ranks, me):
    """The process group of every set of two or more axes of extent above 1
    that holds this rank, keyed by the axes in AXES order. Every rank
    creates every group, in one order, as torch.distributed asks."""
    live = [a for a in AXES if sizes[a] > 1]
    out = {}
    for n in range(2, len(live) + 1):
        for combo in itertools.combinations(live, n):
            dims = [AXES.index(a) for a in combo]
            moved = np.moveaxis(ranks, dims, list(range(ranks.ndim - n, ranks.ndim)))
            for members in moved.reshape(-1, int(np.prod([sizes[a] for a in combo]))):
                members = sorted(int(r) for r in members)
                group = dist.new_group(members)
                if me in members:
                    out[combo] = group
    return out


def make_mesh(config=None, device=None):
    """This rank's Mesh over the default process group (dp outermost), or
    over the one local device when no process group is initialized.
    `device` is this rank's device: the CPU under gloo, else the current
    CUDA device (torchrun's LOCAL_RANK, set by init_distributed)."""
    config = config or MeshConfig()
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

    ranks = np.arange(world).reshape([sizes[a] for a in AXES])
    dm = DeviceMesh(device_type, torch.from_numpy(ranks), mesh_dim_names=AXES)
    coords = dict(zip(AXES, dm.get_coordinate()))
    groups = {a: dm.get_group(a) for a in AXES if sizes[a] > 1}
    groups.update(_combined_groups(sizes, ranks, dist.get_rank()))
    rank_coords = {int(r): dict(zip(AXES, (int(c) for c in np.unravel_index(r, ranks.shape))))
                   for r in range(world)}
    return Mesh(sizes, coords, groups, device, dm, rank_coords)
