"""Pipeline parallelism over a mesh's pp axis: the GPipe and 1F1B schedules
(the counterpart of paddle_tpu/parallel/pipeline.py).

The JAX package traces a schedule of static length into one shard_map
region and lets `ppermute`'s transpose give the backward pipeline. The port
runs one process per stage: each pp rank lowers its own stage's ops for one
microbatch at a time, torch.autograd differentiates them, and the boundary
activations (forward) and their gradients (backward) travel between pp
neighbours by point-to-point sends (NCCL on the cards, gloo on the CPU;
collectives.send_recv). The schedules below drive a stage (executor.
_PipelinedBlock's) through its eight steps:

- `recv_fwd(i)` / `send_fwd(y)`: microbatch i's boundary values from the
  previous stage, its own to the next (nothing at the ends);
- `fwd(i, x)` / `bwd(i, g)`: microbatch i's forward (the received values
  `x`; returns what it sends on) and backward (the gradients `g` of what it
  sent; returns those of what it received);
- `recv_bwd(i)` / `send_bwd(gx)`: the gradients from the next stage, its
  own to the previous;
- `send_fwd_recv_bwd(y)` and `send_bwd_recv_fwd(gx)`: a send and the
  opposite receive in one group call. 1F1B's steady state pairs them so:
  a send that waits for its peer's receive never sits in front of the
  receive its peer is waiting to send to (Megatron's schedule).

GPipe is all forwards, then all backwards, in microbatch order on every
stage: each rank keeps the activations of all `n_micro` microbatches. 1F1B
runs `pp - 1 - stage` warm-up forwards, then one forward and one backward
in turn, then the remaining backwards: at most `pp - stage` microbatches'
activations are alive. The gradients are the same sums either way; only
the order and the memory differ. Both schedules are fixed per stage, so a
stage's step, sends and receives included, captures as a CUDA graph.
"""

import torch
import torch.distributed as dist

# the fill-and-drain bubble (pp-1)/(m+pp-1), re-exported as the JAX
# package's pipeline module does
from ..observability.stepstats import analytic_bubble  # noqa: F401

__all__ = ["SCHEDULES", "analytic_bubble", "gpipe", "gpipe_schedule", "one_f_one_b_schedule"]


def gpipe_schedule(stage, n_micro, pp, rank):
    """All forwards, then all backwards, microbatches in order."""
    for i in range(n_micro):
        stage.send_fwd(stage.fwd(i, stage.recv_fwd(i)))
    for i in range(n_micro):
        stage.send_bwd(stage.bwd(i, stage.recv_bwd(i)))


def one_f_one_b_schedule(stage, n_micro, pp, rank):
    """PipeDream-flush / Megatron 1F1B: `pp - 1 - rank` warm-up forwards,
    then a forward and a backward in turn, then the warm-up's backwards."""
    warm = min(pp - 1 - rank, n_micro)
    rest = n_micro - warm
    for i in range(warm):
        stage.send_fwd(stage.fwd(i, stage.recv_fwd(i)))
    x = stage.recv_fwd(warm) if rest > 0 else None
    for i in range(rest):
        g = stage.send_fwd_recv_bwd(stage.fwd(warm + i, x), i)
        gx = stage.bwd(i, g)
        if i == rest - 1:
            stage.send_bwd(gx)
        else:
            x = stage.send_bwd_recv_fwd(gx, warm + i + 1)
    for i in range(rest, n_micro):
        stage.send_bwd(stage.bwd(i, stage.recv_bwd(i)))


SCHEDULES = {"gpipe": gpipe_schedule, "1f1b": one_f_one_b_schedule}


# ---------------------------------------------------------------------------
# the homogeneous tier: a stack of identical stages (the JAX package's gpipe)
# ---------------------------------------------------------------------------


def _peer(mesh, axis, index):
    return dist.get_global_rank(mesh.group(axis), index)


class _GPipe(torch.autograd.Function):
    """GPipe over a stack of identical stages: this pp rank applies its
    consecutive stages to each microbatch of its dp rows, boundary
    activations go rank to rank, and the last rank's outputs are the
    result, on every rank. The backward runs the same pipeline in reverse
    from the last rank's cotangent."""

    @staticmethod
    def forward(ctx, x, stage_fn, n_micro, mesh, axis, batch_axis, names, *flat):
        from .collectives import _gather, _piece, _sum, send_recv

        pp, r = mesh.axis_size(axis), mesh.index(axis)
        n_local = flat[0].shape[0] // pp
        x_local = _piece(x, batch_axis, 0, mesh)
        mb = x_local.shape[0] // n_micro
        ctx.args = (stage_fn, n_micro, mesh, axis, batch_axis, names, n_local, mb)
        local = [t.detach()[r * n_local:(r + 1) * n_local] for t in flat]
        ctx.save_for_backward(x_local, *local)
        outs = []
        for m in range(n_micro):
            if r == 0:
                h = x_local[m * mb:(m + 1) * mb]
            else:
                (h,) = send_recv(recvs=[((mb,) + tuple(x_local.shape[1:]), x_local.dtype,
                                         x_local.device, _peer(mesh, axis, r - 1))])
            for i in range(n_local):
                h = stage_fn({n: t[i] for n, t in zip(names, local)}, h)
            if r < pp - 1:
                send_recv(sends=[(h, _peer(mesh, axis, r + 1))])
            outs.append(h)
        y = torch.cat(outs, 0) if r == pp - 1 else torch.zeros_like(x_local)
        return _gather(_sum(y, axis, mesh, "broadcast"), batch_axis, 0, mesh)

    @staticmethod
    def backward(ctx, gy):
        from .collectives import _gather, _piece, _sum, send_recv

        stage_fn, n_micro, mesh, axis, batch_axis, names, n_local, mb = ctx.args
        gy = _piece(gy, batch_axis, 0, mesh)
        x_local, *local = ctx.saved_tensors
        pp, r = mesh.axis_size(axis), mesh.index(axis)
        gparams = [torch.zeros_like(t) for t in local]
        gx = []
        for m in range(n_micro):
            with torch.enable_grad():
                if r == 0:
                    h0 = x_local[m * mb:(m + 1) * mb].detach()
                else:
                    (h0,) = send_recv(recvs=[((mb,) + tuple(x_local.shape[1:]), x_local.dtype,
                                              x_local.device, _peer(mesh, axis, r - 1))])
                h0 = h0.detach().requires_grad_(True)
                leaves = [t.detach().requires_grad_(True) for t in local]
                h = h0
                for i in range(n_local):
                    h = stage_fn({n: t[i] for n, t in zip(names, leaves)}, h)
            if r < pp - 1:
                send_recv(sends=[(h.detach(), _peer(mesh, axis, r + 1))])
            # recompute done; the cotangent comes from the next rank (the
            # last rank takes the result's)
            if r == pp - 1:
                g = gy[m * mb:(m + 1) * mb]
            else:
                (g,) = send_recv(recvs=[(tuple(h.shape), h.dtype, h.device,
                                         _peer(mesh, axis, r + 1))])
            grads = torch.autograd.grad(h, [h0] + leaves, g, allow_unused=True)
            if r > 0:
                send_recv(sends=[(grads[0], _peer(mesh, axis, r - 1))])
            gx.append(grads[0])
            for acc, gp in zip(gparams, grads[1:]):
                if gp is not None:
                    acc += gp
        gx = torch.cat(gx, 0) if r == 0 else torch.zeros_like(x_local)
        gx = _gather(_sum(gx, axis, mesh, "broadcast"), batch_axis, 0, mesh)
        full = []
        for t, gp in zip(local, gparams):
            whole = torch.zeros((pp * n_local,) + tuple(t.shape[1:]), dtype=t.dtype,
                                device=t.device)
            whole[r * n_local:(r + 1) * n_local] = gp
            # the stages are disjoint over pp; the rows' partial sums add over dp
            full.append(_sum(whole, (axis, batch_axis), mesh, "broadcast"))
        return (gx, None, None, None, None, None, None) + tuple(full)



def gpipe(stage_fn, stacked_params, x, n_micro, mesh, axis_name="pp", batch_axis="dp"):
    """Run a stack of homogeneous stages as a GPipe pipeline over `mesh`'s
    `axis_name`, data-parallel over `batch_axis` (the JAX package's gpipe,
    on one process a rank: each dp rank pipelines its rows of the batch).

    stage_fn(params_i, x) -> y with y.shape == x.shape; stacked_params: a
    dict of tensors with leading axis n_stages (divisible by the pp size),
    the whole stack on every rank; x: [batch, ...], the global batch on
    every rank. Returns the final stage's outputs for the global batch, the
    same on every rank, differentiable in x and the stacked params (their
    gradients are the whole ones, on every rank): the forward is
    recomputed stage by stage in the backward, microbatch by microbatch."""
    names = sorted(stacked_params)
    flat = [stacked_params[n] for n in names]
    n_stages = flat[0].shape[0]
    pp = mesh.axis_size(axis_name)
    if n_stages % pp:
        raise ValueError("%d stages not divisible over pp=%d" % (n_stages, pp))
    dp = mesh.axis_size(batch_axis)
    if x.shape[0] % dp or (x.shape[0] // dp) % n_micro:
        raise ValueError("batch %d not divisible into %d dp shards of %d microbatches"
                         % (x.shape[0], dp, n_micro))
    return _GPipe.apply(x, stage_fn, int(n_micro), mesh, axis_name, batch_axis, names, *flat)
