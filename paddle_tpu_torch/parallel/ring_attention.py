"""Ring attention: exact attention over sequences sharded across the 'sp'
mesh axis (context parallelism; the counterpart of
paddle_tpu/parallel/ring_attention.py).

The reference has no sequence parallelism; the JAX package added it. Each sp
rank holds one chunk of the sequence (queries, keys and values); the K/V
chunks rotate around the ring (`collectives.ppermute_shift`) while each
rank accumulates its queries' attention with an online softmax, so the
result is exact full attention without the (t, t) score matrix.

Each ring step runs the port's flash kernels (ops/flash_attention.py:
`flash_forward` returns the chunk's out and lse, `flash_backward` takes a
given lse):

- the forward merges each step's (out_i, lse_i) into the running output
  with the online rescale and keeps (out, lse) of the rank's queries;
- the backward runs the ring again with flash_backward against the GLOBAL
  lse and out (the flash-2 decomposition is exact per key block, so the
  per-chunk grads sum to the full gradient); dQ stays home, and the dK/dV
  accumulators travel with their chunk and are home after n hops;
- causal: step 0 is the diagonal chunk (the causal kernel); a later step's
  chunk is fully visible (its origin rank is below this one) or fully
  masked, and a masked step computes nothing, so the causal ring does
  about half the work.

Where `flash_tiles_ok` declines the chunk length (the JAX package's ragged
tiles), the dense tier runs the same ring with the plain versions of the
per-step functions.

Op boundary (ops/parallel_ops.py, in both directions): the op takes q, k
and v replicated across sp and returns the output replicated; each rank
computes its chunk's rows and an all-gather over sp assembles them. Its
input gradients are all-gathered over sp the same way, so parameters
upstream see equal gradients on every sp rank and are averaged over dp
only.

`ring_forward_chunks` / `ring_backward_chunks` run the same per-step
functions over all n chunks in one process (rank by rank, the dK/dV
accumulators summed in the ring's order), which holds the per-step path
against whole-sequence attention without a process group.
"""

import torch

from . import collectives

__all__ = [
    "ring_attention",
    "ring_attention_sharded",
    "ring_backward_chunks",
    "ring_forward_chunks",
    "ring_schedule",
]

NEG_INF = -1e30


def ring_schedule(me, n, causal):
    """[(step, origin rank of the chunk held, mode)] of rank `me` in a ring
    of n: mode "diag" (the causal diagonal), "full" or "skip" (fully
    masked: nothing to compute)."""
    out = []
    for i in range(n):
        src = (me - i) % n
        if not causal:
            mode = "full"
        elif i == 0:
            mode = "diag"
        else:
            mode = "full" if src < me else "skip"
        out.append((i, src, mode))
    return out


def _step_fns(flash):
    from ..ops import flash_attention as fa

    if flash:
        return fa.flash_forward, fa.flash_backward
    return fa.flash_forward_plain, fa.flash_backward_plain


def _merge(acc, m, l, o_i, lse_i):
    """Online merge of a normalized chunk (o_i, lse_i) into (acc, m, l)."""
    m_new = torch.maximum(m, lse_i)
    alpha = torch.exp(torch.where(m == float("-inf"), m, m - m_new))
    w = torch.exp(lse_i - m_new)
    acc = acc * alpha[..., None] + o_i.float() * w[..., None]
    return acc, m_new, l * alpha + w


def _fwd_init(q):
    b, h, t, d = q.shape
    return (torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, t), float("-inf"), dtype=torch.float32, device=q.device),
            torch.zeros((b, h, t), dtype=torch.float32, device=q.device))


def _fwd_finish(q, acc, m, l):
    l = torch.clamp_min(l, 1e-20)
    return (acc / l[..., None]).to(q.dtype), m + torch.log(l)


def _tiles_ok(t_loc, use_flash):
    from ..ops.flash_attention import flash_tiles_ok

    ok = flash_tiles_ok(t_loc)
    if use_flash is None:
        return ok
    if use_flash and not ok:
        raise ValueError(
            "flash ring needs whole flash tiles at t_local=%d; pass use_flash=False for "
            "the dense ring" % t_loc)
    return bool(use_flash)


def _ring_fwd(q, k, v, mesh, axis, causal, scale, flash):
    """(out, lse) of this rank's query chunk: the K/V chunks rotate."""
    fwd, _ = _step_fns(flash)
    n, me = mesh.axis_size(axis), mesh.index(axis)
    acc, m, l = _fwd_init(q)
    for i, _src, mode in ring_schedule(me, n, causal):
        if mode != "skip":
            acc, m, l = _merge(acc, m, l, *fwd(q, k, v, mode == "diag", scale))
        if i + 1 < n:
            k = collectives.ppermute_shift(k, axis, 1, mesh)
            v = collectives.ppermute_shift(v, axis, 1, mesh)
    return _fwd_finish(q, acc, m, l)


def _ring_bwd(q, k, v, out, lse, do, mesh, axis, causal, scale, flash):
    """(dq, dk, dv) of this rank's chunks against the global lse and out."""
    _, bwd = _step_fns(flash)
    n, me = mesh.axis_size(axis), mesh.index(axis)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for i, _src, mode in ring_schedule(me, n, causal):
        if mode != "skip":
            dq_i, dk_i, dv_i = bwd(q, k_cur, v_cur, out, lse, do, mode == "diag", scale)
            dq += dq_i.float()
            dk += dk_i.float()
            dv += dv_i.float()
        if i + 1 < n:
            k_cur = collectives.ppermute_shift(k_cur, axis, 1, mesh)
            v_cur = collectives.ppermute_shift(v_cur, axis, 1, mesh)
        # the accumulators hop every step, the last included: home after n
        dk = collectives.ppermute_shift(dk, axis, 1, mesh)
        dv = collectives.ppermute_shift(dv, axis, 1, mesh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _chunk(x, mesh, axis):
    n = mesh.axis_size(axis)
    t_loc = x.shape[2] // n
    return x.narrow(2, mesh.index(axis) * t_loc, t_loc).contiguous()


def _prepare(q, mesh, axis, scale, use_flash):
    n = mesh.axis_size(axis)
    if q.shape[2] % n:
        raise ValueError("sequence length %d not divisible by the %r axis size %d"
                         % (q.shape[2], axis, n))
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return float(scale), _tiles_ok(q.shape[2] // n, use_flash)


def sharded_forward(q, k, v, mesh, axis_name="sp", causal=False, scale=None,
                    use_flash=None):
    """The op's forward: (out, lse_local) from replicated (b, h, t, d) q, k,
    v; out is replicated (the chunks all-gathered over the axis), lse is
    this rank's chunk's."""
    scale, flash = _prepare(q, mesh, axis_name, scale, use_flash)
    qc, kc, vc = (_chunk(x, mesh, axis_name) for x in (q, k, v))
    out, lse = _ring_fwd(qc, kc, vc, mesh, axis_name, causal, scale, flash)
    return collectives.all_gather(out, axis_name, axis=2, mesh=mesh), lse


def sharded_backward(q, k, v, out, dout, mesh, axis_name="sp", causal=False, scale=None,
                     use_flash=None, lse=None):
    """The op's backward: replicated (dq, dk, dv) from replicated q, k, v,
    out and dout (each rank's chunk's grads all-gathered over the axis).
    Without this rank's lse the ring forward runs again for it."""
    scale, flash = _prepare(q, mesh, axis_name, scale, use_flash)
    qc, kc, vc, oc, doc = (_chunk(x, mesh, axis_name) for x in (q, k, v, out, dout))
    if lse is None:
        oc, lse = _ring_fwd(qc, kc, vc, mesh, axis_name, causal, scale, flash)
    grads = _ring_bwd(qc, kc, vc, oc, lse, doc.to(q.dtype), mesh, axis_name, causal, scale,
                      flash)
    return tuple(collectives.all_gather(g, axis_name, axis=2, mesh=mesh) for g in grads)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis_name, causal, scale, use_flash):
        out, lse = sharded_forward(q, k, v, mesh, axis_name, causal, scale, use_flash)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mesh, axis_name, causal, scale, use_flash)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = sharded_backward(q, k, v, out, dout, *ctx.args, lse=lse)
        return grads + (None,) * 5


def ring_attention_sharded(q, k, v, mesh, axis_name="sp", causal=False, scale=None,
                           use_flash=None):
    """q, k, v: (b, h, t, d), the same on every rank of `axis_name`; each
    rank computes its 1/n of the query rows around the ring, and the
    output, the same on every rank, is differentiable (its grads are
    assembled the same way).

    use_flash: None = auto (the flash kernels when whole tiles fit the
    chunk), True/False to force. The dense tier remains for ragged chunks."""
    return _RingAttention.apply(q, k, v, mesh, axis_name, bool(causal), scale, use_flash)


def attention_plain(q, k, v, causal=False, scale=None):
    """softmax(q k^T * scale [causal]) v, dense (the single-device form)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        mask = torch.ones((t_q, t_k), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    return torch.matmul(torch.softmax(s, dim=-1), v)


def ring_attention(q, k, v, causal=False, scale=None, axis_name="sp", mesh=None):
    """Plain attention when no sp sharding is active; the ring when a mesh
    with a >1 `axis_name` axis is given."""
    if mesh is not None and mesh.axis_size(axis_name) > 1:
        return ring_attention_sharded(q, k, v, mesh, axis_name, causal, scale)
    return attention_plain(q, k, v, causal, scale)


# ---------------------------------------------------------------------------
# the per-step path over every chunk in one process
# ---------------------------------------------------------------------------


def ring_forward_chunks(qs, ks, vs, causal=False, scale=None, flash=True):
    """[(out, lse)] of each of the n chunks' queries, each rank's ring run in
    turn over the chunks (qs, ks, vs: n (b, h, t/n, d) chunks each): the
    same per-step calls and merges as the sharded ring."""
    fwd, _ = _step_fns(flash)
    n = len(qs)
    scale = qs[0].shape[-1] ** -0.5 if scale is None else float(scale)
    outs = []
    for me in range(n):
        acc, m, l = _fwd_init(qs[me])
        for _i, src, mode in ring_schedule(me, n, causal):
            if mode != "skip":
                acc, m, l = _merge(acc, m, l, *fwd(qs[me], ks[src], vs[src], mode == "diag",
                                                   scale))
        outs.append(_fwd_finish(qs[me], acc, m, l))
    return outs


def ring_backward_chunks(qs, ks, vs, outs, lses, dos, causal=False, scale=None, flash=True):
    """([dq], [dk], [dv]) of each chunk against the global out and lse of
    ring_forward_chunks, each chunk's dK/dV summed in the order the ring's
    travelling accumulators sum them."""
    _, bwd = _step_fns(flash)
    n = len(qs)
    scale = qs[0].shape[-1] ** -0.5 if scale is None else float(scale)
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dv = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]
    plans = [ring_schedule(me, n, causal) for me in range(n)]
    for i in range(n):
        for me in range(n):
            _i, src, mode = plans[me][i]
            if mode == "skip":
                continue
            dq_i, dk_i, dv_i = bwd(qs[me], ks[src], vs[src], outs[me], lses[me], dos[me],
                                   mode == "diag", scale)
            dq[me] += dq_i.float()
            dk[src] += dk_i.float()
            dv[src] += dv_i.float()
    return ([g.to(q.dtype) for g, q in zip(dq, qs)], [g.to(k.dtype) for g, k in zip(dk, ks)],
            [g.to(v.dtype) for g, v in zip(dv, vs)])
