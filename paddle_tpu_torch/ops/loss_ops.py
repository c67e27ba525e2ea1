"""Structured-prediction, ranking and sampled losses, the evaluation ops
and the proximal / model-average optimizer ops (the torch counterparts of
paddle_tpu/ops/loss_ops.py, and of huber_loss from its core_ops.py).

Sequence inputs are padded [B, T, ...] with a SeqLen companion, as in
sequence_ops.py. The recursions the JAX package scans over time (the CRF's
forward and Viterbi passes, CTC's alpha recursion, the edit distance's DP
rows) are Python loops over the static time axis with the same masks: no
read on the host, so they capture.

The sampled ops draw as the other random ops of the port do
(core_ops._random): from the run's device generator, or the op's own when
it pins a seed; the JAX package draws from its threaded key, so the two
packages draw different samples from one seed. `_draw_samples` is the one
place that draws for nce.
"""

import math

import torch

from .core_ops import _opt_f32
from .registry import register, set_var_meta, torch_dtype

_I64 = torch_dtype("int64")


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0): no linear cut-off past a threshold
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _emission_infer(outputs_of):
    """infer_shape of an op over a [B, T, D] emission whose lowering loops
    over time: outputs_of(b, t, d, dtype) -> {slot: (shape, dtype)}."""

    def infer(op, block):
        name = (op.inputs.get("Emission") or op.inputs.get("Logits")
                or op.inputs.get("Hyps"))[0]
        if not block.has_var_recursive(name):
            return
        v = block._var_recursive(name)
        if v.shape is None or len(v.shape) < 2:
            return
        b, t = v.shape[0], v.shape[1]
        d = v.shape[2] if len(v.shape) > 2 else 1
        for slot, (shape, dtype) in outputs_of(b, t, d, v.dtype).items():
            for n in op.outputs.get(slot, ()):
                set_var_meta(block, n, shape, dtype)

    return infer


# ---------------------------------------------------------------------------
# linear-chain CRF
# ---------------------------------------------------------------------------


def _crf_split_transition(transition):
    """Row 0 start weights, row 1 end weights, rows 2.. the (D, D)
    transitions (reference linear_chain_crf_op.h)."""
    return transition[0], transition[1], transition[2:]


@register("linear_chain_crf", infer_shape=_emission_infer(lambda b, t, d, dt: {
    "LogLikelihood": ((b, 1), dt), "Alpha": ((b, t, d), "float32"),
    "EmissionExps": ((b, t, d), "float32"), "TransitionExps": ((d + 2, d), "float32")}))
def _linear_chain_crf(ctx, ins, attrs):
    """The negative log likelihood per sequence (the minimization target),
    with Alpha, EmissionExps and TransitionExps."""
    (emission,) = ins["Emission"]  # [B, T, D]
    (transition,) = ins["Transition"]  # [D+2, D]
    (label,) = ins["Label"]  # [B, T, 1]
    (seqlen,) = ins["SeqLen"]
    B, T, D = emission.shape
    label = label.reshape(B, T).long()
    seqlen = seqlen.reshape(-1).long()
    start, end, trans = _crf_split_transition(transition)
    e = emission.float()

    alpha = start[None] + e[:, 0]
    alphas = [alpha]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) + e[:, t]
        alpha = torch.where((seqlen > t).reshape(B, 1), nxt, alpha)
        alphas.append(alpha)
    log_z = torch.logsumexp(alpha + end[None], dim=1)

    t_steps = torch.arange(T, device=e.device)
    emit_sc = torch.gather(e, 2, label[:, :, None]).reshape(B, T)
    zero = torch.zeros((), dtype=e.dtype, device=e.device)
    emit_score = torch.sum(torch.where(t_steps[None, :] < seqlen[:, None], emit_sc, zero), dim=1)
    pair_sc = trans[label[:, :-1], label[:, 1:]]
    pair_mask = t_steps[None, 1:] < seqlen[:, None]
    trans_score = torch.sum(torch.where(pair_mask, pair_sc, zero), dim=1)
    last_idx = torch.clamp(seqlen - 1, min=0)
    last_tag = torch.gather(label, 1, last_idx[:, None]).reshape(B)
    score = start[label[:, 0]] + emit_score + trans_score + end[last_tag]
    return {
        "LogLikelihood": [(log_z - score).reshape(B, 1)],
        "Alpha": [torch.stack(alphas, dim=1)],
        "EmissionExps": [torch.exp(e)],
        "TransitionExps": [torch.exp(transition.float())],
    }


@register("crf_decoding", no_grad=True, infer_shape=_emission_infer(lambda b, t, d, dt: {
    "ViterbiPath": ((b, t, 1), "int64")}))
def _crf_decoding(ctx, ins, attrs):
    """Viterbi decode. With a Label input the output marks per-position
    correctness instead (the reference's chunk-evaluation form)."""
    (emission,) = ins["Emission"]
    (transition,) = ins["Transition"]
    (seqlen,) = ins["SeqLen"]
    B, T, D = emission.shape
    seqlen = seqlen.reshape(-1).long()
    start, end, trans = _crf_split_transition(transition)
    e = emission.float()
    self_ptr = torch.arange(D, device=e.device).expand(B, D)

    delta = start[None] + e[:, 0]
    back = []
    for t in range(1, T):
        cand = delta[:, :, None] + trans[None]  # [B, D_prev, D]
        nxt = torch.amax(cand, dim=1)
        # the first maximal index, as jnp.argmax
        best_prev = torch.argmax(cand, dim=1)
        active = (seqlen > t).reshape(B, 1)
        delta = torch.where(active, nxt + e[:, t], delta)
        # inactive rows point back at themselves so the backtrace passes
        back.append(torch.where(active, best_prev, self_ptr))
    tag = torch.argmax(delta + end[None], dim=1)
    path = [None] * T
    for t in range(T - 1, 0, -1):
        path[t] = tag
        tag = torch.gather(back[t - 1], 1, tag[:, None]).reshape(B)
    path[0] = tag
    path = torch.stack(path, dim=1)
    t_mask = torch.arange(T, device=e.device)[None, :] < seqlen[:, None]
    path = torch.where(t_mask, path, torch.zeros_like(path))
    label = ins.get("Label", [None])[0]
    if label is not None:
        path = torch.where(t_mask, (path == label.reshape(B, T).long()).long(),
                           torch.zeros_like(path))
    return {"ViterbiPath": [path[:, :, None].to(_I64)]}


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------


@register("warpctc", infer_shape=_emission_infer(lambda b, t, d, dt: {"Loss": ((b, 1), dt)}))
def _warpctc(ctx, ins, attrs):
    """CTC loss: the log-domain alpha recursion over the blank-extended
    label (Graves 2006, eq. 6-8)."""
    (logits,) = ins["Logits"]  # [B, T, C]
    (label,) = ins["Label"]  # [B, L, 1]
    (logits_len,) = ins["LogitsLength"]
    (label_len,) = ins["LabelLength"]
    blank = int(attrs.get("blank", 0))
    B, T, C = logits.shape
    L = label.shape[1]
    S = 2 * L + 1
    dev = logits.device
    label = label.reshape(B, L).long()
    logits_len = logits_len.reshape(-1).long()
    label_len = label_len.reshape(-1).long()
    logp = torch.log_softmax(logits.float(), dim=2)
    NEG = torch.full((), -1e30, dtype=torch.float32, device=dev)

    s_idx = torch.arange(S, device=dev)
    lab_idx = torch.clamp(s_idx // 2, max=L - 1)[None, :].expand(B, S)
    ext = torch.where(s_idx[None, :] % 2 == 0, torch.full((), blank, dtype=torch.long,
                                                          device=dev),
                      torch.gather(label, 1, lab_idx))  # [B, S]
    ext_valid = s_idx[None, :] < (2 * label_len[:, None] + 1)
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long, device=dev), ext[:, :-2]], 1)
    can_skip = (ext != blank) & (ext != ext_m2)

    a0 = torch.full((B, S), -1e30, dtype=torch.float32, device=dev)
    first_lab = torch.gather(logp[:, 0], 1, ext[:, 1:2]).reshape(B)
    a0 = torch.cat([logp[:, 0, blank][:, None],
                    torch.where(label_len > 0, first_lab, NEG)[:, None], a0[:, 2:]], 1)
    alpha = a0
    for t in range(1, T):
        sh1 = torch.cat([torch.full((B, 1), -1e30, device=dev), alpha[:, :-1]], 1)
        sh2 = torch.cat([torch.full((B, 2), -1e30, device=dev), alpha[:, :-2]], 1)
        acc = torch.logaddexp(alpha, sh1)
        acc = torch.where(can_skip, torch.logaddexp(acc, sh2), acc)
        nxt = torch.where(ext_valid, acc + torch.gather(logp[:, t], 1, ext), NEG)
        alpha = torch.where((logits_len > t).reshape(B, 1), nxt, alpha)

    end1 = 2 * label_len
    end2 = torch.clamp(2 * label_len - 1, min=0)
    ll = torch.logaddexp(
        torch.gather(alpha, 1, end1[:, None]).reshape(B),
        torch.where(label_len > 0, torch.gather(alpha, 1, end2[:, None]).reshape(B), NEG),
    )
    loss = -ll
    if attrs.get("norm_by_times", False):
        loss = loss / torch.clamp(logits_len.float(), min=1.0)
    return {"Loss": [loss.reshape(B, 1)]}


@register("ctc_align", no_grad=True)
def _ctc_align(ctx, ins, attrs):
    """Merge repeats, then drop blanks; the output stays padded [B, T, 1]
    with an OutLen companion, removed slots filled with padding_value."""
    (x,) = ins["Input"]
    (seqlen,) = ins["SeqLen"]
    blank = int(attrs.get("blank", 0))
    pad_val = int(attrs.get("padding_value", 0))
    B, T = x.shape[0], x.shape[1]
    tok = x.reshape(B, T).long()
    t_idx = torch.arange(T, device=x.device)
    valid = t_idx[None, :] < seqlen.reshape(-1, 1)
    prev = torch.cat([torch.full((B, 1), -1, dtype=torch.long, device=x.device), tok[:, :-1]], 1)
    keep = (tok != blank) & (tok != prev) & valid
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    compacted = torch.gather(tok, 1, order)
    out_len = keep.sum(dim=1)
    out = torch.where(t_idx[None, :] < out_len[:, None], compacted,
                      torch.full((), pad_val, dtype=torch.long, device=x.device))
    return {"Output": [out[:, :, None].to(x.dtype)], "OutLen": [out_len.to(torch.int32)]}


# ---------------------------------------------------------------------------
# sampled losses
# ---------------------------------------------------------------------------


def _generator(ctx, attrs):
    """(generator, device) a sampling op draws from: as core_ops._random."""
    seed = int(attrs.get("seed", 0) or 0)
    if ctx.device.type == "meta":
        return None, ctx.device
    if ctx.host_random:
        return (torch.Generator().manual_seed(seed) if seed else ctx.generator), "cpu"
    return (ctx.seeded_generator(seed) if seed else ctx.device_generator), ctx.device


def _log_uniform_probs(C, device):
    k = torch.arange(C, dtype=torch.float32, device=device)
    return (torch.log(k + 2.0) - torch.log(k + 1.0)) / math.log(C + 1.0)


def _categorical(probs, u):
    """Class ids of the rows of `probs` ([..., C], unnormalized) at the
    uniform draws `u` ([..., S]), by the inverse CDF: capturable, unlike
    torch.multinomial's checks on the host."""
    cdf = torch.cumsum(probs, dim=-1)
    cdf = cdf / cdf[..., -1:]
    return torch.clamp(torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True), max=probs.shape[-1] - 1)


def _draw_samples(ctx, attrs, sampler, C, S, probs):
    """S negative class ids, the same distributions as the JAX package's
    _draw_samples: uniform, log-uniform (by its inverse CDF) or the custom
    distribution."""
    gen, dev = _generator(ctx, attrs)
    if sampler == "log_uniform":
        u = torch.rand((S,), generator=gen, device=dev)
        s = torch.floor(torch.exp(u * math.log(C + 1.0))).long() - 1
        s = torch.clamp(s, 0, C - 1)
    elif sampler == "custom_dist":
        s = _categorical(probs.to(dev), torch.rand((S,), generator=gen, device=dev))
    else:
        s = torch.randint(0, C, (S,), generator=gen, device=dev)
    return s.to(ctx.device)


@register("nce", stochastic=True)
def _nce(ctx, ins, attrs):
    """NCE logistic loss with shared negative samples (uniform, log-uniform
    or custom_dist sampler; an optional per-row SampleWeight scales the
    cost)."""
    (x,) = ins["Input"]  # [B, D]
    (label,) = ins["Label"]  # [B, num_true]
    (w,) = ins["Weight"]  # [C, D]
    bias = ins.get("Bias", [None])[0]
    sample_weight = ins.get("SampleWeight", [None])[0]
    C = int(attrs["num_total_classes"])
    S = int(attrs.get("num_neg_samples", 10))
    sampler = attrs.get("sampler", "uniform")
    B = x.shape[0]
    label = label.reshape(B, -1).long()
    num_true = label.shape[1]
    if sampler == "log_uniform":
        probs = _log_uniform_probs(C, x.device)
    elif sampler == "custom_dist":
        probs = ins["CustomDistProbs"][0].reshape(-1).float()
        probs = probs / torch.sum(probs)
    else:
        probs = torch.full((C,), 1.0 / C, device=x.device)
    neg = _draw_samples(ctx, attrs, sampler, C, S, probs)

    # gather only the sampled rows of W, never the full [B, C] logits
    pos_logit = torch.einsum("bd,btd->bt", x, w[label])
    neg_logit = x @ w[neg].transpose(0, 1)
    if bias is not None:
        pos_logit = pos_logit + bias.reshape(-1)[label]
        neg_logit = neg_logit + bias.reshape(-1)[neg][None, :]
    pos_adj = pos_logit - torch.log(S * probs[label] + 1e-12)
    neg_adj = neg_logit - torch.log(S * probs[neg][None, :] + 1e-12)
    cost = (torch.sum(_softplus(-pos_adj), dim=1) / num_true
            + torch.sum(_softplus(neg_adj), dim=1))
    if sample_weight is not None:
        cost = cost * sample_weight.reshape(B).to(cost.dtype)
    return {
        "Cost": [cost.reshape(B, 1)],
        "SampleLogits": [torch.cat([pos_adj, neg_adj], dim=1)],
        "SampleLabels": [torch.cat([label, neg[None, :].expand(B, S)], dim=1).to(_I64)],
    }


@register("hierarchical_sigmoid")
def _hsigmoid(ctx, ins, attrs):
    """hsigmoid over the implicit complete binary tree (SimpleCode:
    c = label + C, index_j = (c >> (j + 1)) - 1, bit_j = (c >> j) & 1, path
    length = the highest set bit)."""
    (x,) = ins["X"]  # [B, D]
    (w,) = ins["W"]  # [C-1, D]
    (label,) = ins["Label"]
    bias = ins.get("Bias", [None])[0]
    C = int(attrs["num_classes"])
    B = x.shape[0]
    c = label.reshape(B).long() + C
    max_len = max(int.bit_length(2 * C - 1) - 1, 1)
    j = torch.arange(max_len, device=x.device)
    length = torch.floor(torch.log2(c.float())).long()
    on_path = j[None, :] < length[:, None]
    idx = torch.clamp((c[:, None] >> (j[None, :] + 1)) - 1, 0, C - 2)
    bit = ((c[:, None] >> j[None, :]) & 1).to(x.dtype)
    t = torch.einsum("bd,bjd->bj", x, w[idx])
    if bias is not None:
        t = t + bias.reshape(-1)[idx]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    pre = torch.where(on_path, t, zero)
    cost = torch.sum(torch.where(on_path, _softplus(t) - bit * t, zero), dim=1)
    return {"Cost": [cost.reshape(B, 1)], "PreOut": [pre]}


@register("sampling_id", no_grad=True, stochastic=True)
def _sampling_id(ctx, ins, attrs):
    """A column index per row, drawn from the row's probabilities."""
    (x,) = ins["X"]  # [B, C]
    gen, dev = _generator(ctx, attrs)
    if ctx.device.type == "meta":
        return {"Out": [torch.empty((x.shape[0],), dtype=_I64, device="meta")]}
    probs = torch.clamp(x.float(), min=0.0).to(dev)
    u = torch.rand((x.shape[0], 1), generator=gen, device=dev)
    ids = _categorical(probs, u).reshape(-1)
    return {"Out": [ids.to(device=ctx.device, dtype=_I64)]}


# ---------------------------------------------------------------------------
# ranking / misc losses
# ---------------------------------------------------------------------------


@register("bpr_loss")
def _bpr_loss(ctx, ins, attrs):
    """Bayesian personalized ranking: mean over j != label of
    softplus(x_j - x_label)."""
    (x,) = ins["X"]
    (label,) = ins["Label"]
    B, C = x.shape
    pos = torch.gather(x, 1, label.reshape(B, 1).long())
    cost = (torch.sum(_softplus(x - pos), dim=1)
            - _softplus(torch.zeros((), dtype=x.dtype, device=x.device))) / (C - 1)
    return {"Cost": [cost.reshape(B, 1)]}


@register("margin_rank_loss")
def _margin_rank_loss(ctx, ins, attrs):
    (x1,) = ins["X1"]
    (x2,) = ins["X2"]
    (label,) = ins["Label"]
    out = torch.clamp(-label * (x1 - x2) + float(attrs.get("margin", 0.0)), min=0.0)
    return {"Out": [out], "Activated": [(out > 0).to(x1.dtype)]}


@register("rank_loss")
def _rank_loss(ctx, ins, attrs):
    """RankNet: o = left - right, C = softplus(o) - label * o."""
    (label,) = ins["Label"]
    (left,) = ins["Left"]
    (right,) = ins["Right"]
    o = left - right
    return {"Out": [_softplus(o) - label * o]}


@register("modified_huber_loss")
def _modified_huber_loss(ctx, ins, attrs):
    """y in {0, 1} mapped to +-1, z = y * x: quadratic on [-1, inf), linear
    below."""
    (x,) = ins["X"]
    (y,) = ins["Y"]
    z = (2.0 * y - 1.0) * x
    out = torch.where(z < -1.0, -4.0 * z, torch.square(torch.clamp(1.0 - z, min=0.0)))
    return {"Out": [out], "IntermediateVal": [z]}


@register("huber_loss")
def _huber_loss(ctx, ins, attrs):
    (x,) = ins["X"]
    (y,) = ins["Y"]
    delta = attrs.get("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    out = torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta))
    return {"Out": [out], "Residual": [r]}


@register("cos_sim")
def _cos_sim(ctx, ins, attrs):
    """Y may have one row, broadcast over the batch."""
    (x,) = ins["X"]
    (y,) = ins["Y"]
    xn = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=1, keepdim=True))
    dot = torch.sum(x * y, dim=1, keepdim=True)
    return {"Out": [dot / (xn * yn + 1e-12)], "XNorm": [xn], "YNorm": [yn]}


# ---------------------------------------------------------------------------
# evaluation ops
# ---------------------------------------------------------------------------


@register("edit_distance", no_grad=True, infer_shape=_emission_infer(lambda b, t, d, dt: {
    "Out": ((b, 1), "float32"), "SequenceNum": ((1,), "int64")}))
def _edit_distance(ctx, ins, attrs):
    """Batched Levenshtein distance: the DP row recursion over hypothesis
    positions, the row itself over reference positions."""
    (hyp,) = ins["Hyps"]  # [B, T1, 1]
    (ref,) = ins["Refs"]  # [B, T2, 1]
    B, T1 = hyp.shape[0], hyp.shape[1]
    T2 = ref.shape[1]
    dev = hyp.device
    hyp = hyp.reshape(B, T1).long()
    ref = ref.reshape(B, T2).long()
    hyp_len = ins["HypsLen"][0].reshape(-1).long()
    ref_len = ins["RefsLen"][0].reshape(-1).long()

    row = torch.arange(T2 + 1, dtype=torch.float32, device=dev).expand(B, T2 + 1)
    for i in range(1, T1 + 1):
        sub_cost = (ref != hyp[:, i - 1:i]).float()  # [B, T2]
        del_c = row[:, 1:] + 1.0
        sub_c = row[:, :-1] + sub_cost
        cur = torch.full((B,), float(i), device=dev)
        cols = [cur]
        for j in range(T2):
            cur = torch.minimum(torch.minimum(del_c[:, j], cur + 1.0), sub_c[:, j])
            cols.append(cur)
        row = torch.where((hyp_len >= i).reshape(B, 1), torch.stack(cols, dim=1), row)
    dist = torch.gather(row, 1, ref_len[:, None]).reshape(B)
    if attrs.get("normalized", True):
        dist = dist / torch.clamp(ref_len.float(), min=1.0)
    return {"Out": [dist.reshape(B, 1)],
            "SequenceNum": [torch.full((1,), B, dtype=_I64, device=dev)]}


@register("precision_recall", no_grad=True)
def _precision_recall(ctx, ins, attrs):
    """Streaming macro / micro precision, recall and F1 over per-class
    [TP, FP, TN, FN] states."""
    (idx,) = ins["Indices"]
    (labels,) = ins["Labels"]
    states = ins.get("StatesInfo", [None])[0]
    C = int(attrs["class_number"])
    B = idx.shape[0]
    iota = torch.arange(C, device=idx.device)
    pred = (idx.reshape(B, 1).long() == iota).float()
    true = (labels.reshape(B, 1).long() == iota).float()
    tp = torch.sum(pred * true, dim=0)
    fp = torch.sum(pred * (1 - true), dim=0)
    fn = torch.sum((1 - pred) * true, dim=0)
    tn = torch.sum((1 - pred) * (1 - true), dim=0)
    batch = torch.stack([tp, fp, tn, fn], dim=1)
    acc = batch if states is None else batch + states

    def metrics(st):
        tp_, fp_, fn_ = st[:, 0], st[:, 1], st[:, 3]
        zero = torch.zeros((), device=st.device)
        prec = torch.where(tp_ + fp_ > 0, tp_ / (tp_ + fp_ + 1e-12), zero)
        rec = torch.where(tp_ + fn_ > 0, tp_ / (tp_ + fn_ + 1e-12), zero)
        f1 = torch.where(prec + rec > 0, 2 * prec * rec / (prec + rec + 1e-12), zero)
        macro = torch.stack([prec.mean(), rec.mean(), f1.mean()])
        stp, sfp, sfn = tp_.sum(), fp_.sum(), fn_.sum()
        mprec = torch.where(stp + sfp > 0, stp / (stp + sfp + 1e-12), zero)
        mrec = torch.where(stp + sfn > 0, stp / (stp + sfn + 1e-12), zero)
        mf1 = torch.where(mprec + mrec > 0, 2 * mprec * mrec / (mprec + mrec + 1e-12), zero)
        return torch.cat([macro, torch.stack([mprec, mrec, mf1])])

    return {"BatchMetrics": [metrics(batch)], "AccumMetrics": [metrics(acc)],
            "AccumStatesInfo": [acc]}


# ---------------------------------------------------------------------------
# proximal optimizers and the model-average ops
# ---------------------------------------------------------------------------


def _prox(p, lr, l1, l2):
    return torch.sign(p) * torch.clamp(torch.abs(p) - lr * l1, min=0.0) / (1.0 + lr * l2)


@register("proximal_gd", no_grad=True)
@_opt_f32
def _proximal_gd(ctx, ins, attrs):
    (p,) = ins["Param"]
    (g,) = ins["Grad"]
    lr = ins["LearningRate"][0].reshape(())
    l1, l2 = float(attrs.get("l1", 0.0)), float(attrs.get("l2", 0.0))
    return {"ParamOut": [_prox(p - lr * g, lr, l1, l2)]}


@register("proximal_adagrad", no_grad=True)
@_opt_f32
def _proximal_adagrad(ctx, ins, attrs):
    (p,) = ins["Param"]
    (g,) = ins["Grad"]
    (m,) = ins["Moment"]
    lr = ins["LearningRate"][0].reshape(())
    l1, l2 = float(attrs.get("l1", 0.0)), float(attrs.get("l2", 0.0))
    m_out = m + torch.square(g)
    # the grad step scales by lr / sqrt(moment), the shrinkage by lr alone
    prox_param = p - lr * g / torch.sqrt(m_out + 1e-10)
    return {"ParamOut": [_prox(prox_param, lr, l1, l2)], "MomentOut": [m_out]}


@register("average_accumulates", no_grad=True)
def _average_accumulates(ctx, ins, attrs):
    """Sliding-window parameter sums for ModelAverage (reference
    average_accumulates_op.h, kMaxNumAccumulates window shifting)."""
    (p,) = ins["Param"]
    sum_1, sum_2, sum_3 = ins["Sums"]
    num_acc, old_num_acc, num_upd = [c.reshape(()) for c in ins["Counters"]]
    avg_window = float(attrs.get("average_window", 0.0))
    min_w = int(attrs.get("min_average_window", 10000))
    max_w = int(attrs.get("max_average_window", 10000))
    K_MAX = 16384

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    sum_1 = sum_1 + p
    fold = num_upd % K_MAX == 0
    sum_2 = torch.where(fold, sum_2 + sum_1, sum_2)
    sum_1 = torch.where(fold, torch.zeros_like(sum_1), sum_1)
    window = torch.minimum(torch.full((), max_w, dtype=num_upd.dtype, device=p.device),
                           (num_upd.float() * avg_window).to(num_upd.dtype))
    shift = (num_acc >= min_w) & (num_acc >= window)
    sum_3 = torch.where(shift, sum_1 + sum_2, sum_3)
    sum_1 = torch.where(shift, torch.zeros_like(sum_1), sum_1)
    sum_2 = torch.where(shift, torch.zeros_like(sum_2), sum_2)
    old_num_acc = torch.where(shift, num_acc, old_num_acc)
    num_acc = torch.where(shift, torch.zeros_like(num_acc), num_acc)
    return {
        "SumsOut": [sum_1, sum_2, sum_3],
        "CountersOut": [num_acc.reshape(1), old_num_acc.reshape(1), num_upd.reshape(1)],
    }


@register("average_apply", no_grad=True)
def _average_apply(ctx, ins, attrs):
    """Swap a parameter for its windowed average, backing up the live value."""
    (p,) = ins["Param"]
    sum_1, sum_2, sum_3 = ins["Sums"]
    num_acc, old_num_acc = [c.reshape(()) for c in ins["Counters"]]
    total = (num_acc + old_num_acc).to(p.dtype)
    avg = (sum_1 + sum_2 + sum_3) / torch.clamp(total, min=1.0)
    return {"ParamOut": [avg.to(p.dtype)], "Backup": [p]}
