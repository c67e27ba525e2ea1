#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi), then build every kernel
     of paddle_tpu_torch/ops/csrc/ with nvcc, one process per source, all
     at once;
  2. each kernel against its plain torch version at the full-width shapes
     of the main paths, with max abs error against its tolerance and the
     kernel / plain / library-call times in ms:
     - paged flash (decode q [8, 768] / table [8, 64]; prefill chunk
       q [32, 768] / table [64]), seeded inputs with pos < 0 rows, rows on a
       page boundary and partly filled last pages; atol = rtol = 1e-5;
     - the GEMM epilogue at Transformer base's FFN shapes (4096 x 512 @
       512 x 2048 + relu, 4096 x 2048 @ 2048 x 512); atol = rtol = 1e-4;
     - layer_norm forward (4096 x 512, with and without the residual), 1e-5;
       backward, dx 1e-5, dscale / dbias rtol 1e-4 atol 1e-3;
     - multi-tensor Adam over the model's 183 tensors (f32 moments, bit for
       bit; bf16 moments, one bf16 ulp) and a ragged-tail set (bit for bit);
  3. serving: a GenerationEngine over GPTDecoder at GPT-2 small's widths
     (12 layers, 12 heads, d_model 768, d_inner 3072, vocab 50257, 1024
     positions; random weights from a seed), warmup(), then a
     GenerationScheduler answering 8 concurrent greedy requests with prompts
     of 40-700 tokens and 32 new tokens each. Every request must finish,
     no variant may be rebuilt after warmup, both paged kernel launch
     counters must move, and two requests must match serial engine.generate;
  4. paged vs dense: the engine's prefill and decode logits against the
     whole-sequence program build_forward(1, 64) on the same parameters;
  5. training: Transformer base (6 layers, d_model 512, d_ff 2048, 8 heads,
     vocab 37000, batches of 16 x 256 tokens, dropout 0.1, f32; random
     weights from a seed) trained by Executor.run under the training_fused
     pass preset for 6 steps: every loss finite, every training kernel
     launched by the expected count each step, then the first 3 losses
     against an unfused run (no pass pipeline) from the same seed within
     rtol 2e-3, atol 2e-4; step wall p50, target tokens/s, the device's
     busy share and its launches a step;
  6. a `kernels` JSON line (launches, error, times, bound per kernel).
The last line is {"ok": true, "device": {...}}.

Without a CUDA device, or without the paddle_tpu_torch package beside it,
the script exits non-zero and prints no result.
"""

import json
import os
import sys
import time

import numpy as np

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores, NVIDIA data sheet
ATOL = RTOL = 1e-5  # kernel vs plain: both f32, sums in another order
LOGIT_ATOL = LOGIT_RTOL = 1e-4  # paged vs dense, 12 layers of f32 rounding

GPT2_SMALL = dict(vocab_size=50257, n_layer=12, n_head=12, d_model=768,
                  d_inner=3072, max_context=1024)
ENGINE = dict(max_slots=8, page_size=16, max_context=1024)
PROMPT_LENS = (40, 131, 217, 305, 388, 472, 569, 700)
NEW_TOKENS = 32
NO_EOS = -1  # never sampled: every request generates NEW_TOKENS tokens

KERNEL_META = {
    "paged_flash": ("paddle_tpu/ops/pallas_kernels.py:1470", False),
    "paged_flash_shared": ("paddle_tpu/ops/pallas_kernels.py:1505", True),
}

# training kernels: tolerances against the plain versions
GEMM_TOL = 1e-4  # k up to 2048, sums in another order
LN_TOL = 1e-5  # f32 statistics
LN_SUM_RTOL, LN_SUM_ATOL = 1e-4, 1e-3  # dscale / dbias: sums over 4096 rows
TRAIN_STEPS = 6  # fused steps of the training phase
COMPARE_STEPS = 3  # of them compared with the unfused run
FUSED_RTOL, FUSED_ATOL = 2e-3, 2e-4  # the JAX package's fused-vs-unfused bar


def log(msg):
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log("[%s] start" % self.name)
        return self

    def __exit__(self, et, ev, tb):
        if ev is None:
            log("[%s] ok %.1f s" % (self.name, time.perf_counter() - self.t0))
        return False


# ---------------------------------------------------------------- phase 2


def paged_case(torch, device, shared, seed):
    """Full-width inputs: pool of 513 pages of 16 rows x 768, decode rows
    with per-slot tables or one prefill chunk with a shared table."""
    rng = np.random.RandomState(seed)
    ps, n_head, d = ENGINE["page_size"], 12, 64
    feat = n_head * d
    max_pages = ENGINE["max_context"] // ps
    pool_pages = ENGINE["max_slots"] * max_pages + 1
    kp = rng.randn(pool_pages * ps, feat).astype("float32")
    vp = rng.randn(pool_pages * ps, feat).astype("float32")
    pages = rng.permutation(np.arange(1, pool_pages)).astype(np.int32)
    if shared:
        rows = 32
        # a chunk starting mid-page at 600, crossing pages 608 and 624; the
        # last two rows are dead (pos < 0)
        pos = np.arange(600, 600 + rows, dtype=np.int32)
        pos[-2:] = -1
        bt = np.zeros(max_pages, np.int32)
        need = pos.max() // ps + 1
        bt[:need] = pages[:need]
    else:
        rows = ENGINE["max_slots"]
        # idle slot, first row, page boundary (15, 16), partial last pages,
        # the last position of the context
        pos = np.array([-1, 0, 15, 16, 333, 700, 871, 1023], np.int32)
        bt = np.zeros((rows, max_pages), np.int32)
        used = 0
        for r in range(rows):
            need = pos[r] // ps + 1 if pos[r] >= 0 else 0
            bt[r, :need] = pages[used:used + need]
            used += need
    q = rng.randn(rows, feat).astype("float32")
    args = [torch.from_numpy(a).to(device) for a in (q, kp, vp, bt, pos)]
    return args, dict(n_head=n_head, page_size=ps)


def _bound(nbytes, flops):
    """(ms, what bounds it): the larger of the bytes over the HBM rate and
    the f32 operations over the f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bound(pos, shared, rows, feat, ps, n_pages):
    """Least time for the work these inputs need: each input byte read
    once (only the K/V pages up to pos), each output byte written once,
    against the f32 flops of QK^T and PV over the live entries."""
    live = [min(int(p) + 1, n_pages * ps) if p >= 0 else 0 for p in pos]
    if shared:
        kv_rows = (max(live) + ps - 1) // ps * ps
    else:
        kv_rows = sum((n + ps - 1) // ps * ps for n in live)
    table = (n_pages if shared else rows * n_pages) * 4
    nbytes = 2 * kv_rows * feat * 4 + 2 * rows * feat * 4 + table + rows * 4
    return _bound(nbytes, sum(4 * n * feat for n in live))


GATE_CYCLES = 400_000_000  # a sleep kernel of ~0.2 s at the H100's clocks


def profiled_device_ms(torch, fn, n):
    """Mean device ms per call over n calls: the summed time of the kernels
    and copies torch.profiler records. For a function of thousands of
    launches, which cannot be queued behind a gate (the launch queue fills
    and the host waits on the card)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise RuntimeError("torch.profiler recorded no device time")
    return sum(e.device_time_total for e in dev) / 1e3 / n


def time_ms(torch, fn, n, flush, gated):
    """Mean ms per call over n calls, each with a cold L2 (a 64 MB buffer is
    rewritten between calls, outside the timed region).

    gated: the calls are queued behind a sleep kernel, so the card runs them
    back to back and each event pair brackets device work only (the
    kernel's time). Ungated, the card waits on the host between calls and
    the pair also holds the wrapper's launch cost (the time a caller sees)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    if gated:
        gate = torch.cuda.Event()
        torch.cuda._sleep(GATE_CYCLES)
        gate.record()
    for i in range(n):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    if gated and gate.query():
        raise RuntimeError("the gate opened before %d calls were queued: "
                           "the device times would hold host gaps" % n)
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / n


def check_kernels(torch, pf, device):
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    results = {}
    for name, (replaces, shared) in KERNEL_META.items():
        args, kw = paged_case(torch, device, shared, SEED + len(name))
        got = pf.paged_flash_attention(*args, **kw)
        want = pf.paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
            raise AssertionError("%s: kernel vs plain max abs err %g" % (name, err))
        dead = args[4] < 0
        if dead.any() and float(got[dead].abs().max()) != 0.0:
            raise AssertionError("%s: pos < 0 rows are not exact zeros" % name)
        kernel = lambda: pf.paged_flash_attention(*args, **kw)  # noqa: E731
        ms = time_ms(torch, kernel, 50, flush, gated=True)
        call_ms = time_ms(torch, kernel, 50, flush, gated=False)
        plain_ms = time_ms(torch, lambda: pf.paged_attention_plain(*args, **kw), 10, flush,
                           gated=True)
        q, bt, pos = args[0], args[3], args[4]
        bound_ms, bound_by = bound(
            pos.tolist(), shared, q.shape[0], q.shape[1], kw["page_size"], bt.shape[-1]
        )
        results[name] = {
            "name": name,
            "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/paged_flash.cu",
            "replaces": replaces,
            "launches": None,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no single PyTorch call reads a paged pool through a block table
            "library_ms": None,
        }
        log("kernel %s: q %s table %s max_abs_err %.3g (atol=rtol=%g) kernel %.4f ms "
            "(device), %.4f ms a call with the wrapper's launch cost; plain %.4f ms "
            "(device); bound %.4f ms (%s)" % (
                name, tuple(q.shape), tuple(bt.shape), err, ATOL, ms, call_ms, plain_ms,
                bound_ms, bound_by))
    return results


def _entry(name, source, replaces, err, ms, plain_ms, bound_ms, bound_by, library_ms):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def _close(torch, name, got, want, atol, rtol):
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError("%s: kernel vs plain max abs err %g (atol %g rtol %g)"
                             % (name, err, atol, rtol))
    return err


def _within_bf16_ulp(torch, name, got, want):
    want = want.float()
    ulp = torch.pow(2.0, torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    err = (got.float() - want).abs()
    if bool((err > ulp).any()):
        raise AssertionError("%s: %d values more than one bf16 ulp from the plain version"
                             % (name, int((err > ulp).sum())))
    return float(err.max())


def check_gemm(torch, ge, device, flush):
    """The two FFN GEMMs of Transformer base (m = 16 x 256 tokens). The
    kernels-line entry is the second (act none), for which torch.addmm
    computes the same function."""
    rng = np.random.RandomState(SEED + 11)
    out = {}
    for case, (m, k, n, act) in (("ffn1", (4096, 512, 2048, "relu")),
                                 ("ffn2", (4096, 2048, 512, None))):
        x = torch.from_numpy(rng.randn(m, k).astype("float32")).to(device)
        w = torch.from_numpy((rng.randn(k, n) / np.sqrt(k)).astype("float32")).to(device)
        b = torch.from_numpy(rng.randn(n).astype("float32")).to(device)
        z, y = ge.gemm_bias_act(x, w, b, act)
        zp, yp = ge.gemm_bias_act_plain(x, w, b, act)
        torch.cuda.synchronize()
        err = _close(torch, "gemm_epilogue " + case, z, zp, GEMM_TOL, GEMM_TOL)
        if act:
            err = max(err, _close(torch, "gemm_epilogue " + case, y, yp, GEMM_TOL, GEMM_TOL))
        ms = time_ms(torch, lambda: ge.gemm_bias_act(x, w, b, act), 20, flush, gated=True)
        plain_ms = time_ms(torch, lambda: ge.gemm_bias_act_plain(x, w, b, act), 10, flush,
                           gated=True)
        lib_ms = None
        if act is None:
            lib_ms = time_ms(torch, lambda: torch.addmm(b, x, w), 20, flush, gated=True)
        bound_ms, bound_by = _bound((m * k + k * n + n + (2 if act else 1) * m * n) * 4,
                                    2 * m * n * k)
        log("kernel gemm_epilogue %s: x %s @ w %s act %s max_abs_err %.3g (atol=rtol=%g) "
            "kernel %.4f ms (device); plain %.4f ms; torch.addmm %s; bound %.4f ms (%s)" % (
                case, (m, k), (k, n), act, err, GEMM_TOL, ms, plain_ms,
                "%.4f ms" % lib_ms if lib_ms is not None else "n/a (act)",
                bound_ms, bound_by))
        out[case] = _entry("gemm_epilogue", "paddle_tpu_torch/ops/csrc/gemm_epilogue.cu",
                           "paddle_tpu/ops/pallas_kernels.py:1121", err, ms, plain_ms,
                           bound_ms, bound_by, lib_ms)
    return out["ffn2"]


def check_layer_norm(torch, ln, device, flush):
    """layer_norm at (4096, 512): forward with the residual (the main
    path's form and the kernels-line entry) and without (a side reading
    against torch.native_layer_norm, which computes that form), then the
    backward against native_layer_norm_backward."""
    rng = np.random.RandomState(SEED + 12)
    rows, cols, eps = 4096, 512, 1e-5

    def t(a):
        return torch.from_numpy(a.astype("float32")).to(device)

    x, r, dy = t(rng.randn(rows, cols) * 2 + 0.5), t(rng.randn(rows, cols)), t(rng.randn(rows, cols))
    scale, bias = t(rng.rand(cols) + 0.5), t(rng.randn(cols))
    entries = {}
    for form, res in (("residual", r), ("plain", None)):
        got = ln.fused_layer_norm(x, res, scale, bias, eps)
        want = ln.fused_layer_norm_plain(x, res, scale, bias, eps)
        torch.cuda.synchronize()
        if res is not None and not torch.equal(got[0], want[0]):
            raise AssertionError("layer_norm: the residual sum differs from x + r")
        err = max(_close(torch, "layer_norm " + form, g, w_, LN_TOL, LN_TOL)
                  for g, w_ in zip(got[1:], want[1:]))
        ms = time_ms(torch, lambda: ln.fused_layer_norm(x, res, scale, bias, eps), 50, flush,
                     gated=True)
        plain_ms = time_ms(torch, lambda: ln.fused_layer_norm_plain(x, res, scale, bias, eps),
                           20, flush, gated=True)
        lib_ms = None
        if res is None:
            lib_ms = time_ms(torch, lambda: torch.native_layer_norm(x, [cols], scale, bias, eps),
                             50, flush, gated=True)
        n_in = 2 if res is not None else 1
        n_out = 2 if res is not None else 1
        bound_ms, bound_by = _bound(((n_in + n_out) * rows * cols + 2 * cols + 2 * rows) * 4,
                                    8 * rows * cols)
        log("kernel layer_norm (%s): (%d, %d) max_abs_err %.3g (atol=rtol=%g) kernel %.4f ms "
            "(device); plain %.4f ms; torch.native_layer_norm %s; bound %.4f ms (%s)" % (
                form, rows, cols, err, LN_TOL, ms, plain_ms,
                "%.4f ms" % lib_ms if lib_ms is not None
                else "none (no single call returns both s and y)",
                bound_ms, bound_by))
        entries[form] = _entry("layer_norm", "paddle_tpu_torch/ops/csrc/layer_norm.cu",
                               "paddle_tpu/ops/pallas_kernels.py:1802", err, ms, plain_ms,
                               bound_ms, bound_by, lib_ms)
    _, _, mean, var = ln.fused_layer_norm_plain(x, None, scale, bias, eps)
    got = ln.fused_layer_norm_grad(x, scale, mean, var, dy, eps)
    want = ln.fused_layer_norm_grad_plain(x, scale, mean, var, dy, eps)
    torch.cuda.synchronize()
    err = _close(torch, "layer_norm_grad dx", got[0], want[0], LN_TOL, LN_TOL)
    for name, g, w_ in (("dscale", got[1], want[1]), ("dbias", got[2], want[2])):
        err = max(err, _close(torch, "layer_norm_grad " + name, g, w_, LN_SUM_ATOL, LN_SUM_RTOL))
    again = ln.fused_layer_norm_grad(x, scale, mean, var, dy, eps)
    if not (torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])):
        raise AssertionError("layer_norm_grad: dscale / dbias differ from run to run")
    rstd = torch.rsqrt(var + eps)[:, None]
    mask = [True, True, True]
    ms = time_ms(torch, lambda: ln.fused_layer_norm_grad(x, scale, mean, var, dy, eps), 50,
                 flush, gated=True)
    plain_ms = time_ms(torch, lambda: ln.fused_layer_norm_grad_plain(x, scale, mean, var, dy, eps),
                       20, flush, gated=True)
    lib_ms = time_ms(torch, lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, [cols], mean[:, None], rstd, scale, bias, mask), 50, flush, gated=True)
    bound_ms, bound_by = _bound((3 * rows * cols + 3 * cols + 2 * rows) * 4, 12 * rows * cols)
    log("kernel layer_norm_grad: (%d, %d) max_abs_err %.3g (dx atol=rtol=%g; dscale/dbias "
        "rtol %g atol %g; the sums repeat bit for bit) kernel %.4f ms (device); plain %.4f ms; "
        "native_layer_norm_backward %.4f ms; bound %.4f ms (%s)" % (
            rows, cols, err, LN_TOL, LN_SUM_RTOL, LN_SUM_ATOL, ms, plain_ms, lib_ms,
            bound_ms, bound_by))
    entries["grad"] = _entry("layer_norm_grad", "paddle_tpu_torch/ops/csrc/layer_norm.cu",
                             "paddle_tpu/ops/pallas_kernels.py:1899", err, ms, plain_ms,
                             bound_ms, bound_by, lib_ms)
    return entries["residual"], entries["grad"]


def _adam_set(torch, device, shapes, moment_dtype, seed):
    rng = np.random.RandomState(seed)
    mdt = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype("float32")).to(device=device, dtype=dt)

    params = [t(rng.randn(*s) * 0.05) for s in shapes]
    grads = [t(rng.randn(*s) * 1e-3) for s in shapes]
    m1s = [t(rng.randn(*s) * 1e-4, mdt) for s in shapes]
    m2s = [t(np.abs(rng.randn(*s)) * 1e-7, mdt) for s in shapes]
    lr_t = torch.from_numpy((1e-3 * (1 + rng.rand(len(shapes)))).astype("float32")).to(device)
    return params, grads, m1s, m2s, lr_t


def _adam_check(torch, ma, name, device, shapes, moment_dtype, seed):
    kern = _adam_set(torch, device, shapes, moment_dtype, seed)
    plain = _adam_set(torch, device, shapes, moment_dtype, seed)
    ma.multi_tensor_adam(*kern, 0.9, 0.999, 1e-8)
    ma.multi_tensor_adam_plain(*plain, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    err = 0.0
    for slot in (0, 2, 3):
        for got, want in zip(kern[slot], plain[slot]):
            if got.dtype == torch.bfloat16:
                err = max(err, _within_bf16_ulp(torch, name, got, want))
                continue
            # the same f32 expressions, rounded the same way: bit for bit
            err = max(err, float((got - want).abs().max()) if got.numel() else 0.0)
            if not torch.equal(got, want):
                raise AssertionError("%s: f32 output differs from the plain version, max abs "
                                     "err %g" % (name, err))
    return err, kern


def check_adam(torch, ma, device, flush, shapes):
    """Adam over the model's parameter shapes, f32 and bf16 moments, and a
    ragged-tail set; the f32 set is the kernels-line entry, against
    torch._fused_adam_ over the same list."""
    ragged = [(7, 13), (4097,), (1,), (3 * 4096 + 5,), (33, 4095)]
    err_r, _ = _adam_check(torch, ma, "multi_adam ragged", device, ragged, "float32", SEED + 13)
    err_b, bset = _adam_check(torch, ma, "multi_adam bf16", device, shapes, "bfloat16", SEED + 14)
    bf16_ms = time_ms(torch, lambda: ma.multi_tensor_adam(*bset, 0.9, 0.999, 1e-8), 10, flush,
                      gated=True)
    del bset
    err, kset = _adam_check(torch, ma, "multi_adam", device, shapes, "float32", SEED + 15)
    ms = time_ms(torch, lambda: ma.multi_tensor_adam(*kset, 0.9, 0.999, 1e-8), 10, flush,
                 gated=True)
    # the plain version is ~2700 launches a call: summed device time instead
    plain_ms = profiled_device_ms(
        torch, lambda: ma.multi_tensor_adam_plain(*kset, 0.9, 0.999, 1e-8), 2)
    p, g, m1, m2, _ = kset
    steps = [torch.ones((), device=device) for _ in p]
    lib_ms = time_ms(torch, lambda: torch._fused_adam_(
        p, g, m1, m2, [], steps, lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.0,
        eps=1e-8, amsgrad=False, maximize=False), 10, flush, gated=True)
    elems = sum(int(np.prod(s)) for s in shapes)
    bound_ms, bound_by = _bound(elems * 28 + len(shapes) * 4, 12 * elems)
    log("kernel multi_adam: %d tensors, %d elements, f32 moments and the ragged set equal "
        "to the plain version bit for bit; bf16 moments max err %.3g (one bf16 ulp) %.4f ms; "
        "kernel %.4f ms (device); plain %.4f ms (profiler, device); torch._fused_adam_ "
        "%.4f ms; bound %.4f ms (%s)"
        % (len(shapes), elems, err_b, bf16_ms, ms, plain_ms, lib_ms, bound_ms, bound_by))
    return _entry("multi_adam", "paddle_tpu_torch/ops/csrc/multi_adam.cu",
                  "paddle_tpu/ops/pallas_kernels.py:1993", max(err, err_r), ms, plain_ms,
                  bound_ms, bound_by, lib_ms)


def check_training_kernels(torch, device, shapes):
    from paddle_tpu_torch.ops import gemm_epilogue as ge
    from paddle_tpu_torch.ops import layer_norm as ln
    from paddle_tpu_torch.ops import multi_adam as ma

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    out = {"gemm_epilogue": check_gemm(torch, ge, device, flush)}
    out["layer_norm"], out["layer_norm_grad"] = check_layer_norm(torch, ln, device, flush)
    out["multi_adam"] = check_adam(torch, ma, device, flush, shapes)
    return out


# ---------------------------------------------------------------- phase 3


def timed(fn, sink):
    def wrapper(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        sink.append((time.perf_counter() - t0) * 1e3)
        return out

    return wrapper


def serve(torch, pf, engine, card):
    from paddle_tpu_torch.serving import GenerationScheduler

    rng = np.random.RandomState(SEED)
    prompts = [
        rng.randint(2, GPT2_SMALL["vocab_size"], size=n).tolist() for n in PROMPT_LENS
    ]
    traces = engine.traces
    # per-call host wall time of the engine's two step kinds (each ends in
    # the logits copy to the host, so it includes the device work)
    step_ms, chunk_ms = [], []
    engine.decode_step = timed(engine.decode_step, step_ms)
    engine.prefill_step = timed(engine.prefill_step, chunk_ms)
    sched = GenerationScheduler(engine, max_queue_requests=64, timeout_ms=600000.0)
    try:
        pf.reset_kernel_launches()
        t0 = time.perf_counter()
        futs = [sched.submit(p, max_new_tokens=NEW_TOKENS, eos_id=NO_EOS) for p in prompts]
        results = [f.result(600) for f in futs]
        wall = time.perf_counter() - t0
        launches = pf.kernel_launches()
    finally:
        assert sched.close(drain=True)
        del engine.decode_step, engine.prefill_step
    for p, r in zip(prompts, results):
        if r.finish_reason != "length" or len(r.tokens) != NEW_TOKENS:
            raise AssertionError("request of %d tokens: %r %d tokens" % (
                len(p), r.finish_reason, len(r.tokens)))
    if engine.traces != traces:
        raise AssertionError("variants rebuilt after warmup: %d -> %d" % (traces, engine.traces))
    if not all(launches.values()):
        raise AssertionError("a kernel never launched on the main path: %s" % launches)
    for i in (0, len(prompts) - 1):
        want = engine.generate(prompts[i], max_new_tokens=NEW_TOKENS, eos_id=NO_EOS)
        if want.tokens != results[i].tokens:
            raise AssertionError("request %d: scheduler tokens differ from serial generate" % i)
    if not np.all(np.isfinite(engine.last_logits)):
        raise AssertionError("non-finite decode logits")
    n_tok = sum(len(r.tokens) for r in results)
    log("serve: %d requests, %d prompt tokens, %d new tokens in %.3f s: %.1f tokens/s; "
        "decode step p50 %.3f ms over %d steps; prefill chunk p50 %.3f ms over %d chunks; "
        "kernel launches %s; card %s" % (
            len(results), sum(PROMPT_LENS), n_tok, wall, n_tok / wall,
            float(np.median(step_ms)), len(step_ms), float(np.median(chunk_ms)),
            len(chunk_ms), json.dumps(launches), card))
    return launches


# ---------------------------------------------------------------- phase 4


def paged_vs_dense(engine):
    from paddle_tpu_torch.executor import aot_serve_lowering, scope_guard
    from paddle_tpu_torch.serving import GenRequest

    T = 64
    main, _, feeds, fetches = engine.model.build_forward(1, T)
    with scope_guard(engine.scope):
        dense, ro, _ = aot_serve_lowering(main, feeds, fetches, engine.scope)

    def dense_row(tokens):
        buf = np.zeros((1, T, 1), np.int64)
        buf[0, :len(tokens), 0] = tokens
        (lg,) = dense({"fwd_tokens": buf}, ro, {})
        return lg[0, len(tokens) - 1].cpu().numpy()

    prompt = np.random.RandomState(SEED + 1).randint(2, GPT2_SMALL["vocab_size"], 40).tolist()
    run = engine.start(GenRequest(prompt, max_new_tokens=T - len(prompt), eos_id=NO_EOS))
    rows, seq = [engine.last_prefill_logits], list(prompt)
    try:
        while not run.done:
            engine.decode_step([run])
            rows.append(engine.last_logits[run.slot])
    finally:
        engine.finish(run)
    err = 0.0
    for step, row in enumerate(rows):
        want = dense_row(seq)
        if row.shape != want.shape or not np.all(np.isfinite(row)):
            raise AssertionError("step %d: bad logits %s" % (step, row.shape))
        err = max(err, float(np.abs(row - want).max()))
        if not np.allclose(row, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL):
            raise AssertionError("step %d: paged vs dense max abs err %g" % (step, err))
        seq.append(run.tokens[step])
    log("paged vs dense: %d steps (prefill + decode to %d tokens), max abs logit err %.3g "
        "(atol=rtol=%g)" % (len(rows), T, err, LOGIT_ATOL))


# ---------------------------------------------------------------- phase 5


def _train_run(torch, main_prog, startup, loss, batches, pipeline, fused, step_check):
    """Steps of the training program from a fresh scope seeded with SEED
    under `pipeline`; returns (losses, walls, scope, exe, step)."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope, flags, scope_guard

    flags.set_flags({"pass_pipeline": pipeline})
    place = CUDAPlace(0)
    scope, exe = Scope(seed=SEED, place=place), Executor(place)

    def step(batch):
        with scope_guard(scope):
            (lv,) = exe.run(main_prog, feed=batch, fetch_list=[loss.name])
        return float(lv.reshape(-1)[0])

    with scope_guard(scope):
        exe.run(startup)
    torch.cuda.synchronize()
    losses, walls = [], []
    for i, b in enumerate(batches):
        before = fused.stats()
        t0 = time.perf_counter()
        losses.append(step(b))
        walls.append((time.perf_counter() - t0) * 1e3)
        step_check(i, before, fused.stats())
        if not np.isfinite(losses[-1]):
            raise AssertionError("%s step %d: loss %r" % (pipeline or "unfused", i, losses[-1]))
    return losses, walls, scope, step


def train(torch, card):
    """Transformer base under training_fused for TRAIN_STEPS steps, then an
    unfused run from the same seed; returns the training kernels' launches
    over the fused steps."""
    from paddle_tpu_torch.ops import fused, registry
    from paddle_tpu_torch.tools import profile_training as prof

    cfg = prof.BASE
    t0 = time.perf_counter()
    main_prog, startup, loss = prof.build(cfg)
    n_adam = sum(op.type == "adam" for op in main_prog.global_block().ops)
    batches = [prof.make_batch(cfg, SEED + i) for i in range(TRAIN_STEPS)]
    # per step: two GEMMs in each FFN, a residual layer_norm after each
    # sublayer (2 in an encoder layer, 3 in a decoder layer) and its grad,
    # one Adam launch for the whole (f32) parameter set
    want = {"gemm_epilogue": 4 * cfg["n_layer"], "layer_norm": 5 * cfg["n_layer"],
            "layer_norm_grad": 5 * cfg["n_layer"], "multi_adam": 1}

    def fused_check(i, before, after):
        for k, n in want.items():
            got = after["launches"][k] - before["launches"][k]
            disp = after["dispatches"].get(k, 0) - before["dispatches"].get(k, 0)
            if got != n or disp != n:
                raise AssertionError("step %d: %s launched %d times, dispatched %d, want %d"
                                     % (i, k, got, disp, n))

    def unfused_check(i, before, after):
        if after != before:
            raise AssertionError("step %d of the unfused run moved the counters: %s -> %s"
                                 % (i, before, after))

    fused.reset_stats()  # the main path's counting window opens here
    losses, walls, scope, step = _train_run(torch, main_prog, startup, loss, batches,
                                            "training_fused", fused, fused_check)
    launches = fused.stats()["launches"]  # and closes here
    log("train: Transformer base %s, %d Adam ops, built and initialised in %.1f s" % (
        json.dumps(cfg), n_adam, time.perf_counter() - t0))
    # steps 2-6: the first applies the pass pipeline and prepares the block
    wall_p50 = float(np.median(walls[1:]))
    tokens_per_s = sum(prof.target_tokens(b) for b in batches[1:]) / (sum(walls[1:]) / 1e3)
    breakdown = prof.profile_steps(step, batches[:2], registry)
    del scope, step
    torch.cuda.empty_cache()
    ref, _, uscope, ustep = _train_run(torch, main_prog, startup, loss,
                                       batches[:COMPARE_STEPS], "", fused, unfused_check)
    del uscope, ustep
    torch.cuda.empty_cache()
    a, b = np.asarray(losses[:COMPARE_STEPS]), np.asarray(ref)
    if not np.allclose(a, b, rtol=FUSED_RTOL, atol=FUSED_ATOL):
        raise AssertionError("fused vs unfused losses differ: %s vs %s" % (a.tolist(), b.tolist()))
    log("train: %d fused steps, losses %s; unfused %s (max abs diff %.3g, rtol %g atol %g); "
        "step wall p50 %.3f ms over steps 2-%d (step 1 %.1f ms, with the pass pipeline); "
        "%.1f target tokens/s (their target tokens over their summed wall); device busy %s ms "
        "a step = %s of the wall p50 of the profiled window (%.3f ms), %s device launches a "
        "step; kernel launches %s (per step %s); card %s" % (
            TRAIN_STEPS, ["%.6f" % v for v in losses], ["%.6f" % v for v in ref],
            float(np.abs(a - b).max()), FUSED_RTOL, FUSED_ATOL, wall_p50, TRAIN_STEPS,
            walls[0], tokens_per_s, breakdown["device_busy_ms_per_step"],
            breakdown["device_busy_share"], breakdown["wall_ms_p50"],
            breakdown["device_launches_per_step"], json.dumps(launches), json.dumps(want), card))
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from paddle_tpu_torch import CUDAPlace
        from paddle_tpu_torch.models import GPTDecoder
        from paddle_tpu_torch.ops import _build
        from paddle_tpu_torch.ops import paged_flash as pf
        from paddle_tpu_torch.serving import GenerationEngine
        from paddle_tpu_torch.tools import profile_training as prof
    except ImportError as e:
        print("chip_smoke: the paddle_tpu_torch package is missing: %s" % e, file=sys.stderr)
        return 2
    # full f32 products on the card (the reference for every tolerance here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    with Phase("build"):
        card = prof.card_line()
        log(card)
        t0 = time.perf_counter()
        _build.build_all()  # one nvcc per source, all at once
        log("nvcc sm_90a build of %s in %.1f s" % (sorted(_build.build_logs), time.perf_counter() - t0))
        for stem, text in sorted(_build.build_logs.items()):
            ptxas = [ln.split(":", 1)[-1].strip() for ln in text.splitlines()
                     if "registers" in ln or "spill" in ln]
            log("ptxas %s: %s" % (stem, " | ".join(ptxas)))
    with Phase("kernels vs plain"):
        kernels = check_kernels(torch, pf, device)
        main_prog = prof.build(prof.BASE)[0]
        shapes = [tuple(p.shape) for p in main_prog.global_block().all_parameters()
                  if p.trainable]
        del main_prog
        kernels.update(check_training_kernels(torch, device, shapes))
    with Phase("serve"):
        t0 = time.perf_counter()
        engine = GenerationEngine(GPTDecoder(**GPT2_SMALL), name="gpt2_small",
                                  place=CUDAPlace(0), **ENGINE)
        n = engine.warmup()
        torch.cuda.synchronize()
        log("engine: %d variants built, params + pools ready in %.1f s; KV pools %.3f GB" % (
            n, time.perf_counter() - t0, engine.kv_state_bytes / 1e9))
        launches = serve(torch, pf, engine, card)
    with Phase("paged vs dense"):
        paged_vs_dense(engine)
    del engine
    torch.cuda.empty_cache()
    with Phase("train"):
        launches.update(train(torch, card))
    for name, n in launches.items():
        kernels[name]["launches"] = n
    if not all(k["launches"] for k in kernels.values()):
        raise AssertionError("a kernel never launched on its main path: %s"
                             % {k: v["launches"] for k, v in kernels.items()})
    log(json.dumps({"kernels": list(kernels.values())}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
