#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi), then build the kernels
     from paddle_tpu_torch/ops/csrc/ with nvcc;
  2. each kernel against its plain torch version at the full-width shapes
     of the main path (decode q [8, 768] / table [8, 64]; prefill chunk
     q [32, 768] / table [64]), on seeded random inputs with pos < 0 rows,
     rows on a page boundary and partly filled last pages; max abs error
     against atol = rtol = 1e-5, and kernel / plain times in ms;
  3. the main path: a GenerationEngine over GPTDecoder at GPT-2 small's
     widths (12 layers, 12 heads, d_model 768, d_inner 3072, vocab 50257,
     1024 positions; random weights from a seed), warmup(), then a
     GenerationScheduler answering 8 concurrent greedy requests with prompts
     of 40-700 tokens and 32 new tokens each. Every request must finish,
     no variant may be rebuilt after warmup, both kernel launch counters
     must move, and two requests must match serial engine.generate;
  4. paged vs dense: the engine's prefill and decode logits against the
     whole-sequence program build_forward(1, 64) on the same parameters;
  5. a `kernels` JSON line (launches, error, times, bound per kernel).
The last line is {"ok": true, "device": {...}}.

Without a CUDA device, or without the paddle_tpu_torch package beside it,
the script exits non-zero and prints no result.
"""

import json
import os
import subprocess
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


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


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
    flops = sum(4 * n * feat for n in live)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


GATE_CYCLES = 400_000_000  # a sleep kernel of ~0.2 s at the H100's clocks


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from paddle_tpu_torch import CUDAPlace
        from paddle_tpu_torch.models import GPTDecoder
        from paddle_tpu_torch.ops import paged_flash as pf
        from paddle_tpu_torch.serving import GenerationEngine
    except ImportError as e:
        print("chip_smoke: the paddle_tpu_torch package is missing: %s" % e, file=sys.stderr)
        return 2
    # full f32 products on the card (the reference for every tolerance here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    with Phase("build"):
        card = card_line()
        log(card)
        t0 = time.perf_counter()
        pf.build()
        ptxas = [ln.strip() for ln in pf.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log("nvcc sm_90a build %.1f s; %s" % (time.perf_counter() - t0, " | ".join(ptxas)))
    with Phase("kernels vs plain"):
        kernels = check_kernels(torch, pf, device)
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
    for name, n in launches.items():
        kernels[name]["launches"] = n
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
