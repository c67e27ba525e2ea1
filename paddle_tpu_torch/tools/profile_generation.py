"""Where a generation step's time goes, on one CUDA card.

    python3 -m paddle_tpu_torch.tools.profile_generation [--steps 20] \
        [--kv-dtype float32|int8] [--per-op] [--out profile_generation.json]

Builds the GenerationEngine at chip_smoke.py's geometry (GPTDecoder at GPT-2
small's widths, random weights from a seed, page_size 16, 1024 positions;
8 slots over f32 KV pools, or with --kv-dtype int8 16 slots over int8
pools, the JAX package's int8-KV recipe), fills every slot with prompts of
40-700 tokens (each length once per 8 slots), and then, for the two step
kinds of the main path (a 32-row prefill chunk and a decode step over all
slots), measures steady windows, one per instrument, on the graph path
(each step a replayed CUDA graph, captured at warmup):

- bare: the step's host wall time (each step ends in the logits copy to
  the host, so it includes the device work);
- torch.profiler: the device time of every kernel and copy, giving the
  device's busy share of the bare wall time, the launches and the top
  kernels.

With --per-op the same two windows are also taken on the op-by-op path
(FLAGS_profile_ops inside profiler.profiler(): every op lowered eagerly,
with a device sync after each), and a third under the op timer: the host
time spent inside each op type's lowering, by timing every lowering call.

Prints one summary line per step kind and writes the whole breakdown as JSON.
Exits non-zero without a CUDA device.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

GPT2_SMALL = dict(vocab_size=50257, n_layer=12, n_head=12, d_model=768,
                  d_inner=3072, max_context=1024)
ENGINE = dict(max_slots=8, page_size=16, max_context=1024)
# int8 pools at a quarter of the f32 bytes a token: twice the slots
INT8_ENGINE = dict(ENGINE, max_slots=16)
PROMPT_LENS = (40, 131, 217, 305, 388, 472, 569, 700)
SEED = 0


class _Lowerings:
    """Wraps every registered lowering, and every fused family's lowering,
    in `self.around(name, call)` while entered. Only the outermost call is
    wrapped: a lowering called from inside another (a generic grad replays
    its forward op's lowering under torch.func.vjp) goes through
    `self.nested(name, call)`, which counts it toward the outer op
    (`self.outer`)."""

    def __init__(self, registry):
        self.registry = registry
        self._depth = 0
        self.outer = None
        self._saved_ops, self._saved_fused = {}, {}

    def __enter__(self):
        for name, opdef in self.registry.OPS.items():
            if opdef.lower is not None:
                self._saved_ops[name] = opdef.lower
                opdef.lower = self._wrapped(name, opdef.lower)
        for fam, fn in self.registry.FUSED_LOWERINGS.items():
            self._saved_fused[fam] = fn
            self.registry.FUSED_LOWERINGS[fam] = self._wrapped("fused:" + fam, fn)
        return self

    def _wrapped(self, name, fn):
        def lower(*args):
            if self._depth:
                return self.nested(name, lambda: fn(*args))
            self._depth += 1
            self.outer = name
            try:
                return self.around(name, lambda: fn(*args))
            finally:
                self._depth -= 1

        return lower

    def nested(self, name, call):
        return call()

    def __exit__(self, *exc):
        for name, fn in self._saved_ops.items():
            self.registry.OPS[name].lower = fn
        self.registry.FUSED_LOWERINGS.update(self._saved_fused)
        return False


class _OpTimer(_Lowerings):
    """The host time each op type's lowering takes on the op-by-op path (a
    replayed graph calls no lowering)."""

    def __init__(self, registry):
        super().__init__(registry)
        self.ms = defaultdict(float)
        self.calls = defaultdict(int)

    def around(self, name, call):
        t0 = time.perf_counter()
        out = call()
        self.ms[name] += (time.perf_counter() - t0) * 1e3
        self.calls[name] += 1
        return out


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _walls(step, n_steps):
    walls = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


@contextlib.contextmanager
def op_by_op():
    """The op-by-op path on the card: FLAGS_profile_ops set inside
    profiler.profiler() (its per-op host table goes to a buffer, no event dump)."""
    from .. import flags, profiler

    flags.set_flags({"profile_ops": True})
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            with profiler.profiler(profile_path=None):
                yield
    finally:
        flags.set_flags({"profile_ops": False})


def _windows(run, n_steps, cuda):
    """A bare window of `run()` and one under torch.profiler: the wall time
    and the device time per step."""
    walls = run()
    wall_ms = float(np.median(walls))
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        run()
    kernels = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels[e.name]
            k[0] += e.device_time_total / 1e3  # us -> ms
            k[1] += 1
    device_ms = sum(k[0] for k in kernels.values()) / n_steps
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "steps": n_steps,
        "wall_ms_p50": wall_ms,
        "wall_ms_min": float(np.min(walls)),
        "wall_ms_max": float(np.max(walls)),
        "wall_ms_total": float(np.sum(walls)),
        # device time (kernels and copies) from the profiler window, over
        # the bare window's wall p50
        "device_busy_ms_per_step": device_ms if kernels else None,
        "device_busy_share": (device_ms / wall_ms) if kernels else None,
        "device_launches_per_step": (
            sum(k[1] for k in kernels.values()) / n_steps if kernels else None
        ),
        "device_ms_per_step_by_kernel": {
            name: {"ms": ms / n_steps, "launches": n / n_steps} for name, (ms, n) in by_time
        },
    }


def profile_window(run, n_steps, registry, cuda=True, per_op=False):
    """Windows of `run()`, which runs n_steps steps and returns their host
    walls in ms, so that no instrument inflates what another reads: bare
    and under torch.profiler on the path the calls take (on the card, graph
    replays); with per_op, the same two on the op-by-op path ("op_by_op")
    and, there, one under the op timer (the host time of each op type).
    Returns the breakdown per step."""
    out = _windows(run, n_steps, cuda)
    if per_op:
        with op_by_op():
            eager = _windows(run, n_steps, cuda)
            with _OpTimer(registry) as ops:
                timed_walls = run()
        op_ms = sum(ops.ms.values()) / n_steps
        timed_ms = sum(timed_walls) / n_steps
        eager.update({
            # host time inside op lowerings, from the op-timer window; the
            # rest of that window's wall is the executor's host work around
            # them (feed copies, the per-op syncs, the fetch copy to the
            # host, and in serving the sampling)
            "op_timer_wall_ms_mean": timed_ms,
            "ops_host_ms_per_step": op_ms,
            "outside_ops_ms_per_step": timed_ms - op_ms,
            "op_host_ms_per_step": {
                k: v / n_steps for k, v in sorted(ops.ms.items(), key=lambda kv: -kv[1])
            },
            "op_calls_per_step": {k: v / n_steps for k, v in sorted(ops.calls.items())},
        })
        out["op_by_op"] = eager
    return out


def profile_steps(engine, step, n_steps, registry, per_op=False):
    """profile_window over n_steps calls of `step()`, after 3 warm calls."""
    for _ in range(3):
        step()
    return profile_window(lambda: _walls(step, n_steps), n_steps, registry,
                          cuda=engine.device.type == "cuda", per_op=per_op)


def run(engine, n_steps, registry, seed=SEED, prompt_lens=PROMPT_LENS, per_op=False):
    """Fill every slot, then profile a prefill chunk of the engine's chunk
    size and a decode step over all slots."""
    from ..serving import GenRequest

    rng = np.random.RandomState(seed)
    vocab = engine.model.vocab_size
    prompts = [rng.randint(2, vocab, size=n).tolist() for n in prompt_lens]
    # decode steps a slot takes: 3 warm, n_steps a window (2 windows, 5
    # with per_op), and a margin
    n_new = 3 + (5 if per_op else 2) * n_steps + 8
    runs = [
        engine.start(GenRequest(p, max_new_tokens=n_new, eos_id=-1))
        for p in prompts[:engine.max_slots]
    ]
    try:
        # a fresh prompt (no prefix-cache hit) of four chunks, prefilled
        # over and over; each step() call is one full chunk of
        # prefill_chunk rows
        long_prompt = rng.randint(2, vocab, size=engine.prefill_chunk * 4).tolist()
        out = {"prefill_chunk_rows": engine.prefill_chunk}
        engine.finish(runs.pop())
        pf_run = engine.admit(GenRequest(long_prompt, max_new_tokens=1, eos_id=-1))

        def prefill_step():
            if pf_run.pf_pos + engine.prefill_chunk >= len(long_prompt):
                pf_run.pf_pos = 0  # rewrite the same pages: same shapes, same work
            engine.prefill_step(pf_run)

        try:
            out["prefill"] = profile_steps(engine, prefill_step, n_steps, registry, per_op)
        finally:
            engine.finish(pf_run)
        runs.append(engine.start(GenRequest(prompts[-1], max_new_tokens=n_new,
                                            eos_id=-1)))
        out["decode_slots"] = len(runs)
        out["decode"] = profile_steps(engine, lambda: engine.decode_step(runs),
                                      n_steps, registry, per_op)
    finally:
        for r in runs:
            engine.finish(r)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--kv-dtype", choices=("float32", "int8"), default="float32")
    ap.add_argument("--per-op", action="store_true",
                    help="also profile the op-by-op path (FLAGS_profile_ops under the profiler)")
    ap.add_argument("--out", default="profile_generation.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_generation: no CUDA device", file=sys.stderr)
        return 2
    from .. import CUDAPlace
    from ..models import GPTDecoder
    from ..ops import registry
    from ..serving import GenerationEngine

    card = card_line()
    geometry = INT8_ENGINE if args.kv_dtype == "int8" else ENGINE
    engine = GenerationEngine(GPTDecoder(kv_dtype=args.kv_dtype, **GPT2_SMALL),
                              name="gpt2_small_profile_" + args.kv_dtype,
                              place=CUDAPlace(0), **geometry)
    engine.warmup()
    lens = PROMPT_LENS * (geometry["max_slots"] // len(PROMPT_LENS))
    res = run(engine, args.steps, registry, prompt_lens=lens, per_op=args.per_op)
    res["card"] = card
    res["engine"] = dict(GPT2_SMALL, kv_dtype=args.kv_dtype, **geometry)
    for kind in ("prefill", "decode"):
        r = res[kind]
        print("%s (%s KV, graph): wall p50 %.3f ms; device busy %s ms a step (%s of the wall), "
              "%s launches; card %s" % (
                  kind, args.kv_dtype, r["wall_ms_p50"], r["device_busy_ms_per_step"],
                  r["device_busy_share"], r["device_launches_per_step"], card), flush=True)
        e = r.get("op_by_op")
        if e is not None:
            top_ops = list(e["op_host_ms_per_step"].items())[:5]
            print("%s (%s KV, op by op): wall p50 %.3f ms; under the op timer %.3f ms, of it "
                  "%.3f ms in op lowerings (top %s); device busy %s ms a step (%s of the "
                  "wall), %s launches; card %s" % (
                      kind, args.kv_dtype, e["wall_ms_p50"], e["op_timer_wall_ms_mean"],
                      e["ops_host_ms_per_step"], ", ".join("%s %.3f" % kv for kv in top_ops),
                      e["device_busy_ms_per_step"], e["device_busy_share"],
                      e["device_launches_per_step"], card), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: res[k] for k in ("card", "prefill_chunk_rows", "decode_slots")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
