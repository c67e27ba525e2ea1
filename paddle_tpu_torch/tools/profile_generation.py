"""Where a generation step's time goes, on one CUDA card.

    python3 -m paddle_tpu_torch.tools.profile_generation [--steps 20] \
        [--out profile_generation.json]

Builds the GenerationEngine at chip_smoke.py's geometry (GPTDecoder at GPT-2
small's widths, random weights from a seed, 8 slots, page_size 16, 1024
positions), fills all 8 slots with prompts of 40-700 tokens, and then, for
the two step kinds of the main path (a 32-row prefill chunk and an 8-slot
decode step), measures three steady windows, one per instrument:

- bare: the step's host wall time (each step ends in the logits copy to
  the host, so it includes the device work);
- op timer: the host time spent inside each op type's lowering, by timing
  every lowering call (the executor interprets a block op by op, so this is
  the launch cost of each op on the host);
- torch.profiler: the device time of every kernel and copy, giving the
  device's busy share of the bare wall time and the top kernels.

Prints one summary line per step kind and writes the whole breakdown as JSON.
Exits non-zero without a CUDA device.
"""

import argparse
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
PROMPT_LENS = (40, 131, 217, 305, 388, 472, 569, 700)
SEED = 0


class _OpTimer:
    """Wraps every registered lowering, and every fused family's lowering,
    with a host clock; the totals are the host time each op type takes. A
    lowering called from inside another (a generic grad replays its forward
    op's lowering under torch.func.vjp) counts toward the outer op only."""

    def __init__(self, registry):
        self.registry = registry
        self.ms = defaultdict(float)
        self.calls = defaultdict(int)
        self._depth = 0
        self._saved_ops, self._saved_fused = {}, {}

    def __enter__(self):
        for name, opdef in self.registry.OPS.items():
            if opdef.lower is not None:
                self._saved_ops[name] = opdef.lower
                opdef.lower = self._timed(name, opdef.lower)
        for fam, fn in self.registry.FUSED_LOWERINGS.items():
            self._saved_fused[fam] = fn
            self.registry.FUSED_LOWERINGS[fam] = self._timed("fused:" + fam, fn)
        return self

    def _timed(self, name, fn):
        def lower(*args):
            if self._depth:
                return fn(*args)
            self._depth += 1
            t0 = time.perf_counter()
            try:
                out = fn(*args)
            finally:
                self._depth -= 1
            self.ms[name] += (time.perf_counter() - t0) * 1e3
            self.calls[name] += 1
            return out

        return lower

    def __exit__(self, *exc):
        for name, fn in self._saved_ops.items():
            self.registry.OPS[name].lower = fn
        self.registry.FUSED_LOWERINGS.update(self._saved_fused)
        return False


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


def profile_window(run, n_steps, registry, cuda=True):
    """Three windows of `run()`, which runs n_steps steps and returns their
    host walls in ms: bare (the wall time), under the op timer (the host
    time of each op type) and under torch.profiler (the device time), so
    that neither instrument inflates what the other reads. Returns the
    breakdown per step."""
    walls = run()
    wall_ms = float(np.median(walls))
    with _OpTimer(registry) as ops:
        timed_walls = run()
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
    op_ms = sum(ops.ms.values()) / n_steps
    timed_ms = sum(timed_walls) / n_steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "steps": n_steps,
        "wall_ms_p50": wall_ms,
        "wall_ms_min": float(np.min(walls)),
        "wall_ms_max": float(np.max(walls)),
        "wall_ms_total": float(np.sum(walls)),
        # host time inside op lowerings, from the op-timer window; the rest
        # of that window's wall is the executor's host work around them
        # (feed copies, the fetch copy to the host that is the step's sync,
        # and in serving the sampling)
        "op_timer_wall_ms_mean": timed_ms,
        "ops_host_ms_per_step": op_ms,
        "outside_ops_ms_per_step": timed_ms - op_ms,
        "op_host_ms_per_step": {
            k: v / n_steps for k, v in sorted(ops.ms.items(), key=lambda kv: -kv[1])
        },
        "op_calls_per_step": {k: v / n_steps for k, v in sorted(ops.calls.items())},
        # device time (kernels and copies) from the profiler window, over
        # the bare window's wall p50
        "device_busy_ms_per_step": device_ms if kernels else None,
        "device_busy_share": (device_ms / wall_ms) if kernels else None,
        "device_launches_per_step": (
            sum(k[1] for k in kernels.values()) / n_steps if kernels else None
        ),
        "top_device_ms_per_step": {
            name: {"ms": ms / n_steps, "launches": n / n_steps} for name, (ms, n) in top
        },
    }


def profile_steps(engine, step, n_steps, registry):
    """profile_window over n_steps calls of `step()`, after 3 warm calls."""
    for _ in range(3):
        step()
    return profile_window(lambda: _walls(step, n_steps), n_steps, registry,
                          cuda=engine.device.type == "cuda")


def run(engine, n_steps, registry, seed=SEED, prompt_lens=PROMPT_LENS):
    """Fill every slot, then profile a prefill chunk of the engine's chunk
    size and a decode step over all slots."""
    from ..serving import GenRequest

    rng = np.random.RandomState(seed)
    vocab = engine.model.vocab_size
    prompts = [rng.randint(2, vocab, size=n).tolist() for n in prompt_lens]
    runs = [
        engine.start(GenRequest(p, max_new_tokens=3 * n_steps + 8, eos_id=-1))
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
            out["prefill"] = profile_steps(engine, prefill_step, n_steps, registry)
        finally:
            engine.finish(pf_run)
        runs.append(engine.start(GenRequest(prompts[-1], max_new_tokens=3 * n_steps + 8,
                                            eos_id=-1)))
        out["decode_slots"] = len(runs)
        out["decode"] = profile_steps(engine, lambda: engine.decode_step(runs),
                                      n_steps, registry)
    finally:
        for r in runs:
            engine.finish(r)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
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
    engine = GenerationEngine(GPTDecoder(**GPT2_SMALL), name="gpt2_small_profile",
                              place=CUDAPlace(0), **ENGINE)
    engine.warmup()
    res = run(engine, args.steps, registry)
    res["card"] = card
    res["engine"] = dict(GPT2_SMALL, **ENGINE)
    for kind in ("prefill", "decode"):
        r = res[kind]
        top_ops = list(r["op_host_ms_per_step"].items())[:5]
        print("%s: wall p50 %.3f ms; under the op timer %.3f ms, of it %.3f ms in op "
              "lowerings (top %s); device busy %s ms a step (%s of the wall), %s "
              "launches; card %s" % (
                  kind, r["wall_ms_p50"], r["op_timer_wall_ms_mean"],
                  r["ops_host_ms_per_step"],
                  ", ".join("%s %.3f" % kv for kv in top_ops),
                  r["device_busy_ms_per_step"], r["device_busy_share"],
                  r["device_launches_per_step"], card), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: res[k] for k in ("card", "prefill_chunk_rows", "decode_slots")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
