"""Where a training step's time goes, on one CUDA card.

    python3 -m paddle_tpu_torch.tools.profile_training [--steps 10] \
        [--out profile_training.json]

Builds the training slice's configuration: the Transformer of
models/transformer.py at the widths of Transformer base (Vaswani et al.
2017, Table 3 "base": N=6, d_model=512, d_ff=2048, h=8, d_k=d_v=64,
P_drop=0.1, eps_ls=0.1), separate source and target vocabularies of 37000
(the paper's shared BPE size), max_length 256, f32, under Adam; random
weights from a seed. A batch is 16 sentence pairs of up to 256 tokens, the
lengths from a seed, attention biases from make_attn_bias and label_weight
0 on pad positions. Each step is one `Executor.run` under the
training_fused pass pipeline that fetches the loss.

It measures three steady windows, one per instrument:
- bare: the step's host wall time (the loss fetch is the step's sync, so it
  includes the device work), and the target tokens of all the steps over
  their summed wall time;
- op timer: the host time inside each op type's lowering and each fused
  family's lowering (the executor interprets the block op by op, so this
  is the launch cost of each op on the host);
- torch.profiler: the device time of every kernel and copy, giving the
  device's busy share of the bare wall time and the top kernels.

Prints one summary line and writes the whole breakdown as JSON. Exits
non-zero without a CUDA device.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .profile_generation import card_line, profile_window

BASE = dict(n_layer=6, n_head=8, d_model=512, d_inner=2048, d_key=64, d_value=64,
            vocab=37000, batch=16, t=256, dropout=0.1)
FEED_NAMES = ("src_word", "src_pos", "trg_word", "trg_pos", "src_slf_attn_bias",
              "trg_slf_attn_bias", "trg_src_attn_bias", "lbl_word", "lbl_weight")
LEARNING_RATE = 1e-3
SEED = 0
PIPELINE = "training_fused"


def build(cfg, lr=LEARNING_RATE):
    """(main, startup, loss): one training step of the Transformer under
    Adam, built with the port's layers, backward and optimizer."""
    from .. import framework, layers, optimizer, unique_name
    from ..models import transformer

    t, h = cfg["t"], cfg["n_head"]
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        v = {}
        for name in FEED_NAMES:
            if name.endswith("bias"):
                v[name] = layers.data(name=name, shape=[h, t, t], dtype="float32")
            elif name == "lbl_weight":
                v[name] = layers.data(name=name, shape=[t, 1], dtype="float32")
            else:
                v[name] = layers.data(name=name, shape=[t, 1], dtype="int64")
        loss, _ = transformer.transformer(
            *(v[n] for n in FEED_NAMES),
            src_vocab_size=cfg["vocab"], trg_vocab_size=cfg["vocab"],
            n_layer=cfg["n_layer"], n_head=h, d_model=cfg["d_model"],
            d_inner=cfg["d_inner"], d_key=cfg["d_key"], d_value=cfg["d_value"],
            dropout=cfg["dropout"], max_length=t,
        )
        optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss


def make_batch(cfg, seed):
    """One batch of `batch` sentence pairs, lengths from the seed between
    half and all of t (the first one full length); pad positions are masked
    in the attention biases and weighted 0 in the loss."""
    from ..models import transformer

    rng = np.random.RandomState(seed)
    b, t, h, vocab = cfg["batch"], cfg["t"], cfg["n_head"], cfg["vocab"]
    lens = rng.randint(t // 2, t + 1, size=b)
    lens[0] = t
    pos = np.tile(np.arange(t), (b, 1))[..., None].astype("int64")
    return {
        "src_word": rng.randint(1, vocab, (b, t, 1)).astype("int64"),
        "src_pos": pos,
        "trg_word": rng.randint(1, vocab, (b, t, 1)).astype("int64"),
        "trg_pos": pos.copy(),
        "src_slf_attn_bias": transformer.make_attn_bias(lens, t, h),
        "trg_slf_attn_bias": transformer.make_attn_bias(lens, t, h, causal=True),
        "trg_src_attn_bias": transformer.make_attn_bias(lens, t, h),
        "lbl_word": rng.randint(1, vocab, (b, t, 1)).astype("int64"),
        "lbl_weight": (np.arange(t)[None, :] < lens[:, None]).astype("float32")[..., None],
    }


def target_tokens(batch):
    """Non-pad target tokens of a batch (the tokens the loss counts)."""
    return int(batch["lbl_weight"].sum())


def profile_steps(step, batches, registry):
    """profile_window (tools/profile_generation.py) over one `step(batch)`
    per batch. Returns the breakdown per step."""

    def run():
        walls = []
        for b in batches:
            t0 = time.perf_counter()
            step(b)
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls

    return profile_window(run, len(batches), registry)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="profile_training.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_training: no CUDA device", file=sys.stderr)
        return 2
    from .. import CUDAPlace, Executor, Scope, flags, scope_guard
    from ..ops import registry

    card = card_line()
    main_prog, startup, loss = build(BASE)
    flags.set_flags({"pass_pipeline": PIPELINE})
    place = CUDAPlace(0)
    scope = Scope(seed=SEED, place=place)
    exe = Executor(place)
    batches = [make_batch(BASE, SEED + i) for i in range(args.steps)]

    def step(batch):
        exe.run(main_prog, feed=batch, fetch_list=[loss.name])

    with scope_guard(scope):
        exe.run(startup)
        for b in batches[:2]:
            step(b)  # the first run applies the pipeline and prepares the block
        torch.cuda.synchronize()
        res = profile_steps(step, batches, registry)
    tokens = sum(target_tokens(b) for b in batches)
    res.update(card=card, pipeline=PIPELINE, config=BASE,
               target_tokens_per_step=tokens / len(batches),
               target_tokens_per_s=tokens / (res["wall_ms_total"] / 1e3))
    top_ops = list(res["op_host_ms_per_step"].items())[:6]
    print("train step (%s): wall p50 %.3f ms; %.0f target tokens/s over the %d steps; "
          "under the op timer %.3f ms, of it %.3f ms in op lowerings (top %s); device busy "
          "%.3f ms a step (%.3f of the wall p50), %s launches; card %s" % (
              PIPELINE, res["wall_ms_p50"], res["target_tokens_per_s"], len(batches),
              res["op_timer_wall_ms_mean"], res["ops_host_ms_per_step"],
              ", ".join("%s %.3f" % kv for kv in top_ops), res["device_busy_ms_per_step"],
              res["device_busy_share"], res["device_launches_per_step"], card), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
