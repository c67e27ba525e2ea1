"""Where a training step's time goes, on one CUDA card.

    python3 -m paddle_tpu_torch.tools.profile_training [--steps 10] \
        [--per-op] [--out profile_training.json]

Profiles the two training configurations, one after the other: the
Transformer of models/transformer.py at the widths of Transformer base
(Vaswani et al. 2017, Table 3 "base": N=6, d_model=512, d_ff=2048, h=8,
d_k=d_v=64, P_drop=0.1, eps_ls=0.1), separate source and target
vocabularies of 37000 (the paper's shared BPE size), max_length 256, f32,
under Adam; random weights from a seed.
- BASE (`use_flash=False`): a batch is 16 sentence pairs of up to 256
  tokens, the lengths from a seed, attention biases from make_attn_bias and
  label_weight 0 on pad positions;
- BASE_FLASH (`use_flash=True, padded=False`, the JAX package's flash
  recipe, bench.py): every attention block is one flash_attention op; a
  batch is 16 pairs of exactly 256 tokens, with no attention-bias feeds
  (attention-weight dropout is absent on the flash path by the model's
  design).
Each step is one `Executor.run` under the training_fused pass pipeline that
fetches the loss: after two warm steps (the op-by-op warmup, then the
capture) a replayed CUDA graph.

It measures steady windows per configuration, one per instrument
(tools/profile_generation.py profile_window): bare (the step's host wall,
which includes the device work since the loss fetch is the step's sync,
and the target tokens of all the steps over their summed wall) and under
torch.profiler (the device time of every kernel and copy: the device's
busy share of the bare wall, the launches and the top kernels). With
--per-op, the same two and one under the op timer (the host time inside
each op type's lowering and each fused family's lowering) on the op-by-op
path: FLAGS_profile_ops inside profiler.profiler().

Prints one summary line per configuration and path and writes both
breakdowns as JSON, under the configurations' names. Exits non-zero
without a CUDA device.
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
BASE_FLASH = dict(BASE, use_flash=True, padded=False)
CONFIGS = {"base": BASE, "base_flash": BASE_FLASH}
FEED_NAMES = ("src_word", "src_pos", "trg_word", "trg_pos", "src_slf_attn_bias",
              "trg_slf_attn_bias", "trg_src_attn_bias", "lbl_word", "lbl_weight")
LEARNING_RATE = 1e-3
SEED = 0
PIPELINE = "training_fused"


def build(cfg, lr=LEARNING_RATE):
    """(main, startup, loss): one training step of the Transformer under
    Adam, built with the port's layers, backward and optimizer. Under
    use_flash there are no bias data vars: the model gets None."""
    from .. import framework, layers, optimizer, unique_name
    from ..models import transformer

    t, h = cfg["t"], cfg["n_head"]
    flash = cfg.get("use_flash", False)
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        v = {}
        for name in FEED_NAMES:
            if name.endswith("bias"):
                v[name] = None if flash else layers.data(
                    name=name, shape=[h, t, t], dtype="float32")
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
            use_flash=flash, padded=cfg.get("padded"),
        )
        optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss


def make_batch(cfg, seed):
    """One batch of `batch` sentence pairs, lengths from the seed between
    half and all of t (the first one full length); pad positions are masked
    in the attention biases and weighted 0 in the loss. Under use_flash
    (unpadded batches) every pair is t tokens long and there are no bias
    arrays."""
    from ..models import transformer

    rng = np.random.RandomState(seed)
    b, t, h, vocab = cfg["batch"], cfg["t"], cfg["n_head"], cfg["vocab"]
    flash = cfg.get("use_flash", False)
    lens = np.full(b, t) if flash else rng.randint(t // 2, t + 1, size=b)
    lens[0] = t
    pos = np.tile(np.arange(t), (b, 1))[..., None].astype("int64")
    batch = {
        "src_word": rng.randint(1, vocab, (b, t, 1)).astype("int64"),
        "src_pos": pos,
        "trg_word": rng.randint(1, vocab, (b, t, 1)).astype("int64"),
        "trg_pos": pos.copy(),
        "lbl_word": rng.randint(1, vocab, (b, t, 1)).astype("int64"),
        "lbl_weight": (np.arange(t)[None, :] < lens[:, None]).astype("float32")[..., None],
    }
    if not flash:
        batch["src_slf_attn_bias"] = transformer.make_attn_bias(lens, t, h)
        batch["trg_slf_attn_bias"] = transformer.make_attn_bias(lens, t, h, causal=True)
        batch["trg_src_attn_bias"] = transformer.make_attn_bias(lens, t, h)
    return batch


def target_tokens(batch):
    """Non-pad target tokens of a batch (the tokens the loss counts)."""
    return int(batch["lbl_weight"].sum())


def profile_steps(step, batches, registry, per_op=False):
    """profile_window (tools/profile_generation.py) over one `step(batch)`
    per batch. Returns the breakdown per step."""

    def run():
        walls = []
        for b in batches:
            t0 = time.perf_counter()
            step(b)
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls

    return profile_window(run, len(batches), registry, per_op=per_op)


def _tokens_per_s(res, tokens):
    return tokens / (res["wall_ms_total"] / 1e3)


def profile_config(name, cfg, steps, card, per_op=False):
    """The breakdown of `steps` steady training steps of one configuration
    (after two that apply the pipeline, prepare the block and capture it)."""
    from .. import CUDAPlace, Executor, Scope, flags, scope_guard
    from ..ops import registry

    main_prog, startup, loss = build(cfg)
    flags.set_flags({"pass_pipeline": PIPELINE})
    place = CUDAPlace(0)
    scope = Scope(seed=SEED, place=place)
    exe = Executor(place)
    batches = [make_batch(cfg, SEED + i) for i in range(steps)]

    def step(batch):
        exe.run(main_prog, feed=batch, fetch_list=[loss.name])

    with scope_guard(scope):
        exe.run(startup)
        for b in batches[:2]:
            step(b)  # the op-by-op warmup (which applies the pipeline), then the capture
        torch.cuda.synchronize()
        res = profile_steps(step, batches, registry, per_op)
    tokens = sum(target_tokens(b) for b in batches)
    res.update(card=card, pipeline=PIPELINE, config=cfg,
               target_tokens_per_step=tokens / len(batches),
               target_tokens_per_s=_tokens_per_s(res, tokens))
    print("train step %s (%s, graph): wall p50 %.3f ms; %.0f target tokens/s over the %d "
          "steps; device busy %.3f ms a step (%.3f of the wall p50), %s launches; card %s" % (
              name, PIPELINE, res["wall_ms_p50"], res["target_tokens_per_s"], len(batches),
              res["device_busy_ms_per_step"], res["device_busy_share"],
              res["device_launches_per_step"], card), flush=True)
    e = res.get("op_by_op")
    if e is not None:
        e["target_tokens_per_s"] = _tokens_per_s(e, tokens)
        top_ops = list(e["op_host_ms_per_step"].items())[:6]
        print("train step %s (%s, op by op): wall p50 %.3f ms; %.0f target tokens/s; under the "
              "op timer %.3f ms, of it %.3f ms in op lowerings (top %s); device busy %.3f ms a "
              "step (%.3f of the wall p50), %s launches; card %s" % (
                  name, PIPELINE, e["wall_ms_p50"], e["target_tokens_per_s"],
                  e["op_timer_wall_ms_mean"], e["ops_host_ms_per_step"],
                  ", ".join("%s %.3f" % kv for kv in top_ops), e["device_busy_ms_per_step"],
                  e["device_busy_share"], e["device_launches_per_step"], card), flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--per-op", action="store_true",
                    help="also profile the op-by-op path (FLAGS_profile_ops under the profiler)")
    ap.add_argument("--out", default="profile_training.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_training: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    res = {}
    for name, cfg in CONFIGS.items():
        res[name] = profile_config(name, cfg, args.steps, card, args.per_op)
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
