"""Where a training step's time goes, on one CUDA card.

    python3 -m paddle_tpu_torch.tools.profile_training [--steps 10] \
        [--model transformer|transformer_fp8|lenet|resnet50] [--per-op] \
        [--out profile_training.json]

With --model transformer (the default), profiles the two Transformer
configurations, one after the other: the
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

With --model transformer_fp8: BASE rewritten to bf16 by Bf16Transpiler
after its startup program (f32 masters) with FLAGS_fp8_matmul set, so its
mul / matmul products take ops/quant_gemm.py fp8_matmul (the fp8 leg of
chip_smoke.py's train-bf16 phase); with --per-op its op-by-op device time
is also split by op type and, within the products and their generic
grads, by kernel (fp8_step_split): the forward kernel, the grads' replayed
forward products, their gradient products and the e4m3 rounding chains.

With --model lenet: the fluid book script's LeNet-5 (models/lenet.py)
under Adam 1e-3 and training_fused, fed batches of 64 from
batch(reader.shuffle(dataset.mnist.train(), 500), 64) through a
DataFeeder. With --model resnet50: ResNet-50 at its published widths (He et
al. 2016, Table 1, the 50-layer column: bottlenecks [3, 4, 6, 3], filters
64-512 (x4), 3 x 224 x 224 inputs, 1000 classes; models/resnet.py) under
Momentum(0.1, 0.9) in f32, the JAX package's headline bench (bench.py:23-37,
63-72), on synthetic feeds from a seed staged on the card and cycled. For
both, with --per-op, the op-by-op path's device time is also split by op
type (each lowering in a torch.profiler range, its kernels summed under
it), and the convolution grads by their kernels (dgrad, wgrad).

Prints one summary line per configuration and path and writes the
breakdowns as JSON, under the configurations' names. Exits non-zero
without a CUDA device.
"""

import argparse
import bisect
import itertools
import re
import json
import os
import random
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from .profile_generation import _Lowerings, card_line, op_by_op, profile_window

BASE = dict(n_layer=6, n_head=8, d_model=512, d_inner=2048, d_key=64, d_value=64,
            vocab=37000, batch=16, t=256, dropout=0.1)
BASE_FLASH = dict(BASE, use_flash=True, padded=False)
CONFIGS = {"base": BASE, "base_flash": BASE_FLASH}
FEED_NAMES = ("src_word", "src_pos", "trg_word", "trg_pos", "src_slf_attn_bias",
              "trg_slf_attn_bias", "trg_src_attn_bias", "lbl_word", "lbl_weight")
LEARNING_RATE = 1e-3
SEED = 0
PIPELINE = "training_fused"
# the book script's LeNet-5 (tests/test_mnist.py) and the JAX package's
# ResNet-50 bench (bench.py:23-39): batch 256, Momentum(0.1, 0.9), f32
LENET = dict(batch=64, lr=1e-3, shuffle=500)
RESNET50 = dict(batch=256, lr=0.1, momentum=0.9, staged=4)


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


def tp_rules(program, layout=None):
    """The Megatron layout of a Transformer program as sharding rules
    (parallel.SpecLayout's column / row roles, by weight name): the Q / K /
    V projections (a product whose output is reshaped into heads) and the
    FFN's first product (its output goes through the bias and the
    activation) column parallel; the attention output projection (a product
    of the heads put back together) and the FFN's second product row
    parallel. Found by walking the program's forward ops, so it takes
    either package's program and any depth."""
    from ..parallel.sharding_rules import SpecLayout

    layout = layout or SpecLayout()
    ops = program.global_block().ops
    producer, consumers = {}, {}
    for op in ops:
        for n in op.output_arg_names:
            producer.setdefault(n, op)
        for n in op.input_arg_names:
            consumers.setdefault(n, []).append(op)

    def after(name, skip=("dropout",)):
        """The forward consumers of `name`, through dropout."""
        out = []
        for op in consumers.get(name, ()):
            if op.type.endswith("_grad"):
                continue
            if op.type in skip:
                out.extend(after(op.output("Out")[0], skip))
            else:
                out.append(op)
        return out

    def before(name):
        op = producer.get(name)
        while op is not None and op.type == "dropout":
            op = producer.get(op.input("X")[0])
        return op

    column, row = [], []
    for op in ops:
        if op.type != "mul" or op.type.endswith("_grad"):
            continue
        w = op.input("Y")[0]
        nxt = after(op.output("Out")[0])
        src = before(op.input("X")[0])
        if any(o.type in ("reshape2", "reshape") and len(o.attrs["shape"]) == 4 for o in nxt):
            column.append(w)  # split into heads
        elif src is not None and src.type in ("reshape2", "reshape"):
            row.append(w)
        elif len(nxt) == 1 and nxt[0].type == "elementwise_add":
            acts = after(nxt[0].output("Out")[0])
            if len(acts) == 1 and acts[0].type in ("relu", "gelu"):
                downs = [o for o in after(acts[0].output("Out")[0]) if o.type == "mul"]
                if len(downs) == 1:
                    column.append(w)
                    row.append(downs[0].input("Y")[0])
    esc = lambda n: "^%s$" % re.escape(n)  # noqa: E731
    return layout.transformer_rules(column=[esc(n) for n in column],
                                    row=[esc(n) for n in row])


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


def build_lenet(lr=LENET["lr"]):
    """The book script: LeNet-5 of models/lenet.py through the fluid
    surface, its for_test clone taken before Adam minimizes the loss.
    Returns a dict of the programs and the variables a script touches."""
    from .. import fluid
    from ..models import lenet5

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 28, 28], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc, logits = lenet5(img, label)
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return dict(main=main, startup=startup, test=test, img=img, label=label, loss=loss,
                acc=acc, logits=logits)


def mnist_reader(batch_size=LENET["batch"], seed=SEED, test=False):
    """batch(reader.shuffle(dataset.mnist.train(), 500), batch_size), each
    784-float image reshaped to the model's [1, 28, 28], shuffled from
    `seed` (test: the test stream, unshuffled)."""
    from .. import fluid

    stream = fluid.dataset.mnist.test() if test else fluid.dataset.mnist.train()
    samples = fluid.reader.map_readers(lambda s: (s[0].reshape(1, 28, 28), s[1]), stream)
    if test:
        return fluid.batch(samples, batch_size)
    shuffled = fluid.reader.shuffle(samples, LENET["shuffle"])

    def reader():
        random.seed(seed)
        return shuffled()

    return fluid.batch(reader, batch_size)


def lenet_feeds(model, n, place, batch_size=LENET["batch"], seed=SEED):
    """The first n feed dicts of mnist_reader through a DataFeeder."""
    from .. import fluid

    feeder = fluid.DataFeeder([model["img"], model["label"]], place=place,
                              program=model["main"])
    return [feeder.feed(b) for b in itertools.islice(mnist_reader(batch_size, seed)(), n)]


def build_resnet50(lr=RESNET50["lr"], momentum=RESNET50["momentum"]):
    """ResNet-50 (models/resnet.py) under Momentum, as bench.py builds it."""
    from .. import fluid
    from ..models import resnet50

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 224, 224], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc, logits = resnet50(img, label)
        fluid.optimizer.Momentum(learning_rate=lr, momentum=momentum).minimize(loss)
    return dict(main=main, startup=startup, img=img, label=label, loss=loss, acc=acc,
                logits=logits)


def resnet50_feeds(device, batch=RESNET50["batch"], n=RESNET50["staged"], seed=SEED):
    """n synthetic batches from the seed (normal images, uniform labels),
    staged on the device once and cycled, as bench.py stages its batches:
    a step reads them there with no host copy."""
    rng = np.random.RandomState(seed)
    return [{"img": torch.from_numpy(rng.randn(batch, 3, 224, 224).astype("float32")).to(device),
             "label": torch.from_numpy(rng.randint(0, 1000, (batch, 1)).astype("int64")).to(device)}
            for _ in range(n)]


class _OpRanges(_Lowerings):
    """Every lowering in a torch.profiler range named "op::<type>"."""

    def around(self, name, call):
        with torch.profiler.record_function("op::" + name):
            return call()


# the busy split's categories: op types whose device time each sums
SPLIT = (
    ("conv_forward", ("conv2d", "depthwise_conv2d")),
    ("conv_backward", ("conv2d_grad", "depthwise_conv2d_grad")),
    ("batch_norm_forward", ("batch_norm",)),
    ("batch_norm_backward", ("batch_norm_grad",)),
    ("pooling", ("pool2d", "pool2d_grad")),
    ("optimizer", ("momentum", "adam", "fused:multi_adam", "scale")),
    ("fc", ("mul", "mul_grad", "fused:gemm_epilogue")),
    ("elementwise", ("relu", "relu_grad", "elementwise_add", "elementwise_add_grad", "sum",
                     "fill_constant")),
)


def op_device_split(step, batches, registry, split_by=SPLIT, ranges=_OpRanges):
    """Device ms a step by op type on the op-by-op path (one step per batch,
    every lowering in its profiler range, a device sync after each op),
    the categories of `split_by` (SPLIT: the convolution grads also split by their
    kernels' names into dgrad and wgrad) and the top kernels of each
    category. A kernel belongs to the last op whose range began before it
    started: the sync after each op keeps one op's kernels from running
    into the next op's range, and a generic grad's backward kernels,
    launched from the autograd engine's own thread, are found by time where
    the range's own thread does not show them. `ranges` puts the
    lowerings in their ranges (_OpRanges or a subclass)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with op_by_op(), ranges(registry):
        with torch.profiler.profile(activities=acts) as prof:
            for b in batches:
                step(b)
    n = len(batches)
    events = prof.events()
    ranges = sorted((e.time_range.start, e.name[len("op::"):]) for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU
                    and e.name.startswith("op::"))
    starts = [r[0] for r in ranges]
    by_op = defaultdict(float)
    kernels = defaultdict(lambda: defaultdict(float))
    for e in events:
        # the device timeline also carries each range as an annotation of
        # its own: only kernels and copies count
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name.startswith("op::"):
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        op = ranges[i][1] if i >= 0 else "(before the first op)"
        ms = (e.time_range.end - e.time_range.start) / 1e3 / n
        by_op[op] += ms
        kernels[op][e.name] += ms
    split, top = {}, {}
    for cat, ops in split_by:
        split[cat] = sum(by_op.get(o, 0.0) for o in ops)
        ks = defaultdict(float)
        for o in ops:
            for name, ms in kernels[o].items():
                ks[name] += ms
        top[cat] = dict(sorted(ks.items(), key=lambda kv: -kv[1])[:4])
    known = {o for _, ops in split_by for o in ops}
    split["other"] = sum(v for o, v in by_op.items() if o not in known)
    conv_bwd = defaultdict(float)
    for o in ("conv2d_grad", "depthwise_conv2d_grad"):
        for name, ms in kernels[o].items():
            low = name.lower()
            conv_bwd["dgrad" if "dgrad" in low else "wgrad" if "wgrad" in low else
                     "other kernels"] += ms
    return {
        "device_ms_per_step": sum(by_op.values()),
        "by_category": split,
        "conv_backward_by_kernel_name": dict(conv_bwd),
        "by_op": dict(sorted(by_op.items(), key=lambda kv: -kv[1])),
        "kernels_by_op": {o: dict(ks) for o, ks in kernels.items()},
        "top_kernels_by_category": top,
    }


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


# the products FLAGS_fp8_matmul takes, and the kernels of their forward
# (fp8_gemm.cu's forward form; before it, quant_gemm.cu's e4m3 GEMM and its
# cast pass) and gradient forms by name
FP8_OPS = ("mul", "matmul")
FP8_FORWARD_KERNELS = ("fp8_gemm_kernel<0", "quant_gemm_kernel", "e4m3_cast_pad_kernel")
FP8_GRAD_KERNELS = ("fp8_gemm_kernel<1", "fp8_gemm_kernel<2")


def _fp8_kernel_kind(name):
    if any(k in name for k in FP8_FORWARD_KERNELS):
        return "forward"
    if any(k in name for k in FP8_GRAD_KERNELS) or "gemm" in name.lower():
        return "products"
    return "rounding"


def fp8_step_split(split):
    """Device ms a step of an fp8 step's products (op_device_split's
    kernels_by_op): in the forward ops, the fp8 forward kernel and the
    rest; in their generic grads, the replayed forward's kernels, the
    gradient products (the fp8 grad forms or library GEMMs) and the rest
    (the e4m3 rounding chains and the reductions around them); every other
    op's time as one figure."""
    out = defaultdict(float)
    for op, ks in split["kernels_by_op"].items():
        grad = op.endswith("_grad") and op[:-len("_grad")] in FP8_OPS
        if op not in FP8_OPS and not grad:
            out["other ops"] += sum(ks.values())
            continue
        for name, ms in ks.items():
            kind = _fp8_kernel_kind(name)
            if not grad:
                out["forward: fp8 kernel" if kind == "forward" else "forward: other"] += ms
            else:
                out["grad: " + {"forward": "replayed forward", "products": "products",
                                "rounding": "rounding and other"}[kind]] += ms
    return dict(out)


def profile_config(name, cfg, steps, card, per_op=False, fp8=False):
    """The breakdown of `steps` steady training steps of one configuration
    (after two that apply the pipeline, prepare the block and capture it);
    with fp8, the configuration in bf16 with FLAGS_fp8_matmul."""
    from .. import CUDAPlace, Executor, Scope, flags, scope_guard
    from ..ops import registry
    from .profile_recsys import bf16_transpiled

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
        if fp8:
            bf16_transpiled(main_prog)
            flags.set_flags({"fp8_matmul": True})
        try:
            for b in batches[:2]:
                step(b)  # the op-by-op warmup (which applies the pipeline), then the capture
            torch.cuda.synchronize()
            res = profile_steps(step, batches, registry, per_op)
            if per_op and fp8:
                exe.close()
                torch.cuda.empty_cache()
                res["op_by_op"]["split"] = split = op_device_split(step, batches[:2], registry)
                res["op_by_op"]["fp8_split"] = fp8_step_split(split)
        finally:
            flags.set_flags({"fp8_matmul": False})
    tokens = sum(target_tokens(b) for b in batches)
    res.update(card=card, pipeline=PIPELINE, config=cfg, fp8_matmul=fp8,
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
        if "fp8_split" in e:
            print("train step %s (op by op): device %.3f ms a step; the fp8 products' split %s; "
                  "card %s" % (name, e["split"]["device_ms_per_step"],
                               json.dumps({k: round(v, 3) for k, v in e["fp8_split"].items()}),
                               card), flush=True)
    return res


def profile_cnn(name, steps, card, per_op=False):
    """The breakdown of `steps` steady graph steps of LeNet-5 or ResNet-50
    under training_fused (after the op-by-op warmup and the capture), in
    images/s; with per_op, the op-by-op path's windows and its device time
    split by op type (op_device_split)."""
    from .. import CUDAPlace, Executor, Scope, flags, scope_guard
    from ..ops import registry

    place = CUDAPlace(0)
    if name == "lenet":
        batch = LENET["batch"]
        model = build_lenet()
        batches = lenet_feeds(model, steps + 2, place)
    else:
        batch = RESNET50["batch"]
        model = build_resnet50()
        batches = resnet50_feeds(torch.device("cuda", 0))
    flags.set_flags({"pass_pipeline": PIPELINE})
    scope, exe = Scope(seed=SEED, place=place), Executor(place)

    def step(b):
        exe.run(model["main"], feed=b, fetch_list=[model["loss"].name])

    window = [batches[i % len(batches)] for i in range(2, steps + 2)]
    with scope_guard(scope):
        exe.run(model["startup"])
        for b in batches[:2]:
            step(b)  # the op-by-op warmup (which applies the pipeline), then the capture
        torch.cuda.synchronize()
        res = profile_steps(step, window, registry)
        if per_op:
            # the graph and its pool go first: ResNet-50's step does not fit
            # twice on the card
            exe.close()
            torch.cuda.empty_cache()
            with op_by_op():
                res["op_by_op"] = profile_steps(step, window, registry)
            res["op_by_op"]["split"] = op_device_split(step, window[:2], registry)
    res.update(card=card, pipeline=PIPELINE, batch=batch,
               images_per_s=batch * len(window) / (res["wall_ms_total"] / 1e3),
               memory_max_reserved_gib=torch.cuda.max_memory_reserved() / float(1 << 30))
    print("train step %s (%s, graph): wall p50 %.3f ms; %.1f images/s over the %d steps; device "
          "busy %.3f ms a step (%.3f of the wall p50), %s launches; max reserved %.3f GiB; card "
          "%s" % (name, PIPELINE, res["wall_ms_p50"], res["images_per_s"], len(window),
                  res["device_busy_ms_per_step"], res["device_busy_share"],
                  res["device_launches_per_step"], res["memory_max_reserved_gib"], card),
          flush=True)
    if per_op:
        split = res["op_by_op"]["split"]
        print("train step %s (op by op): device %.3f ms a step by op type, split %s; conv grads "
              "by kernel name %s; card %s" % (
                  name, split["device_ms_per_step"],
                  json.dumps({k: round(v, 3) for k, v in split["by_category"].items()}),
                  json.dumps({k: round(v, 3) for k, v in
                              split["conv_backward_by_kernel_name"].items()}), card),
              flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--model", choices=("transformer", "transformer_fp8", "lenet", "resnet50"),
                    default="transformer")
    ap.add_argument("--per-op", action="store_true",
                    help="also profile the op-by-op path (FLAGS_profile_ops under the profiler)")
    ap.add_argument("--cudnn-nondeterministic", action="store_true",
                    help="let cuDNN take non-deterministic algorithms (to time what the "
                         "deterministic ones cost)")
    ap.add_argument("--out", default="profile_training.json")
    args = ap.parse_args(argv)
    if args.cudnn_nondeterministic:
        from ..ops import registry

        registry.CUDNN_DETERMINISTIC = False
    if not torch.cuda.is_available():
        print("profile_training: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    res = {}
    if args.model == "transformer":
        for name, cfg in CONFIGS.items():
            res[name] = profile_config(name, cfg, args.steps, card, args.per_op)
            torch.cuda.empty_cache()
    elif args.model == "transformer_fp8":
        res["base_fp8"] = profile_config("base_fp8", BASE, args.steps, card, args.per_op, fp8=True)
    else:
        res[args.model] = profile_cnn(args.model, args.steps, card, args.per_op)
        res[args.model]["cudnn_deterministic"] = not args.cudnn_nondeterministic
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
