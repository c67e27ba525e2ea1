"""The CNN deployment path of the reference's users (fluid 1.2), as
chip_smoke.py's `deploy resnet50` phase and the card's deployment tests
drive it: train ResNet-50 with simulated quantization, then serve it five
ways.

- Training: ResNet-50 (models/resnet.py, 3 x 224 x 224, 1000 classes) under
  Momentum(0.1, 0.9), rewritten by the `quantize_training` pass
  (QuantizeTranspiler's fake quantize / dequantize pairs around every conv
  and the fc), beside the same program left in f32.
- Inference legs, every one from the quantization-trained parameters (the
  f32 program's parameters have the same names), each in a scope of its
  own, since the rewrites write the scope:
  (a) the f32 program's clone(for_test=True);
  (b) (a) after InferenceTranspiler().transpile (batch_norm folded into
      the convolutions);
  (c) (b) after memory_optimize (the same scope as (b));
  (d) the quantization-trained program's test clone after freeze_program
      (weights as f32 levels);
  (e) (d) after convert_to_int8 (int8 weights, quantize_abs_max,
      int8_conv2d on the quant GEMM kernel, int8_mul).

`RESNET50` is the published configuration (QuantizeTranspiler's
deployment guidance names ResNet-50 inference at batch 128,
paddle_tpu/transpiler/quantize_transpiler.py:180-186; training at batch 64
is the reference's QAT test's ResNet-50 run at a card's batch); `SMALL`
(resnet_cifar10, depth 8, 3 x 32 x 32, 10 classes) is the tests' size.
The batches are synthetic (normal images, uniform labels) from a seed,
staged on the device once.
"""

import numpy as np
import torch

SEED = 0
RESNET50 = dict(model="resnet50", side=224, classes=1000, train_batch=64, infer_batch=128,
                lr=0.1, momentum=0.9)
SMALL = dict(model="resnet_cifar10", depth=8, side=32, classes=10, train_batch=4,
             infer_batch=4, lr=0.1, momentum=0.9)
LEGS = ("a", "b", "c", "d", "e")
LEG_NAMES = {"a": "f32 test clone", "b": "(a) + InferenceTranspiler (fold_batch_norm)",
             "c": "(b) + memory_optimize", "d": "QAT test clone + freeze_program",
             "e": "(d) + convert_to_int8"}

# the busy split's categories of an inference leg (op types whose device
# time each sums; profile_training.op_device_split)
SPLIT = (
    ("conv", ("conv2d", "depthwise_conv2d")),
    ("int8_conv", ("int8_conv2d",)),
    ("batch_norm", ("batch_norm",)),
    ("quantize", ("quantize_abs_max", "fake_quantize_abs_max")),
    ("dequantize", ("fake_dequantize_max_abs",)),
    ("elementwise", ("elementwise_add", "relu")),
    ("pooling", ("pool2d",)),
    ("fc", ("mul", "int8_mul")),
)


def build(cfg, qat):
    """{main, startup, img, label, loss, acc, logits} of cfg's model under
    its Momentum; with `qat` the main program rewritten by the
    quantize_training pass."""
    from .. import fluid, models, passes

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, cfg["side"], cfg["side"]],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        if cfg["model"] == "resnet50":
            loss, acc, logits = models.resnet50(img, label, class_num=cfg["classes"])
        else:
            loss, acc, logits = models.resnet_cifar10(img, label, depth=cfg["depth"],
                                                      class_num=cfg["classes"])
        fluid.optimizer.Momentum(learning_rate=cfg["lr"], momentum=cfg["momentum"]).minimize(
            loss)
    if qat:
        passes.apply_inplace(main, ["quantize_training"])
    return dict(main=main, startup=startup, img=img, label=label, loss=loss, acc=acc,
                logits=logits)


def feeds(cfg, device, batch, n=2, seed=SEED):
    """n synthetic batches from the seed, staged on `device` once."""
    rng = np.random.RandomState(seed)
    side, classes = cfg["side"], cfg["classes"]
    return [{"img": torch.from_numpy(rng.randn(batch, 3, side, side).astype("float32")).to(device),
             "label": torch.from_numpy(rng.randint(0, classes, (batch, 1)).astype("int64"))
             .to(device)} for _ in range(n)]


def _scope_with(state, place, seed=SEED):
    from ..executor import Scope

    scope = Scope(seed=seed, place=place)
    for name, value in state.items():
        scope.set_var(name, value.clone())
    return scope


def inference_legs(plain, qat, state, place, legs=LEGS):
    """{leg: (program, scope)} of the legs named in `legs` (see the module
    docstring), each program rewritten from the trained `state` ({name:
    tensor}, copied into each leg's scope)."""
    from ..transpiler import InferenceTranspiler, QuantizeTranspiler, memory_optimize

    out = {}
    if "a" in legs:
        out["a"] = (plain["main"].clone(for_test=True), _scope_with(state, place))
    if "b" in legs or "c" in legs:
        prog, scope = plain["main"].clone(for_test=True), _scope_with(state, place)
        InferenceTranspiler().transpile(prog, scope=scope)
        out["b"] = (prog, scope)
        if "c" in legs:
            renamed = prog.clone()
            memory_optimize(renamed, skip_opt_set={plain["logits"].name})
            out["c"] = (renamed, scope)
    for leg in ("d", "e"):
        if leg in legs:
            prog, scope = qat["main"].clone(for_test=True), _scope_with(state, place)
            qt = QuantizeTranspiler()
            qt.freeze_program(prog, scope)
            if leg == "e":
                qt.convert_to_int8(prog, scope)
            out[leg] = (prog, scope)
    return {k: out[k] for k in legs}


def int8_conv_count(program, grouped=False):
    """The program's int8_conv2d ops with groups == 1 (or, with `grouped`,
    the others)."""
    n = 0
    for op in program.global_block().ops:
        if op.type == "int8_conv2d":
            n += (int(op.attrs.get("groups", 1) or 1) > 1) == grouped
    return n
