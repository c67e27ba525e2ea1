"""The rest of the CNN zoo at its published ImageNet widths (3 x 224 x 224
inputs, 1000 classes), as chip_smoke.py's train-zoo phase trains it:

- VGG-19 (models/vgg.py: conv blocks (2, 2, 4, 4, 4) of 64-512 filters,
  fc 4096, 4096), batch 64, Momentum(0.01, 0.9): the JAX package's VGG-19
  bench (bench.py:229-260);
- AlexNet (models/alexnet.py: 5 convs, LRN after the first two, fc 4096,
  4096), batch 128, Momentum(0.01, 0.9): the reference speed table's
  AlexNet row (benchmark/README.md:33-38 of the reference, BASELINE.md,
  batches 64-512; 128 is the row its 4-card table also runs a card);
- GoogLeNet (models/googlenet.py: Inception-v1 with both auxiliary heads,
  as googlenet() defaults), batch 128, Momentum(0.01, 0.9): the same
  table's GoogLeNet row (benchmark/README.md:45-51, batches 64-256);
- SE-ResNeXt-50 32x4d (models/se_resnext.py: bottlenecks [3, 4, 6, 3],
  filters [128, 256, 512, 1024], cardinality 32, SE ratio 16), batch 64,
  Momentum(0.1, 0.9): the reference's SE-ResNeXt tests
  (dist_se_resnext.py), at ResNet-50's rate.

The batches are synthetic (normal images, uniform labels) from a seed,
staged on the card once and cycled, as bench.py stages its batches. The
reference's learning rates for AlexNet and GoogLeNet are not in the
repository; 0.01 with momentum 0.9 is VGG's.
"""

import numpy as np
import torch

SEED = 0
ZOO = {
    "vgg19": dict(batch=64, lr=0.01, momentum=0.9, source="bench.py:229-260 (run_vgg19)"),
    "alexnet": dict(batch=128, lr=0.01, momentum=0.9,
                    source="reference benchmark/README.md:33-38 (BASELINE.md), bs 128"),
    "googlenet": dict(batch=128, lr=0.01, momentum=0.9,
                      source="reference benchmark/README.md:45-51 (BASELINE.md), bs 128"),
    "se_resnext50": dict(batch=64, lr=0.1, momentum=0.9,
                         source="reference unittests/dist_se_resnext.py, "
                                "paddle_tpu/models/se_resnext.py:49-56"),
}
STAGED = 2  # synthetic batches staged on the card, cycled


def _net(models, name, img, label):
    if name == "vgg19":
        return models.vgg.vgg19(img, label)
    if name == "alexnet":
        return models.alexnet.alexnet(img, label)
    if name == "googlenet":
        return models.googlenet.googlenet(img, label)
    return models.se_resnext.se_resnext50(img, label)


def build(name):
    """The model `name` of ZOO under its Momentum, as a dict like
    profile_training.build_resnet50's."""
    from .. import fluid, models

    cfg = ZOO[name]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 224, 224], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc, out = _net(models, name, img, label)
        fluid.optimizer.Momentum(learning_rate=cfg["lr"], momentum=cfg["momentum"]).minimize(
            loss)
    return dict(main=main, startup=startup, img=img, label=label, loss=loss, acc=acc,
                logits=out)


def feeds(name, device, n=STAGED, seed=SEED):
    """n synthetic batches of the model's batch size from the seed, staged
    on `device` once."""
    batch = ZOO[name]["batch"]
    rng = np.random.RandomState(seed)
    return [{"img": torch.from_numpy(rng.randn(batch, 3, 224, 224).astype("float32")).to(device),
             "label": torch.from_numpy(rng.randint(0, 1000, (batch, 1)).astype("int64")).to(device)}
            for _ in range(n)]


# the busy split's categories for the zoo: op types whose device time each
# sums (profile_training.op_device_split)
SPLIT = (
    ("conv_forward", ("conv2d", "depthwise_conv2d")),
    ("conv_backward", ("conv2d_grad", "depthwise_conv2d_grad")),
    ("batch_norm_forward", ("batch_norm",)),
    ("batch_norm_backward", ("batch_norm_grad",)),
    ("lrn", ("lrn", "lrn_grad")),
    ("pooling", ("pool2d", "pool2d_grad")),
    ("fc", ("mul", "mul_grad", "fused:gemm_epilogue")),
    ("optimizer", ("momentum",)),
    ("elementwise", ("relu", "relu_grad", "elementwise_add", "elementwise_add_grad",
                     "elementwise_mul", "elementwise_mul_grad", "sum", "fill_constant",
                     "sigmoid", "sigmoid_grad")),
    ("concat", ("concat", "concat_grad")),
    ("dropout", ("dropout", "dropout_grad")),
)
