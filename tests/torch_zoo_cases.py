"""The zoo models at the smallest inputs that keep every layer (the builders
of tests/test_passes.py, 10 classes), shared by the parity tests against
the JAX package (tests/test_torch_zoo.py) and the card's tests
(tests/test_torch_zoo_cuda.py, which import no JAX)."""

import numpy as np

# name -> (input side, builder(models, img, label))
MODELS = {
    "alexnet": (67, lambda m, img, label: m.alexnet.alexnet(img, label, class_dim=10)),
    "vgg16": (32, lambda m, img, label: m.vgg.vgg16(img, label, class_num=10)),
    "vgg19": (32, lambda m, img, label: m.vgg.vgg19(img, label, class_num=10)),
    "googlenet": (96, lambda m, img, label: m.googlenet.googlenet(img, label, class_dim=10)),
    "se_resnext50": (64, lambda m, img, label: m.se_resnext.se_resnext50(
        img, label, class_dim=10, depth_override=[1, 1, 1, 1],
        filters_override=[32, 64, 128, 256])),
}


def build(pkg, mods, name, no_dropout=False):
    """(main, startup, loss) of `name` under Momentum(0.01, 0.9) in the
    package `pkg` (its fluid module) with its `models`; no_dropout sets
    every dropout op's rate to 0."""
    side, fn = MODELS[name]
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data(name="img", shape=[3, side, side], dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        loss = fn(mods, img, label)[0]
        pkg.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    if no_dropout:
        for op in main.global_block().ops:
            if op.type == "dropout":
                op.attrs["dropout_prob"] = 0.0
    return main, startup, loss


def feeds(name, steps, batch=2, seed=5):
    side = MODELS[name][0]
    rng = np.random.RandomState(seed)
    return [{"img": rng.randn(batch, 3, side, side).astype("float32"),
             "label": rng.randint(0, 10, (batch, 1)).astype("int64")} for _ in range(steps)]
