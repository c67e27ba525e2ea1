"""MobileNet-SSD, the detector of the reference era's model repository
(PaddlePaddle/models fluid/object_detection/mobilenet_ssd.py and train.py:
PASCAL VOC, 21 classes, 300 x 300 input, batch 64), as chip_smoke.py's
train-ssd and eval-ssd phases and the tests build it, with synthetic
VOC-shaped feeds made from a seed (the VOC images are not in the
repository).

`build(fluid, cfg)` takes the `fluid` module, so the tests build the same
program in both packages:

- network: a conv_bn stem of 32 filters at stride 2; depthwise-separable
  blocks 64, 128 (s2), 128, 256 (s2), 256, 512 (s2), five of 512, 1024 (s2)
  and 1024; four extra blocks 256->512, 128->256, 128->256 and 64->128, each
  with a 3x3 at stride 2. Every conv is bias-free, MSRA-initialized with a
  learning rate of 0.1 (as published) and followed by batch_norm + relu;
  widths scale by `cfg["scale"]`;
- head: multi_box_head over the 19x19, 10x10, 5x5, 3x3, 2x2 and 1x1 maps
  (at 300 x 300; 1917 priors) with the published sizes, which scale with
  the input;
- training: ssd_loss, its mean, RMSProp(piecewise_decay) at 1e-3 with
  L2Decay(5e-5); the boundaries at epochs 40, 60, 80 and 100 of the 16551
  VOC 2007+2012 trainval images, the values 1, 0.5, 0.25, 0.1 and 0.01 of
  the rate;
- eval: the program's for_test clone, softmax over the class scores (the
  reference's detection_output applies it; the JAX layer takes scores after
  it), detection_output(nms_threshold=0.45), and a detection_map op on the
  detections and the labels in [label, x1, y1, x2, y2] form, 11-point AP.

Where this differs from the published script: the extra blocks' groups are
1 at every scale (int(1 * scale) is 0 below width 1), and detection_output
and the mAP are built in the eval clone only, so a training step does not
run the NMS it never fetches.
"""

import numpy as np

SSD = dict(batch=64, image=300, classes=21, scale=1.0, max_gt=16, min_gt=1, top_gt=8,
           lr=1e-3, l2=5e-5, train_images=16551, nms_threshold=0.45, seed=0)
# the CPU tests' size: width 0.25, a 64 x 64 input (every map at least 1 x 1)
SMALL = dict(SSD, batch=4, image=64, scale=0.25)

_MIN_SIZES = [60.0, 105.0, 150.0, 195.0, 240.0, 285.0]
_MAX_SIZES = [[], 150.0, 195.0, 240.0, 285.0, 300.0]
_ASPECT_RATIOS = [[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0]]


def _conv_bn(fluid, x, filter_size, num_filters, stride, padding, groups=1):
    attr = fluid.ParamAttr(learning_rate=0.1, initializer=fluid.initializer.MSRA())
    conv = fluid.layers.conv2d(input=x, num_filters=num_filters, filter_size=filter_size,
                               stride=stride, padding=padding, groups=groups, act=None,
                               param_attr=attr, bias_attr=False)
    return fluid.layers.batch_norm(input=conv, act="relu")


def _depthwise_separable(fluid, x, filters1, filters2, groups, stride, scale):
    dw = _conv_bn(fluid, x, 3, int(filters1 * scale), stride, 1, groups=int(groups * scale))
    return _conv_bn(fluid, dw, 1, int(filters2 * scale), 1, 0)


def _extra_block(fluid, x, filters1, filters2, scale):
    pw = _conv_bn(fluid, x, 1, int(filters1 * scale), 1, 0)
    return _conv_bn(fluid, pw, 3, int(filters2 * scale), 2, 1)


def mobilenet_ssd(fluid, img, cfg):
    """(mbox_locs, mbox_confs, boxes, variances) of the network on `img`."""
    s = cfg["scale"]
    x = _conv_bn(fluid, img, 3, int(32 * s), 2, 1)
    for f1, f2, g, stride in ((32, 64, 32, 1), (64, 128, 64, 2), (128, 128, 128, 1),
                              (128, 256, 128, 2), (256, 256, 256, 1), (256, 512, 256, 2)):
        x = _depthwise_separable(fluid, x, f1, f2, g, stride, s)
    for _ in range(5):
        x = _depthwise_separable(fluid, x, 512, 512, 512, 1, s)
    module11 = x
    x = _depthwise_separable(fluid, x, 512, 1024, 512, 2, s)
    module13 = _depthwise_separable(fluid, x, 1024, 1024, 1024, 1, s)
    module14 = _extra_block(fluid, module13, 256, 512, s)
    module15 = _extra_block(fluid, module14, 128, 256, s)
    module16 = _extra_block(fluid, module15, 128, 256, s)
    module17 = _extra_block(fluid, module16, 64, 128, s)
    k = cfg["image"] / 300.0
    return fluid.layers.multi_box_head(
        inputs=[module11, module13, module14, module15, module16, module17], image=img,
        num_classes=cfg["classes"], min_ratio=20, max_ratio=90,
        min_sizes=[v * k for v in _MIN_SIZES],
        max_sizes=[[v * k for v in m] if isinstance(m, list) else m * k for m in _MAX_SIZES],
        aspect_ratios=_ASPECT_RATIOS, base_size=cfg["image"], offset=0.5, flip=True)


def _schedule(cfg):
    epoch = cfg["train_images"] // cfg["batch"]
    boundaries = [epoch * e for e in (40, 60, 80, 100)]
    values = [cfg["lr"] * f for f in (1.0, 0.5, 0.25, 0.1, 0.01)]
    return boundaries, values


def build(fluid, cfg=SSD):
    """The training and eval programs of `cfg`: a dict of the programs, the
    feed names and the variables a script fetches."""
    main, startup = fluid.Program(), fluid.Program()
    g, c = cfg["max_gt"], cfg["classes"]
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="image", shape=[3, cfg["image"], cfg["image"]],
                                dtype="float32")
        gt_box = fluid.layers.data(name="gt_box", shape=[g, 4], dtype="float32")
        main.global_block().create_var(name="gt_len", shape=(-1,), dtype="int64")
        gt_box._len_name = "gt_len"
        gt_label = fluid.layers.data(name="gt_label", shape=[g, 1], dtype="int64")
        locs, confs, boxes, variances = mobilenet_ssd(fluid, img, cfg)
        loss = fluid.layers.mean(
            fluid.layers.ssd_loss(locs, confs, gt_box, gt_label, boxes, variances))
        test = main.clone(for_test=True)
        boundaries, values = _schedule(cfg)
        fluid.optimizer.RMSProp(
            learning_rate=fluid.layers.piecewise_decay(boundaries, values),
            regularization=fluid.regularizer.L2Decay(cfg["l2"])).minimize(loss)
    tb = test.global_block()
    with fluid.unique_name.guard("eval_"), fluid.program_guard(test, startup):
        scores = fluid.layers.softmax(tb.var(confs.name))
        nmsed = fluid.layers.detection_output(
            tb.var(locs.name), scores, tb.var(boxes.name), tb.var(variances.name),
            nms_threshold=cfg["nms_threshold"])
        labels = fluid.layers.concat(
            [fluid.layers.cast(tb.var(gt_label.name), "float32"), tb.var(gt_box.name)], axis=2)
        tb.create_var(name="map", shape=(1,), dtype="float32")
        tb.append_op(type="detection_map",
                     inputs={"DetectRes": [nmsed.name], "Label": [labels.name]},
                     outputs={"MAP": ["map"]},
                     attrs={"overlap_threshold": 0.5, "ap_version": "11point",
                            "class_num": c, "background_label": 0})
    return dict(main=main, startup=startup, test=test, loss=loss, nmsed=nmsed.name,
                labels=labels.name, map="map", feeds=["image", "gt_box", "gt_len", "gt_label"])


def synthetic_batch(rng, cfg=SSD):
    """A VOC-shaped scene from `rng`: min_gt-top_gt boxes an image (corners
    in [0, 1], sides 0.1-0.5), padded to max_gt with -1 labels, labels in
    1..classes-1, each box painted into the image with its class's colour
    over noise."""
    b, g, size = cfg["batch"], cfg["max_gt"], cfg["image"]
    img = rng.rand(b, 3, size, size).astype("float32")
    boxes = np.zeros((b, g, 4), "float32")
    labels = np.full((b, g, 1), -1, "int64")
    lens = rng.randint(cfg["min_gt"], cfg["top_gt"] + 1, size=b).astype("int64")
    colours = np.random.RandomState(1).rand(cfg["classes"], 3).astype("float32")
    for i in range(b):
        for j in range(lens[i]):
            wh = rng.uniform(0.1, 0.5, size=2)
            x1, y1 = rng.uniform(0.0, 1.0 - wh)
            boxes[i, j] = [x1, y1, x1 + wh[0], y1 + wh[1]]
            labels[i, j, 0] = rng.randint(1, cfg["classes"])
            c0, r0 = int(x1 * size), int(y1 * size)
            c1, r1 = int((x1 + wh[0]) * size), int((y1 + wh[1]) * size)
            img[i, :, r0:r1, c0:c1] += colours[labels[i, j, 0]][:, None, None]
    return {"image": img, "gt_box": boxes, "gt_len": lens, "gt_label": labels}


def reference_map(nmsed, labels, DetectionMAP, classes):
    """The 11-point mAP of fetched detection_output rows [B, K, 6] against
    the [label, x1, y1, x2, y2] labels [B, G, 5], by `DetectionMAP` (an
    evaluator class), as the detection_map host op computes it."""
    ev = DetectionMAP(class_num=classes, background_label=0, overlap_threshold=0.5,
                      ap_version="11point")
    for dets, gts in zip(np.asarray(nmsed), np.asarray(labels)):
        gts = gts[gts[:, 0] >= 0]
        ev.update(dets[dets[:, 0] >= 0], gts[:, 0], gts[:, 1:5])
    return ev.eval()
