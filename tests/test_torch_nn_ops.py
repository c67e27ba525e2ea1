"""The rest of the JAX package's core ops in the torch port
(paddle_tpu_torch/ops/core_ops.py: prelu, the smooth L1 / log / hinge
losses, positive_negative_pair, split, stack, unstack, squeeze,
unsqueeze, slice, scatter, pad, pad2d, embedding, label_smooth, norm, the
bilinear and nearest interpolations, lod_reset, lrn), their layers, and
the explicit batch_norm_grad, against the JAX package on the CPU.

Each op case builds the same one-op program in both packages from seeded
numpy feeds, differentiates the sum of mean(out_i * dy_i) over its float
outputs by each package's append_backward, and compares the fetched
outputs and input grads, with test_torch_cnn_ops.py's tolerances:
- forward: rtol = atol = 1e-5 (f32 both sides, sums in another order);
- grads: rtol 1e-4 with an absolute floor of 1e-5 of the grad's largest
  magnitude.
The interpolations use the same bars: torch's antialiased bilinear filter
and "nearest-exact" compute jax.image.resize's half-pixel weights.

batch_norm_grad (one native_batch_norm_backward, no forward replay)
against the generic vjp grad sums in another order: rtol 1e-5 with an
absolute floor of 1e-6 of the grad's largest magnitude; against the JAX
package's grad, the grad bars above.
"""

import importlib
import inspect
import os

import numpy as np
import pytest
import torch

import jax

from paddle_tpu_torch.ops import registry

from test_torch_cnn_ops import _both, _close_fwd, _close_grad, _pkg, _rand, _session
from torch_cnn_cases import BN_CASES

jax.config.update("jax_platforms", "cpu")

BN_GRAD_RTOL, BN_GRAD_ATOL = 1e-5, 1e-6


def _ops_build(op_type, inputs, outputs, attrs, grad_outs, dy_shapes=None):
    """A builder of one `op_type` op over data vars. `inputs`: slot ->
    [(name, array, needs_grad)]; `outputs`: slot -> [dtype, ...];
    `grad_outs`: the (slot, index) outputs whose mean(out * dy) terms sum to
    the loss, each dy fed as "dy<i>" (shapes from `dy_shapes`). Returns the
    fetch names: every output, then the grad of each input that takes
    one."""

    def build(pkg, helper_cls):
        L = pkg.layers
        ins = {}
        for slot, items in inputs.items():
            ins[slot] = [
                L.data(name=n, shape=list(a.shape), dtype=str(a.dtype),
                       append_batch_size=False, stop_gradient=not g).name
                for n, a, g in items
            ]
        helper = helper_cls(op_type)
        outs = {slot: [helper.create_variable_for_type_inference(dt) for dt in dts]
                for slot, dts in outputs.items()}
        helper.append_op(type=op_type, inputs=ins,
                         outputs={s: [v.name for v in vs] for s, vs in outs.items()},
                         attrs=dict(attrs or {}))
        names = [v.name for vs in outs.values() for v in vs]
        if dy_shapes is None:
            return names
        terms = []
        for i, (slot, k) in enumerate(grad_outs):
            dy = L.data(name="dy%d" % i, shape=list(dy_shapes[i]), dtype="float32",
                        append_batch_size=False)
            terms.append(L.mean(L.elementwise_mul(outs[slot][k], dy)))
        loss = terms[0]
        for t in terms[1:]:
            loss = L.elementwise_add(loss, t)
        pkg.append_backward(loss)
        return names + [n + "@GRAD" for items in inputs.values() for n, _, g in items if g]

    return build


def _check(op_type, inputs, outputs, attrs=None, grad_outs=(), seed=0):
    """Run the op in both packages and compare every output and input
    grad. Returns the port's fetches and the JAX package's."""
    import paddle_tpu_torch as pt

    feeds = {n: a for items in inputs.values() for n, a, _ in items}
    dy_shapes = None
    if grad_outs:
        main = pt.Program()
        helper_cls = importlib.import_module("paddle_tpu_torch.layer_helper").LayerHelper
        with pt.unique_name.guard(), pt.program_guard(main, pt.Program()):
            names = _ops_build(op_type, inputs, outputs, attrs, grad_outs)(pt, helper_cls)
        order = [(s, k) for s, dts in outputs.items() for k in range(len(dts))]
        block = main.global_block()
        dy_shapes = [block.var(names[order.index(go)]).shape for go in grad_outs]
        rng = np.random.RandomState(seed + 1)
        for i, shape in enumerate(dy_shapes):
            feeds["dy%d" % i] = rng.randn(*shape).astype("float32")
    build = _ops_build(op_type, inputs, outputs, attrs, grad_outs, dy_shapes)
    (j, _), (p, _) = _both(build, feeds)
    n_out = sum(len(d) for d in outputs.values())
    for i, (g, w) in enumerate(zip(p[0], j[0])):
        assert g.shape == w.shape, (op_type, i, g.shape, w.shape)
        if i < n_out:
            _close_fwd(g, w, "%s output %d" % (op_type, i))
        else:
            _close_grad(g, w, "%s grad %d" % (op_type, i - n_out))
    assert len(p[0]) == len(j[0])
    return p[0], j[0]


# --------------------------------------------------------------------------
# the op cases: (op, inputs, outputs, attrs, grad outputs); inputs name a
# generator of the arrays below
# --------------------------------------------------------------------------


def _arrays(rng):
    prob = rng.rand(6, 1).astype("float32") * 0.9 + 0.05
    return {
        "x4": lambda: rng.randn(2, 3, 4, 5).astype("float32"),
        "x3": lambda: rng.randn(3, 4, 5).astype("float32"),
        "x2": lambda: rng.randn(6, 4).astype("float32"),
        "x2b": lambda: rng.randn(6, 4).astype("float32"),
        "alpha1": lambda: np.array([0.25], "float32"),
        "alpha_c": lambda: rng.rand(3).astype("float32"),
        "alpha_e": lambda: rng.rand(3, 4, 5).astype("float32"),
        "prob": lambda: prob,
        "label01": lambda: rng.randint(0, 2, (6, 1)).astype("float32"),
        "w_in": lambda: rng.rand(6, 4).astype("float32") + 0.5,
        "w_out": lambda: rng.rand(6, 4).astype("float32") + 0.5,
        "sq": lambda: rng.randn(3, 1, 4, 1).astype("float32"),
        "table": lambda: rng.randn(10, 4).astype("float32"),
        "ids": lambda: np.array([[1], [3], [1], [9], [0]], "int64"),
        "ids_pad": lambda: np.array([[1], [2], [-1], [2]], "int64"),
        "onehot": lambda: np.eye(5, dtype="float32")[rng.randint(0, 5, 6)],
        "prior": lambda: rng.dirichlet(np.ones(5)).astype("float32"),
        "img": lambda: rng.randn(2, 6, 5, 5).astype("float32"),
    }


CASES = {
    "prelu_all": ("prelu", {"X": [("x", "x4", True)], "Alpha": [("a", "alpha1", True)]},
                  {"Out": ["float32"]}, {"mode": "all"}, [("Out", 0)]),
    "prelu_channel": ("prelu", {"X": [("x", "x4", True)], "Alpha": [("a", "alpha_c", True)]},
                      {"Out": ["float32"]}, {"mode": "channel"}, [("Out", 0)]),
    "prelu_element": ("prelu", {"X": [("x", "x4", True)], "Alpha": [("a", "alpha_e", True)]},
                      {"Out": ["float32"]}, {"mode": "element"}, [("Out", 0)]),
    "smooth_l1": ("smooth_l1_loss", {"X": [("x", "x2", True)], "Y": [("y", "x2b", True)]},
                  {"Out": ["float32"], "Diff": ["float32"]}, {"sigma": 2.0}, [("Out", 0)]),
    "smooth_l1_weighted": ("smooth_l1_loss",
                           {"X": [("x", "x2", True)], "Y": [("y", "x2b", False)],
                            "InsideWeight": [("wi", "w_in", False)],
                            "OutsideWeight": [("wo", "w_out", False)]},
                           {"Out": ["float32"], "Diff": ["float32"]}, {}, [("Out", 0)]),
    "log_loss": ("log_loss", {"Predicted": [("p", "prob", True)],
                              "Labels": [("l", "label01", False)]},
                 {"Loss": ["float32"]}, {"epsilon": 1e-4}, [("Loss", 0)]),
    "hinge_loss": ("hinge_loss", {"Logits": [("x", "prob", True)],
                                  "Labels": [("l", "label01", False)]},
                   {"Loss": ["float32"]}, {}, [("Loss", 0)]),
    "split_sections": ("split", {"X": [("x", "x3", True)]},
                       {"Out": ["float32"] * 3}, {"axis": 2, "sections": [1, 3, 1], "num": 0},
                       [("Out", 0), ("Out", 2)]),
    "split_num": ("split", {"X": [("x", "x3", True)]}, {"Out": ["float32"] * 2},
                  {"axis": 1, "num": 2, "sections": []}, [("Out", 0), ("Out", 1)]),
    "stack_axis1": ("stack", {"X": [("x", "x2", True), ("y", "x2b", True)]},
                    {"Y": ["float32"]}, {"axis": 1}, [("Y", 0)]),
    "unstack_axis1": ("unstack", {"X": [("x", "x3", True)]}, {"Y": ["float32"] * 4},
                      {"axis": 1, "num": 4}, [("Y", 1), ("Y", 3)]),
    "squeeze_axes": ("squeeze", {"X": [("x", "sq", True)]}, {"Out": ["float32"]},
                     {"axes": [3]}, [("Out", 0)]),
    "squeeze_all": ("squeeze", {"X": [("x", "sq", True)]}, {"Out": ["float32"]},
                    {"axes": []}, [("Out", 0)]),
    "unsqueeze": ("unsqueeze", {"X": [("x", "x2", True)]}, {"Out": ["float32"]},
                  {"axes": [0, 2]}, [("Out", 0)]),
    "slice": ("slice", {"Input": [("x", "x4", True)]}, {"Out": ["float32"]},
              {"axes": [1, 2, 3], "starts": [-2, 1, 0], "ends": [100, -1, 3]}, [("Out", 0)]),
    "pad": ("pad", {"X": [("x", "x3", True)]}, {"Out": ["float32"]},
            {"paddings": [0, 1, 2, 0, 1, 1], "pad_value": 0.5}, [("Out", 0)]),
    "pad2d_constant": ("pad2d", {"X": [("x", "x4", True)]}, {"Out": ["float32"]},
                       {"paddings": [1, 0, 2, 1], "mode": "constant", "pad_value": -1.0},
                       [("Out", 0)]),
    "pad2d_reflect": ("pad2d", {"X": [("x", "x4", True)]}, {"Out": ["float32"]},
                      {"paddings": [1, 2, 2, 1], "mode": "reflect"}, [("Out", 0)]),
    "pad2d_edge": ("pad2d", {"X": [("x", "x4", True)]}, {"Out": ["float32"]},
                   {"paddings": [2, 1, 0, 3], "mode": "edge"}, [("Out", 0)]),
    "embedding": ("embedding", {"W": [("w", "table", True)], "Ids": [("ids", "ids", False)]},
                  {"Out": ["float32"]}, {}, [("Out", 0)]),
    "embedding_padding_idx": ("embedding",
                              {"W": [("w", "table", True)], "Ids": [("ids", "ids_pad", False)]},
                              {"Out": ["float32"]}, {"padding_idx": 2}, [("Out", 0)]),
    "label_smooth": ("label_smooth", {"X": [("x", "onehot", True)]}, {"Out": ["float32"]},
                     {"epsilon": 0.2}, [("Out", 0)]),
    "label_smooth_prior": ("label_smooth", {"X": [("x", "onehot", True)],
                                            "PriorDist": [("prior", "prior", False)]},
                           {"Out": ["float32"]}, {"epsilon": 0.1}, [("Out", 0)]),
    "norm": ("norm", {"X": [("x", "x4", True)]}, {"Out": ["float32"], "Norm": ["float32"]},
             {"axis": 1, "epsilon": 1e-10}, [("Out", 0)]),
    "norm_last_axis": ("norm", {"X": [("x", "x3", True)]},
                       {"Out": ["float32"], "Norm": ["float32"]}, {"axis": 2, "epsilon": 1e-6},
                       [("Out", 0)]),
    "lod_reset": ("lod_reset", {"X": [("x", "x2", True)]}, {"Out": ["float32"]}, {},
                  [("Out", 0)]),
    "lrn": ("lrn", {"X": [("x", "img", True)]}, {"Out": ["float32"], "MidOut": ["float32"]},
            {"n": 5, "k": 1.0, "alpha": 1e-4, "beta": 0.75}, [("Out", 0)]),
    "lrn_n3_k2": ("lrn", {"X": [("x", "img", True)]},
                  {"Out": ["float32"], "MidOut": ["float32"]},
                  {"n": 3, "k": 2.0, "alpha": 0.1, "beta": 0.5}, [("Out", 0)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_and_grads(case):
    op, inputs, outputs, attrs, grad_outs = CASES[case]
    arrays = _arrays(np.random.RandomState(21))
    ins = {slot: [(n, arrays[kind](), g) for n, kind, g in items]
           for slot, items in inputs.items()}
    _check(op, ins, outputs, attrs, grad_outs)


# the interpolations at up and down ratios 2, 3 and 1.5 and a mixed one
INTERP_SIZES = {
    "up2": ((6, 6), (12, 12)),
    "up3": ((4, 4), (12, 12)),
    "up1.5": ((6, 6), (9, 9)),
    "down2": ((12, 12), (6, 6)),
    "down3": ((12, 12), (4, 4)),
    "down1.5": ((9, 9), (6, 6)),
    "mixed": ((7, 10), (11, 4)),
}


@pytest.mark.parametrize("op", ["bilinear_interp", "nearest_interp"])
@pytest.mark.parametrize("case", sorted(INTERP_SIZES))
def test_interp(op, case):
    (h, w), (oh, ow) = INTERP_SIZES[case]
    x = _rand((2, 3, h, w), 22)
    _check(op, {"X": [("x", x, True)]}, {"Out": ["float32"]},
           {"out_h": oh, "out_w": ow, "align_corners": True}, [("Out", 0)])


@pytest.mark.parametrize("overwrite", [True, False])
def test_scatter_repeated_index(overwrite):
    """Row 1 is written by updates 0 and 2, row 3 by -2 (from the end): the
    overwrite keeps the last update of a row (the JAX lowering's order),
    and the repeated row's first update takes no grad; the add sums
    both."""
    x = _rand((5, 3), 23)
    ids = np.array([1, 3, 1, -2, 0], "int64")
    upd = _rand((5, 3), 24)
    p, _ = _check("scatter", {"X": [("x", x, True)], "Ids": [("ids", ids, False)],
                              "Updates": [("u", upd, True)]},
                  {"Out": ["float32"]}, {"overwrite": overwrite}, [("Out", 0)])
    out, dupd = p[0], p[2]
    if overwrite:
        np.testing.assert_array_equal(out[1], upd[2])
        np.testing.assert_array_equal(dupd[0], 0.0)
        assert np.abs(dupd[2]).max() > 0
    else:
        np.testing.assert_allclose(out[1], x[1] + upd[0] + upd[2], rtol=1e-6)
        np.testing.assert_allclose(out[3], x[3] + upd[1] + upd[3], rtol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_positive_negative_pair(weighted):
    """The counts over within-query pairs, with ties in scores and labels,
    a column other than the last, the accumulators added and (weighted)
    pair weights; no grad."""
    rng = np.random.RandomState(25)
    score = rng.randint(0, 4, (12, 2)).astype("float32")
    label = rng.randint(0, 3, (12, 1)).astype("float32")
    qid = rng.randint(0, 3, (12, 1)).astype("int64")
    inputs = {"Score": [("s", score, False)], "Label": [("l", label, False)],
              "QueryID": [("q", qid, False)]}
    for kind, v in (("Positive", 2.0), ("Negative", 1.0), ("Neutral", 0.5)):
        inputs["Accumulate%sPair" % kind] = [("acc_" + kind, np.array([v], "float32"), False)]
    if weighted:
        inputs["Weight"] = [("w", rng.rand(12, 1).astype("float32"), False)]
    p, _ = _check("positive_negative_pair", inputs,
                  {"PositivePair": ["float32"], "NegativePair": ["float32"],
                   "NeutralPair": ["float32"]}, {"column": 0})
    assert p[0][0] > 2.0 and p[1][0] > 1.0
    assert registry.get("positive_negative_pair").no_grad


def test_embedding_sparse_grad_path():
    """The embedding op takes lookup_table's grad maker: is_sparse=True
    with one consumer emits lookup_table_grad_sparse and sgd_sparse in
    both packages, and two SGD steps leave the same table as the JAX
    package's and as the port's dense grad (only the looked-up rows
    move)."""
    rng = np.random.RandomState(26)
    table = rng.randn(12, 4).astype("float32")
    ids = np.array([[1], [5], [1], [7]], "int64")
    dy = rng.randn(4, 4).astype("float32")

    def run(name, is_sparse):
        pkg = _pkg(name)
        helper_cls = importlib.import_module(name + ".layer_helper").LayerHelper
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            L = pkg.layers
            iv = L.data(name="ids", shape=[4, 1], dtype="int64", append_batch_size=False)
            dv = L.data(name="dy", shape=[4, 4], dtype="float32", append_batch_size=False)
            helper = helper_cls("embedding")
            w = helper.create_parameter(attr=pkg.ParamAttr(name="emb_w"), shape=[12, 4],
                                        dtype="float32")
            out = helper.create_variable_for_type_inference("float32")
            helper.append_op(type="embedding", inputs={"W": [w.name], "Ids": [iv.name]},
                             outputs={"Out": [out.name]},
                             attrs={"is_sparse": is_sparse, "padding_idx": -1})
            loss = L.mean(L.elementwise_mul(out, dv))
            pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
        types = {op.type for op in main.global_block().ops}
        exe, scope, guard = _session(name)
        with guard(scope):
            exe.run(startup)
            if name == "paddle_tpu":
                import jax.numpy as jnp

                scope.vars["emb_w"] = jnp.asarray(table)
            else:
                from paddle_tpu_torch import convert

                convert.load_into_scope(scope, {"emb_w": table}, ["emb_w"])
            for _ in range(2):
                exe.run(main, feed={"ids": ids, "dy": dy}, fetch_list=[loss.name])
            final = np.asarray(scope.find_var("emb_w")) if name == "paddle_tpu" else \
                scope.find_var("emb_w").numpy()
        return types, final

    jt, jw = run("paddle_tpu", True)
    pt_, pw = run("paddle_tpu_torch", True)
    _, dense = run("paddle_tpu_torch", False)
    assert {"lookup_table_grad_sparse", "sgd_sparse"} <= jt
    assert {"lookup_table_grad_sparse", "sgd_sparse"} <= pt_
    _close_fwd(pw, jw, "sparse table vs JAX")
    _close_fwd(pw, dense, "sparse table vs dense")
    moved = np.nonzero(np.abs(pw - table).max(1))[0]
    np.testing.assert_array_equal(moved, [1, 5, 7])


# --------------------------------------------------------------------------
# layers: the same op list in both packages, each signature as API.spec
# --------------------------------------------------------------------------


def _layer_cases(L, nets):
    """name -> fn(data vars) that calls one layer."""
    return {
        "conv2d_transpose": lambda d: L.conv2d_transpose(d["img"], num_filters=4,
                                                         filter_size=3, stride=2, padding=1),
        "conv2d_transpose_output_size": lambda d: L.conv2d_transpose(
            d["img"], num_filters=4, output_size=[11, 11], stride=2, act="relu"),
        "image_resize": lambda d: L.image_resize(d["img"], out_shape=[9, 7]),
        "resize_bilinear": lambda d: L.resize_bilinear(d["img"], scale=1.5),
        "resize_nearest": lambda d: L.resize_nearest(d["img"], out_shape=[3, 4]),
        "l2_normalize": lambda d: L.l2_normalize(d["x"], axis=1),
        "label_smooth": lambda d: L.label_smooth(d["x"], epsilon=0.2),
        "log_loss": lambda d: L.log_loss(d["x"], d["y"]),
        "lrn": lambda d: L.lrn(d["img"], n=3),
        "pad": lambda d: L.pad(d["x"], paddings=[0, 1, 2, 0], pad_value=1.0),
        "pad2d": lambda d: L.pad2d(d["img"], paddings=[1, 1, 0, 2], mode="reflect"),
        "prelu": lambda d: L.prelu(d["img"], mode="channel"),
        "scatter": lambda d: L.scatter(d["x"], d["ids"], d["y"], overwrite=False),
        "slice": lambda d: L.slice(d["img"], axes=[2, 3], starts=[1, 0], ends=[4, -1]),
        "smooth_l1": lambda d: L.smooth_l1(d["x"], d["y"], sigma=3.0),
        "split": lambda d: L.split(d["img"], num_or_sections=[1, 2], dim=1),
        "stack": lambda d: L.stack([d["x"], d["y"]], axis=1),
        "unstack": lambda d: L.unstack(d["x"], axis=1),
        "glu": lambda d: nets.glu(d["x"], dim=-1),
        "positive_negative_pair": lambda d: L.positive_negative_pair(
            d["x"], d["label"], d["ids"], column=0),
    }


def _layer_program(name, case):
    pkg = _pkg(name)
    nets = importlib.import_module(name + ".nets")
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        d = {"img": L.data(name="img", shape=[3, 6, 6], dtype="float32"),
             "x": L.data(name="x", shape=[4], dtype="float32"),
             "y": L.data(name="y", shape=[4], dtype="float32"),
             "ids": L.data(name="ids", shape=[1], dtype="int64"),
             "label": L.data(name="label", shape=[1], dtype="float32")}
        _layer_cases(L, nets)[case](d)

    def listing(prog):
        return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
                 sorted((k, repr(v)) for k, v in op.attrs.items() if not k.startswith("op_"))
                 ) for op in prog.global_block().ops]

    shapes = {v.name: v.shape for v in main.global_block().vars.values()}
    return listing(main), listing(startup), shapes


@pytest.mark.parametrize("case", sorted(_layer_cases(None, None)))
def test_layer_builds_the_same_ops(case):
    """The layer appends the same ops, attrs and parameters (the startup
    program's initializers) in both packages, and gives its outputs the
    same shapes."""
    j_main, j_start, j_shapes = _layer_program("paddle_tpu", case)
    p_main, p_start, p_shapes = _layer_program("paddle_tpu_torch", case)
    assert p_main == j_main
    assert p_start == j_start
    assert {n: tuple(s) for n, s in p_shapes.items() if s is not None} == \
        {n: tuple(s) for n, s in j_shapes.items() if s is not None}


def _spec():
    path = os.path.join(os.path.dirname(__file__), "..", "paddle_tpu", "API.spec")
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    out = {}
    for ln in lines:
        name, _, sig = ln.partition(" ")
        out[name] = sig
    return out


SPEC_NAMES = ("conv2d_transpose", "image_resize", "resize_bilinear", "resize_nearest",
              "l2_normalize", "label_smooth", "log_loss", "lrn", "pad", "pad2d", "prelu",
              "scatter", "slice", "smooth_l1", "split", "stack", "unstack",
              "positive_negative_pair")


@pytest.mark.parametrize("name", SPEC_NAMES + ("nets.glu",))
def test_layer_signature_matches_api_spec(name):
    import paddle_tpu_torch as pt

    spec = _spec()
    if name.startswith("nets."):
        fn, key = getattr(pt.nets, name[5:]), "paddle_tpu." + name
    else:
        fn, key = getattr(pt.layers, name), "paddle_tpu.layers." + name
    assert str(inspect.signature(fn)) == spec[key]


def test_conv2d_transpose_waits_for_its_lowering():
    """conv2d_transpose builds (filter, bias, activation), but its op has no
    lowering in the port yet: Executor.run raises the usual error."""
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, 6, 6], dtype="float32")
        out = pt.layers.conv2d_transpose(img, num_filters=4, filter_size=3, act="relu")
    assert out.shape == (-1, 4, 8, 8)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope(place=pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(startup)
        with pytest.raises(NotImplementedError, match="conv2d_transpose"):
            exe.run(main, feed={"img": np.zeros((2, 3, 6, 6), "float32")},
                    fetch_list=[out.name])


def test_every_op_type_of_the_slice_is_registered():
    types = {c[0] for c in CASES.values()} | {"bilinear_interp", "nearest_interp", "scatter",
                                              "positive_negative_pair", "batch_norm_grad"}
    assert len(types - {"batch_norm_grad"}) == 21
    assert {t for t in types if t not in registry.OPS} == set()


# --------------------------------------------------------------------------
# the explicit batch_norm_grad
# --------------------------------------------------------------------------


def _bn_inputs(shape, layout, seed):
    c = shape[1] if layout == "NCHW" else shape[-1]
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype("float32"))  # noqa: E731
    return {"X": [t(rng.randn(*shape) * 2 + 1)], "Scale": [t(rng.rand(c) + 0.5)],
            "Bias": [t(rng.randn(c))], "Mean": [t(rng.randn(c))],
            "Variance": [t(rng.rand(c) + 0.5)]}, t(rng.randn(*shape))


class _GradOp:
    """What a grad op writes (the LowerCtx.op the explicit lowering asks)."""

    def __init__(self, outputs):
        self.outputs = outputs


@pytest.mark.parametrize("skip_x", [False, True])
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_explicit_grad_matches_generic(case, skip_x):
    """batch_norm_grad's explicit lowering (one native_batch_norm_backward
    from the saved statistics) against the generic vjp of the forward, on
    the same inputs: training, is_test, use_global_stats, NHWC and 2-D;
    with skip_x the grad op writes no X@GRAD (a first layer's input) and
    the explicit lowering computes none."""
    extra, shape, layout = BN_CASES[case]
    ins, dy = _bn_inputs(shape, layout, 27)
    attrs = dict(extra, data_layout=layout, momentum=0.8, epsilon=1e-5)
    ctx = registry.LowerCtx("cpu")
    outs = registry.get("batch_norm").lower(ctx, ins, attrs)
    gins = dict(ins, **outs)
    gins["Y@GRAD"] = [dy]
    gattrs = dict(attrs, **{registry.FWD_IN_SLOTS_ATTR: list(ins),
                            registry.FWD_OUT_SLOTS_ATTR: list(outs)})
    generic = registry._make_generic_grad(registry.get("batch_norm"))(ctx, gins, gattrs)
    writes = {"Scale@GRAD": ["s@GRAD"], "Bias@GRAD": ["b@GRAD"]}
    writes["X@GRAD"] = [registry.EMPTY_VAR_NAME if skip_x else "x@GRAD"]
    ctx.op = _GradOp(writes)
    explicit = registry.get("batch_norm_grad").lower(ctx, gins, gattrs)
    assert ("X@GRAD" in explicit) == (not skip_x)
    for slot in explicit:
        got, want = explicit[slot][0].numpy(), generic[slot][0].numpy()
        np.testing.assert_allclose(got, want, rtol=BN_GRAD_RTOL,
                                   atol=BN_GRAD_ATOL * float(np.abs(want).max()),
                                   err_msg="%s %s" % (case, slot))


def test_batch_norm_trains_through_the_explicit_grad():
    """append_backward emits batch_norm_grad, which lowers through the
    explicit lowering (no vjp replay of the forward)."""
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[3, 4, 4], dtype="float32")
        y = pt.layers.batch_norm(pt.layers.conv2d(x, 4, 3), act="relu")
        pt.append_backward(pt.layers.mean(y))
    grads = [op for op in main.global_block().ops if op.type == "batch_norm_grad"]
    assert len(grads) == 1
    assert registry.get("batch_norm_grad").lower is not None
    assert registry.get("batch_norm_grad").lower.__name__ == "_batch_norm_grad"


@pytest.mark.parametrize("case", ["train_nchw", "test_nchw", "train_nhwc"])
def test_batch_norm_grad_matches_jax_grad(case):
    """The explicit grad (through a program's append_backward) against the
    JAX package's jax.vjp grad, at the grad bars: x, scale and bias
    grads."""
    extra, shape, layout = BN_CASES[case]
    c = shape[1] if layout == "NCHW" else shape[-1]
    rng = np.random.RandomState(28)
    x = (rng.randn(*shape) * 2 + 1).astype("float32")
    dy = rng.randn(*shape).astype("float32")
    state = {"bn_scale": rng.rand(c).astype("float32") + 0.5,
             "bn_bias": rng.randn(c).astype("float32"),
             "bn_mean": rng.randn(c).astype("float32"),
             "bn_var": rng.rand(c).astype("float32") + 0.5}

    def build(pkg, helper_cls):
        L = pkg.layers
        xv = L.data(name="x", shape=list(shape), dtype="float32", append_batch_size=False,
                    stop_gradient=False)
        dyv = L.data(name="dy", shape=list(shape), dtype="float32", append_batch_size=False)
        y = L.batch_norm(xv, data_layout=layout, param_attr=pkg.ParamAttr(name="bn_scale"),
                         bias_attr=pkg.ParamAttr(name="bn_bias"), moving_mean_name="bn_mean",
                         moving_variance_name="bn_var", **extra)
        pkg.append_backward(L.mean(L.elementwise_mul(y, dyv)))
        assert any(op.type == "batch_norm_grad"
                   for op in pkg.default_main_program().global_block().ops)
        return ["x@GRAD", "bn_scale@GRAD", "bn_bias@GRAD"]

    (j, _), (p, _) = _both(build, {"x": x, "dy": dy}, state=state)
    for g, w, what in zip(p[0], j[0], ("x", "scale", "bias")):
        _close_grad(g, w, "%s %s grad" % (case, what))
