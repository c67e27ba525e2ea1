"""The static analysis of the torch port (paddle_tpu_torch/analysis/:
dataflow.py's liveness and sub-block walk, checkers.py, verify.py) and its
gate (FLAGS_static_verify at Executor.run, aot_serve_lowering, the serving
engines' load and the pass manager's stage 0; FLAGS_pass_debug_dir's
dumps) against the JAX package.

Every program of tests/test_fluidlint.py and tests/test_analysis.py (the
seeded defect of each checker, the control-flow programs, the liveness
program, and the zoo models the CLI lints) is built in both packages from
the same build function and linted by both: the findings are equal as (check,
severity, block, op index, var) lists, exactly.
"""

import importlib
import json
import os

import numpy as np
import pytest

from paddle_tpu import flags as jflags
from paddle_tpu.analysis import lint_program as jlint
from paddle_tpu.analysis import verify as jverify
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu.parallel import ShardingRules
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch.analysis import StaticVerifyError, analyze_program, lint_program
from paddle_tpu_torch.analysis import maybe_static_verify
from paddle_tpu_torch.analysis import verify as pverify
from paddle_tpu_torch.executor import Scope as PScope
from paddle_tpu_torch.executor import aot_serve_lowering
from paddle_tpu_torch.executor import scope_guard as pscope_guard

JAX, PORT = "paddle_tpu", "paddle_tpu_torch"


@pytest.fixture(autouse=True)
def _gate_reset():
    """The gates memoize per program uid: isolate every test, flags off."""
    for mod, fl in ((jverify, jflags), (pverify, pflags)):
        mod._VERIFIED.clear()
        fl.set_flags({"static_verify": False, "pass_debug_dir": ""})
    yield
    for mod, fl in ((jverify, jflags), (pverify, pflags)):
        mod._VERIFIED.clear()
        fl.set_flags({"static_verify": False, "pass_debug_dir": ""})


def _fluid(pkg):
    return importlib.import_module(pkg + ".fluid")


def _fresh(pkg):
    fw = importlib.import_module(pkg + ".framework")
    return fw.Program(), fw.Program()


class _guard:
    """unique_name.guard + program_guard: both packages name alike."""

    def __init__(self, fluid, main, startup):
        self._u = fluid.unique_name.guard()
        self._p = fluid.program_guard(main, startup)

    def __enter__(self):
        self._u.__enter__()
        self._p.__enter__()

    def __exit__(self, *exc):
        self._p.__exit__(*exc)
        self._u.__exit__(*exc)


def _key(findings):
    return [(f.check, f.severity, f.block_idx, f.op_index, f.var) for f in findings]


# ---------------------------------------------------------------------------
# programs: (main, feed_names, fetch_names, lint kwargs) in either package
# ---------------------------------------------------------------------------


def prog_dead_write(pkg):
    fluid = _fluid(pkg)
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        a = fluid.layers.fill_constant(shape=[2, 2], dtype="float32", value=1.0)
        b = fluid.layers.fill_constant(shape=[2, 2], dtype="float32", value=2.0)
        v = fluid.layers.fill_constant(shape=[2, 2], dtype="float32", value=0.0)
        fluid.layers.assign(a, output=v)
        fluid.layers.assign(b, output=v)
    return main, [], [v.name], {}


def prog_write_never_read(pkg):
    fluid = _fluid(pkg)
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        fluid.layers.relu(x)
        loss = fluid.layers.mean(x)
    return main, ["x"], [loss.name], {}


def prog_dtype_boundary(pkg):
    fluid = _fluid(pkg)
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        lo = fluid.layers.cast(x, "bfloat16")
        mixed = fluid.layers.elementwise_add(lo, x)
    return main, ["x"], [mixed.name], {}


def _dropout_net(pkg):
    fluid = _fluid(pkg)
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        d = fluid.layers.dropout(x, dropout_prob=0.5)
        loss = fluid.layers.mean(d)
    return main, loss


def prog_determinism_training(pkg):
    main, loss = _dropout_net(pkg)
    return main, ["x"], [loss.name], {}


def prog_determinism_inference(pkg):
    main, loss = _dropout_net(pkg)
    return main, ["x"], [loss.name], {"mode": "inference"}


def prog_fetch_unwritten(pkg):
    fluid = _fluid(pkg)
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        loss = fluid.layers.mean(x)
    return main, ["x"], [loss.name, "no_such_var"], {}


def prog_sharding_rules(pkg):
    fluid = _fluid(pkg)
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(x, size=4)
    rules = [(r"^fc_0\.w_0$", ("tp", "fsdp", "ep")), (r"^nomatch_xyz$", ("tp",))]
    # the JAX package binds a ShardingRules object; the port reads the pairs
    main._sharding_rules = ShardingRules(rules) if pkg == JAX else rules
    return main, ["x"], [h.name], {}


def _build_while(pkg, defect=False):
    fluid = _fluid(pkg)
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = fluid.layers.fill_constant(shape=[1], dtype="int64", value=4)
        acc = fluid.layers.fill_constant(shape=[2], dtype="float32", value=0.0)
        cond = fluid.layers.less_than(i, n)
        w = fluid.layers.While(cond)
        with w.block():
            a2 = fluid.layers.elementwise_add(acc, fluid.layers.fill_constant([2], "float32", 1.0))
            fluid.layers.assign(a2, acc)
            fluid.layers.increment(i, value=1, in_place=True)
            fluid.layers.less_than(i, n, cond=cond)
    if defect:
        wop = next(op for op in main.global_block().ops if op.type == "while")
        wop.inputs["X"].remove(n.name)
        wop.attrs["x_names"] = [x for x in wop.attrs["x_names"] if x != n.name]
    return main, n.name, acc.name


def prog_cf_capture(pkg):
    main, _, acc = _build_while(pkg, defect=True)
    return main, [], [acc], {}


def prog_while_clean(pkg):
    main, _, acc = _build_while(pkg)
    return main, [], [acc], {}


def prog_while_unstable_carry(pkg):
    fluid = _fluid(pkg)
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = fluid.layers.fill_constant(shape=[1], dtype="int64", value=4)
        acc = fluid.layers.fill_constant(shape=[2], dtype="float32", value=0.0)
        cond = fluid.layers.less_than(i, n)
        w = fluid.layers.While(cond)
        with w.block():
            grown = fluid.layers.concat([acc, acc], axis=0)
            fluid.layers.assign(grown, acc)
            fluid.layers.increment(i, value=1, in_place=True)
            fluid.layers.less_than(i, n, cond=cond)
    return main, [], [acc.name], {}


def prog_switch(pkg):
    fluid = _fluid(pkg)
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        step = fluid.layers.fill_constant(shape=[1], dtype="int64", value=7)
        lr = fluid.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        b1 = fluid.layers.fill_constant(shape=[1], dtype="int64", value=5)
        sw = fluid.layers.Switch()
        with sw.case(fluid.layers.less_than(step, b1)):
            fluid.layers.assign(fluid.layers.fill_constant([1], "float32", 1.0), lr)
        with sw.default():
            fluid.layers.assign(fluid.layers.fill_constant([1], "float32", 0.01), lr)
    return main, [], [lr.name], {}


def prog_tensor_array(pkg):
    fluid = _fluid(pkg)
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        x = fluid.layers.fill_constant(shape=[2, 3], dtype="float32", value=1.0)
        i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        arr = fluid.layers.array_write(x, i)
        y = fluid.layers.array_read(arr, i)
        n = fluid.layers.array_length(arr)
    return main, [], [y.name, n.name], {}


def prog_fc_softmax(pkg):
    fluid = _fluid(pkg)
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(x, size=4, act="relu")
        s = fluid.layers.softmax(h)
        loss = fluid.layers.mean(s)
    return main, ["x"], [h.name, s.name, loss.name], {}


def prog_sgd_net(pkg):
    fluid = _fluid(pkg)
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(x, size=4, act="relu")
        loss = fluid.layers.mean(h)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, ["x"], [loss.name], {}


# the zoo of tools/fluidlint.py the port has models for, at its sizes
def _cv(pkg, fn, shape, minimize=False, **kw):
    fluid = _fluid(pkg)
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        img = fluid.layers.data(name="img", shape=shape, dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc = fn(img, label, **kw)[:2]
        if minimize:
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, ["img", "label"], [loss.name, acc.name], {}


def zoo_lenet(pkg):
    return _cv(pkg, importlib.import_module(pkg + ".models").lenet5, [1, 28, 28], minimize=True)


def zoo_resnet_cifar10(pkg):
    mod = importlib.import_module(pkg + ".models.resnet")
    return _cv(pkg, mod.resnet_cifar10, [3, 32, 32], depth=20)


def zoo_transformer(pkg):
    fluid = _fluid(pkg)
    mod = importlib.import_module(pkg + ".models.transformer")
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        feeds, loss = mod.build_tiny_flash_transformer()
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, sorted(feeds), [loss.name], {}


def zoo_deepfm(pkg):
    fluid = _fluid(pkg)
    mod = importlib.import_module(pkg + ".models.deepfm")
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        ids = fluid.layers.data(name="ids", shape=[4, 1], dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        loss, pred, _ = mod.deepfm(ids, label, num_features=1000, num_fields=4)
        fluid.optimizer.Adam(learning_rate=5e-3).minimize(loss)
    return main, ["ids", "label"], [loss.name, pred.name], {}


def zoo_stacked_lstm(pkg):
    fluid = _fluid(pkg)
    mod = importlib.import_module(pkg + ".models.stacked_lstm")
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        words = fluid.layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc, _ = mod.stacked_lstm_net(words, label, dict_dim=200, emb_dim=16, hid_dim=16,
                                            stacked_num=2)
    return main, ["words", "label"], [loss.name, acc.name], {}


def _nmt_src(fluid, main, B, T):
    src = fluid.layers.data(name="src", shape=[B, T, 1], dtype="int64",
                            append_batch_size=False)
    main.global_block().create_var(name="src_len", shape=(B,), dtype="int64")
    src._len_name = "src_len"
    return src


def zoo_machine_translation(pkg):
    fluid = _fluid(pkg)
    mt = importlib.import_module(pkg + ".models.machine_translation")
    B, T, VOCAB = 4, 6, 50
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        src = _nmt_src(fluid, main, B, T)
        trg = fluid.layers.data(name="trg", shape=[B, T + 1, 1], dtype="int64",
                                append_batch_size=False)
        lab = fluid.layers.data(name="lab", shape=[B, T + 1, 1], dtype="int64",
                                append_batch_size=False)
        trg_len = fluid.layers.data(name="trg_len", shape=[B], dtype="int64",
                                    append_batch_size=False)
        loss = mt.train_model(src, trg, lab, trg_len, VOCAB)
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return main, ["src", "src_len", "trg", "lab", "trg_len"], [loss.name], {}


def zoo_machine_translation_infer(pkg):
    fluid = _fluid(pkg)
    mt = importlib.import_module(pkg + ".models.machine_translation")
    main, startup = _fresh(pkg)
    with _guard(fluid, main, startup):
        ids, scores = mt.infer_model(_nmt_src(fluid, main, 4, 6), 50)
    return main, ["src", "src_len"], [ids.name, scores.name], {}


def _gpt(pkg):
    mod = importlib.import_module(pkg + ".models.gpt_decoder")
    return mod.GPTDecoder(vocab_size=64, n_layer=2, n_head=2, d_model=32, max_context=32)


def zoo_gpt_forward(pkg):
    main, _, feeds, fetches = _gpt(pkg).build_forward(2, 8)
    return main, feeds, fetches, {}


def zoo_gpt_prefill(pkg):
    main, _, feeds, fetches = _gpt(pkg).build_prefill(8, 4, 8, 32)
    return main, feeds, fetches, {"mode": "serving"}


def zoo_gpt_decode(pkg):
    main, _, feeds, fetches = _gpt(pkg).build_decode(4, 4, 8, 32)
    return main, feeds, fetches, {"mode": "serving"}


SEEDED = {
    "dead_write": ("dead-write", prog_dead_write),
    "write_never_read": ("write-never-read", prog_write_never_read),
    "dtype_boundary": ("dtype-boundary", prog_dtype_boundary),
    "determinism_inference": ("determinism", prog_determinism_inference),
    "fetch_unwritten": ("fetch-unwritten", prog_fetch_unwritten),
    "sharding_rules": ("sharding-rules", prog_sharding_rules),
    "cf_capture": ("cf-capture", prog_cf_capture),
}
CLEAN = {
    "determinism_training": prog_determinism_training,
    "while_clean": prog_while_clean,
    "while_unstable_carry": prog_while_unstable_carry,
    "switch": prog_switch,
    "tensor_array": prog_tensor_array,
    "fc_softmax": prog_fc_softmax,
    "sgd_net": prog_sgd_net,
}
ZOO = {
    "lenet": zoo_lenet,
    "resnet_cifar10": zoo_resnet_cifar10,
    "transformer": zoo_transformer,
    "deepfm": zoo_deepfm,
    "stacked_lstm": zoo_stacked_lstm,
    "machine_translation": zoo_machine_translation,
    "machine_translation_infer": zoo_machine_translation_infer,
    "gpt_forward": zoo_gpt_forward,
    "gpt_prefill": zoo_gpt_prefill,
    "gpt_decode": zoo_gpt_decode,
}


def _lint_both(build):
    jmain, jfeeds, jfetches, kw = build(JAX)
    pmain, pfeeds, pfetches, pkw = build(PORT)
    assert (jfeeds, jfetches) == (pfeeds, pfetches)
    _, jf = jlint(jmain, jfeeds, jfetches, **kw)
    analysis, pf = lint_program(pmain, pfeeds, pfetches, **pkw)
    assert _key(pf) == _key(jf), "\n".join(["port:"] + [f.format() for f in pf]
                                           + ["jax:"] + [f.format() for f in jf])
    assert [f.message for f in pf] == [f.message for f in jf]
    return analysis, pf


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_defect_findings_equal_jax(name):
    check, build = SEEDED[name]
    _, findings = _lint_both(build)
    assert any(f.check == check for f in findings), findings


@pytest.mark.parametrize("name", sorted(CLEAN))
def test_analysis_programs_findings_equal_jax(name):
    analysis, findings = _lint_both(CLEAN[name])
    assert analysis.mode in ("training", "inference")
    # the sub-block walk records the loops' and switch's inner ops
    if name.startswith(("while", "switch")):
        assert {r.block_idx for r in analysis.records} != {0}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_findings_equal_jax(name):
    analysis, findings = _lint_both(ZOO[name])
    assert findings == []
    assert len(analysis.records) > 10


def test_seeded_donation_alias_equal_jax():
    """A corrupted donation plan donating read-only state: the same finding
    from the scope each package's startup program filled."""
    out = {}
    for pkg in (JAX, PORT):
        fluid = _fluid(pkg)
        main, startup = _fresh(pkg)
        with _guard(fluid, main, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            w = fluid.layers.create_parameter([4, 3], "float32", name="W")
            loss = fluid.layers.mean(fluid.layers.mul(x, w))
        if pkg == JAX:
            scope, guard, exe = JScope(seed=0), jscope_guard, fluid.Executor()
        else:
            scope, guard = PScope(place=CPUPlace()), pscope_guard
            exe = fluid.Executor(CPUPlace())
        with guard(scope):
            exe.run(startup)
        main._donation_plan = {"feed": ["x"], "fetch": [loss.name], "mut": ["W"], "ro": [],
                               "unknown": (), "scope_uid": scope._uid}
        lint = jlint if pkg == JAX else lint_program
        out[pkg] = lint(main, ["x"], [loss.name], scope=scope)[1]
    assert _key(out[PORT]) == _key(out[JAX])
    (f,) = [f for f in out[PORT] if f.check == "donation-alias"]
    assert f.var == "W" and "use-after-donate" in f.message


def test_live_after_and_feed_facts():
    """Backward liveness kills a rebound fetch (tests/test_analysis.py), and
    concrete feed facts override the declared batch symbol."""
    main, _, fetches, _ = prog_dead_write(PORT)
    live = analyze_program(main, [], fetches).live_after(0)
    v = fetches[0]
    assert v not in live[2] and v not in live[3] and v in live[4]
    from paddle_tpu_torch.analysis import VarFact

    main, feeds, fetches, _ = prog_fc_softmax(PORT)
    a = analyze_program(main, feeds, fetches,
                        feed_facts={"x": VarFact(shape=(3, 8), dtype="float32")})
    assert a.facts[fetches[0]].concrete_shape() == (3, 4)
    assert a.mesh is None and a.resolver is None
    # with a mesh the rules bind into a Resolver, and each fact carries its
    # layout: the fc weight (8, 4) split over tp on its columns, a
    # non-dividing rule degraded with a warning from the checker
    from paddle_tpu_torch.analysis import run_checkers
    from paddle_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh({"dp": 1, "fsdp": 1, "tp": 2, "sp": 1, "ep": 1, "pp": 3}, {}, {}, "cpu")
    w = [p.name for p in main.global_block().all_parameters() if len(p.shape) == 2][0]
    a = analyze_program(main, feeds, fetches, mesh=mesh,
                        rules=[("^%s$" % w.replace(".", r"\."), (None, "tp"))])
    assert a.mesh is mesh and a.resolver is not None
    assert a.facts[w].spec == (None, "tp")
    a = analyze_program(main, feeds, fetches, mesh=mesh,
                        rules=[("^%s$" % w.replace(".", r"\."), ("pp", None))])
    assert a.facts[w].spec is None
    assert [f for f in run_checkers(a, checks=["sharding-rules"])
            if "not divisible" in f.message]


# ---------------------------------------------------------------------------
# the FLAGS_static_verify gate
# ---------------------------------------------------------------------------


def _run_sgd(verify_on):
    import paddle_tpu_torch.fluid as fluid

    pflags.set_flags({"static_verify": verify_on})
    pmain, pstartup = _fresh(PORT)
    with _guard(fluid, pmain, pstartup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(x, size=4, act="relu")
        loss = fluid.layers.mean(h)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    xv = np.random.RandomState(0).randn(6, 8).astype("float32")
    with pscope_guard(PScope(seed=7, place=CPUPlace())):
        exe = fluid.Executor(CPUPlace())
        exe.run(pstartup)
        return [exe.run(pmain, feed={"x": xv}, fetch_list=[loss.name])[0] for _ in range(3)]


def test_executor_gate_is_bit_transparent_and_free_when_off():
    off = _run_sgd(False)
    assert not pverify._VERIFIED, "the gate ran with the flag off"
    on = _run_sgd(True)
    assert pverify._VERIFIED, "the gate never ran with the flag on"
    n = len(pverify._VERIFIED)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    assert len(pverify._VERIFIED) == n  # later runs: memo hits


def test_gate_off_is_free_on_a_defective_program():
    main, _, acc = _build_while(PORT, defect=True)
    assert maybe_static_verify(main, [], [acc]) is None
    assert not pverify._VERIFIED


def test_executor_gate_raises_on_a_defective_program():
    import paddle_tpu_torch.fluid as fluid

    pflags.set_flags({"static_verify": True})
    main, n_name, acc = _build_while(PORT, defect=True)
    with pscope_guard(PScope(place=CPUPlace())):
        with pytest.raises(StaticVerifyError) as ei:
            fluid.Executor(CPUPlace()).run(main, feed={}, fetch_list=[acc])
    assert "cf-capture" in str(ei.value) and n_name in str(ei.value)
    assert ei.value.where == "executor" and ei.value.findings


def test_aot_serve_gate_raises_and_passes():
    """aot_serve_lowering: a fetch nothing writes raises StaticVerifyError
    (not the preparation's RuntimeError); the clean serving programs pass
    in serving mode (tests/test_fluidlint.py's gpt check)."""
    pflags.set_flags({"static_verify": True})
    main, feeds, fetches, _ = prog_fetch_unwritten(PORT)
    scope = PScope(place=CPUPlace())
    with pytest.raises(StaticVerifyError, match="fetch-unwritten") as ei:
        aot_serve_lowering(main, feeds, fetches, scope)
    assert ei.value.where == "aot_serve"
    for build in (zoo_gpt_prefill, zoo_gpt_decode):
        program, feeds, fetches, _ = build(PORT)
        assert maybe_static_verify(program, feeds, fetches, mode="serving",
                                   where="test") == []


def test_pass_manager_stage0_raises():
    from paddle_tpu_torch.passes import PassManager

    pflags.set_flags({"static_verify": True})
    main, n_name, acc = _build_while(PORT, defect=True)
    with pytest.raises(StaticVerifyError) as ei:
        PassManager(["dead_op_eliminate"]).apply(main, fetch_names=[acc])
    assert ei.value.where == "pipeline:0" and "cf-capture" in str(ei.value)
    # a clean program passes stage 0 and every pass's re-verification
    main, feeds, fetches, _ = prog_sgd_net(PORT)
    PassManager("inference").apply(main, feed_names=feeds, fetch_names=fetches)


def test_serving_engine_load_raises_on_unwritten_fetch(tmp_path):
    """A saved model whose fetch no op writes is rejected at load, by check
    id, with the flag on (and fails later without it)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.serving import ServingEngine

    main, startup = _fresh(PORT)
    with _guard(fluid, main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.fc(x, size=2)
    md = str(tmp_path / "m")
    with pscope_guard(PScope(place=CPUPlace())):
        exe = fluid.Executor(CPUPlace())
        exe.run(startup)
        fluid.io.save_inference_model(md, ["x"], [y], exe, main_program=main)
    path = os.path.join(md, "__model__")
    doc = json.load(open(path))
    doc["blocks"][0]["vars"].append({"name": "ghost", "shape": [-1, 2], "dtype": "float32"})
    doc["fetch_var_names"].append("ghost")
    json.dump(doc, open(path, "w"))
    with pytest.raises(RuntimeError, match="ghost"):
        ServingEngine(md, place=CPUPlace())
    pflags.set_flags({"static_verify": True})
    with pytest.raises(StaticVerifyError, match="fetch-unwritten") as ei:
        ServingEngine(md, name="ghosted", place=CPUPlace())
    assert ei.value.where == "serving:ghosted"


def test_pass_debug_dir_dump_names_equal_jax(tmp_path):
    """FLAGS_pass_debug_dir: before/after .dot files and an ops diff per
    pass, under the JAX package's file names; the diff names what the pass
    removed."""
    from paddle_tpu.passes import PassManager as JPassManager
    from paddle_tpu_torch.passes import PassManager as PPassManager

    names = {}
    for pkg, fl, pm in ((JAX, jflags, JPassManager), (PORT, pflags, PPassManager)):
        out = str(tmp_path / pkg)
        fl.set_flags({"pass_debug_dir": out})
        main, feeds, fetches, _ = prog_write_never_read(pkg)
        pm("inference").apply(main, feed_names=feeds, fetch_names=fetches)
        names[pkg] = sorted(os.listdir(out))
    assert names[PORT] == names[JAX]
    assert "01_dead_op_eliminate_before.dot" in names[PORT]
    diff = open(str(tmp_path / PORT / "01_dead_op_eliminate_ops.diff")).read()
    assert "-[b0]" in diff and "relu" in diff
    dot = open(str(tmp_path / PORT / "01_dead_op_eliminate_after.dot")).read()
    assert dot.startswith("digraph G {") and "relu" not in dot
