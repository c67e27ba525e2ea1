"""The program tools of the port (paddle_tpu_torch.debugger,
contrib.memory_usage_calc and contrib.op_frequence) against the JAX
package, on the CPU: each program is built in both packages under the same
name guard, and pprint_program_codes (backward hidden and shown),
draw_block_graphviz (plain with a highlighted var, with a {op: ms} cost map
and with an op_profile record, each package's op_display_name naming the
ops), memory_usage and op_freq_statistic give the same text and the same
numbers in both. The programs: tests/test_debugger.py's While loop and
SGD-trained regression, tests/test_aux_frontend.py's debugger, memory-usage
and op-frequency programs, and the zoo's VGG-16, GoogLeNet and SE-ResNeXt-50
(tests/torch_zoo_cases.py's small inputs). The tools' own gates of those
tests are held on the port's output.
"""

import functools
import importlib
import re

import jax
import pytest

import paddle_tpu
import paddle_tpu.fluid as jfluid
import paddle_tpu_torch
import paddle_tpu_torch.fluid as fluid

import torch_zoo_cases as zoo

jax.config.update("jax_platforms", "cpu")

PACKAGES = (paddle_tpu, paddle_tpu_torch)


def _while(fl):
    i = fl.layers.fill_constant(shape=[1], dtype="int64", value=0)
    n = fl.layers.fill_constant(shape=[1], dtype="int64", value=4)
    acc = fl.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    cond = fl.layers.less_than(i, n)
    w = fl.layers.While(cond)
    with w.block():
        acc2 = fl.layers.elementwise_add(acc, fl.layers.fill_constant([1], "float32", 2.0))
        fl.layers.assign(acc2, acc)
        fl.layers.increment(i, value=1, in_place=True)
        fl.layers.less_than(i, n, cond=cond)


def _train(fl):
    x = fl.layers.data(name="x", shape=[4], dtype="float32")
    y = fl.layers.data(name="y", shape=[1], dtype="float32")
    p = fl.layers.fc(x, size=1)
    loss = fl.layers.mean(fl.layers.square_error_cost(input=p, label=y))
    fl.optimizer.SGD(learning_rate=0.1).minimize(loss)


def _debugger_print(fl):
    x = fl.layers.data(name="dx", shape=[4], dtype="float32")
    y = fl.layers.fc(input=x, size=3, act="relu")
    fl.optimizer.SGD(learning_rate=0.1).minimize(fl.layers.mean(y))


def _memory_usage(fl):
    x = fl.layers.data(name="mu_x", shape=[10], dtype="float32")
    fl.layers.fc(input=x, size=5)


def _op_freq(fl):
    x = fl.layers.data(name="ofx", shape=[4], dtype="float32")
    h = fl.layers.fc(x, size=3, act="relu")
    y = fl.layers.fc(h, size=2, act="relu")
    fl.layers.mean(y)


def _zoo(name):
    def build(fl):
        mods = importlib.import_module(fl.__name__.split(".")[0] + ".models")
        side, fn = zoo.MODELS[name]
        img = fl.layers.data(name="img", shape=[3, side, side], dtype="float32")
        label = fl.layers.data(name="label", shape=[1], dtype="int64")
        loss = fn(mods, img, label)[0]
        fl.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return build


PROGRAMS = {
    "while": _while, "train": _train, "debugger_print": _debugger_print,
    "memory_usage": _memory_usage, "op_freq": _op_freq,
    "vgg16": _zoo("vgg16"), "googlenet": _zoo("googlenet"),
    "se_resnext50": _zoo("se_resnext50"),
}


@functools.lru_cache(maxsize=None)
def _both(name):
    """{package: main program} of PROGRAMS[name], built in each package
    (once: the tools only read a program)."""
    out = {}
    for pkg in PACKAGES:
        fl = jfluid if pkg is paddle_tpu else fluid
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            PROGRAMS[name](fl)
        out[pkg] = main
    return out


def _tools(pkg):
    base = pkg.__name__
    return (importlib.import_module(base + ".debugger"),
            importlib.import_module(base + ".contrib"),
            importlib.import_module(base + ".observability.opprof"))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_pprint_matches_jax(name):
    progs = _both(name)
    texts = {}
    for pkg, main in progs.items():
        dbg = _tools(pkg)[0]
        texts[pkg] = (dbg.pprint_program_codes(main),
                      dbg.pprint_program_codes(main, show_backward=True))
    assert texts[paddle_tpu_torch] == texts[paddle_tpu]
    shown, full = texts[paddle_tpu_torch]
    main = progs[paddle_tpu_torch]
    for i in range(main.num_blocks):
        assert "block_%d {" % i in full
    assert re.search(r"var \S+\[\S+,\S+\]", full)
    if name == "while":
        assert main.num_blocks >= 2 and "while(" in full and "increment(" in full
    else:
        has_grad = any(op.type.endswith("_grad") for op in main.global_block().ops)
        assert ("_grad(" in full) == has_grad and "_grad(" not in shown


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_graphviz_matches_jax(name, tmp_path):
    dots = {}
    for pkg, main in _both(name).items():
        dbg, _, opprof = _tools(pkg)
        block = main.global_block()
        hot = block.ops[0].output_arg_names[0]
        plain = dbg.draw_block_graphviz(block, highlights=[hot],
                                        path=str(tmp_path / ("%s_plain.dot" % pkg.__name__)))
        assert open(str(tmp_path / ("%s_plain.dot" % pkg.__name__))).read() == plain
        # a cost a distinct op instance, and a type-level cost
        costs = {opprof.op_display_name(op): 0.5 * (i + 1) for i, op in enumerate(block.ops)
                 if i % 3 == 0}
        costs[block.ops[-1].type] = 0.25
        mapped = dbg.draw_block_graphviz(block, path=str(tmp_path / "m.dot"), costs=costs)
        record = {"kind": "op_profile",
                  "ops": [{"op": k, "total_ms": v, "count": 1} for k, v in costs.items()]
                  + [{"op": "no_such_op:zzz", "total_ms": 9.0, "count": 1}]}
        recorded = dbg.draw_block_graphviz(block, path=str(tmp_path / "r.dot"), costs=record)
        dots[pkg] = (plain, mapped, recorded)
    assert dots[paddle_tpu_torch] == dots[paddle_tpu]
    plain, mapped, recorded = dots[paddle_tpu_torch]
    assert plain.startswith("digraph G {") and plain.rstrip().endswith("}")
    assert "#d2e5ff" in plain and "(ms" not in plain and 'fillcolor="#ffd2d2"' in plain
    assert " ms)" in mapped and "#ff8466" in mapped  # the hottest op is red
    assert "no_such_op" not in recorded


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_memory_usage_and_op_freq_match_jax(name):
    got = {}
    for pkg, main in _both(name).items():
        contrib = _tools(pkg)[1]
        got[pkg] = ([contrib.memory_usage(main, batch_size=b) for b in (1, 32)],
                    [list(d.items()) for d in contrib.op_freq_statistic(main)])
    assert got[paddle_tpu_torch] == got[paddle_tpu]
    (mem1, mem32), (uni, adj) = got[paddle_tpu_torch]
    assert 0 < mem1 <= mem32
    if name == "memory_usage":
        assert mem32 >= 32 * 10 * 4 + 10 * 5 * 4 + 32 * 5 * 4
    if name == "op_freq":
        assert dict(uni)["mul"] == 2 and dict(uni)["relu"] == 2 and dict(uni)["mean"] == 1
        assert dict(adj).get("relu,mul") == 1
    assert [n for _, n in uni] == sorted((n for _, n in uni), reverse=True)


def test_contrib_tools_reject_what_the_jax_ones_reject():
    main = _both("memory_usage")[paddle_tpu_torch]
    with pytest.raises(ValueError):
        fluid.contrib.memory_usage(main, batch_size=0)
    with pytest.raises(TypeError):
        fluid.contrib.op_freq_statistic("not a program")
    assert fluid.debugger.pprint_program_codes is paddle_tpu_torch.debugger.pprint_program_codes
