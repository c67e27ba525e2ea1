"""Package rules of the torch port: paddle_tpu_torch and chip_smoke.py
import neither jax nor paddle_tpu (an AST walk of every source file), and
the entry points take the card by default, raising on a box without CUDA
instead of carrying on on the CPU."""

import ast
import os

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import AsyncExecutor, CPUPlace, Executor, Scope
from paddle_tpu_torch.data import DataRuntime
from paddle_tpu_torch.models import GPTDecoder
from paddle_tpu_torch.py_reader import PyReader
from paddle_tpu_torch.serving import GenerationEngine, ServingEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(open(path).read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, "%s imports %s" % (path, bad)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a box without CUDA")


@pytest.mark.parametrize(
    "entry",
    [
        # a scope made without a place binds no device until an executor
        # runs on it; asked for its device first, it takes the card
        lambda: Scope().device,
        lambda: Executor(),
        lambda: GenerationEngine(GPTDecoder(vocab_size=8, n_layer=1, n_head=1, d_model=4,
                                            d_inner=8, max_context=8)),
        lambda: GenerationEngine(GPTDecoder(vocab_size=8, n_layer=1, n_head=1, d_model=4,
                                            d_inner=8, max_context=8, kv_dtype="int8")),
        # the card is taken before the model directory is read
        lambda: ServingEngine("no_model_dir"),
        lambda: AsyncExecutor(),
        lambda: PyReader(["x"]),
        lambda: DataRuntime(lambda shard: iter(()), num_shards=1),
    ],
    ids=["Scope", "Executor", "GenerationEngine", "GenerationEngine_int8", "ServingEngine",
         "AsyncExecutor", "PyReader", "DataRuntime"],
)
def test_entry_points_without_place_raise_without_cuda(no_cuda, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_explicit_cpu_place_runs():
    eng = GenerationEngine(
        GPTDecoder(vocab_size=8, n_layer=1, n_head=1, d_model=4, d_inner=8, max_context=8),
        name="tp_cpu", place=CPUPlace(), max_slots=1, page_size=4,
    )
    assert eng.device == torch.device("cpu")
    assert eng.generate([1, 2, 3], max_new_tokens=2).finish_reason in ("eos", "length")


def test_cache_dir_raises(tmp_path):
    """The engines take a compile-cache directory; a cache_dir that cannot
    be a directory (an existing file) raises at construction."""
    model = GPTDecoder(vocab_size=8, n_layer=1, n_head=1, d_model=4, d_inner=8, max_context=8)
    eng = GenerationEngine(model, place=CPUPlace(), cache_dir=str(tmp_path / "cache"))
    assert eng.cache is not None and eng.stats()["cache_hits"] == 0
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    with pytest.raises(OSError):
        GenerationEngine(model, place=CPUPlace(), cache_dir=str(blocker))
