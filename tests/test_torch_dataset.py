"""The port's dataset package against the JAX package's: every dataset
module (paddle_tpu_torch/dataset, thirteen datasets and common) yields the
JAX module's stream element for element from the same seeds — its reader
creators, dictionaries and metadata — and the same local-cache plumbing."""

import importlib
import itertools

import numpy as np
import pytest

LIMIT = 4096  # elements compared of a stream (the synthetic streams are shorter but mnist's)


def _same(a, b, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a, key=repr) == sorted(b, key=repr), where
        for k in a:
            _same(a[k], b[k], "%s[%r]" % (where, k))
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, "%s[%d]" % (where, i))
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (where, a, b)


def _stream(fn):
    return list(itertools.islice(fn()(), LIMIT))


# (module, what to compare: a callable of the module giving a value or a
# reader creator's stream)
CASES = {
    "cifar": [lambda m: _stream(m.train10), lambda m: _stream(m.test10),
              lambda m: _stream(m.train100), lambda m: _stream(m.test100)],
    "mnist": [lambda m: _stream(m.train), lambda m: _stream(m.test)],
    "conll05": [lambda m: m.get_dict(), lambda m: m.get_embedding(), lambda m: _stream(m.test)],
    "flowers": [lambda m: list(itertools.islice(m.train()(), 24)), lambda m: _stream(m.test),
                lambda m: _stream(m.valid)],
    "imdb": [lambda m: m.word_dict(), lambda m: _stream(m.train), lambda m: _stream(m.test)],
    "imikolov": [lambda m: m.build_dict(),
                 lambda m: _stream(lambda: m.train(m.build_dict(), 5)),
                 lambda m: _stream(lambda: m.test(m.build_dict(), 5)),
                 lambda m: _stream(lambda: m.train(m.build_dict(), 5, m.DataType.SEQ))],
    "movielens": [lambda m: (m.max_user_id(), m.max_movie_id(), m.max_job_id()),
                  lambda m: m.movie_categories(),
                  lambda m: sorted((k, repr(vars(v)) if hasattr(v, "__dict__") else repr(v))
                                   for k, v in m.movie_info().items()),
                  lambda m: sorted((k, repr(vars(v)) if hasattr(v, "__dict__") else repr(v))
                                   for k, v in m.user_info().items()),
                  lambda m: _stream(m.train), lambda m: _stream(m.test)],
    "mq2007": [lambda m: _stream(m.train), lambda m: _stream(m.test),
               lambda m: _stream(lambda: m.train(format="listwise")),
               lambda m: _stream(lambda: m.train(format="pointwise"))],
    "sentiment": [lambda m: m.get_word_dict(), lambda m: _stream(m.train),
                  lambda m: _stream(m.test)],
    "uci_housing": [lambda m: _stream(m.train), lambda m: _stream(m.test)],
    "voc2012": [lambda m: list(itertools.islice(m.train()(), 24)), lambda m: _stream(m.test),
                lambda m: _stream(m.val)],
    "wmt14": [lambda m: m.get_dict(1000), lambda m: m.get_dict(1000, reverse=True),
              lambda m: _stream(lambda: m.train(1000)), lambda m: _stream(lambda: m.test(1000))],
    "wmt16": [lambda m: m.get_dict("en", 1000), lambda m: m.get_dict("de", 800, reverse=True),
              lambda m: _stream(lambda: m.train(1000, 800)),
              lambda m: _stream(lambda: m.test(1000, 800, src_lang="de")),
              lambda m: _stream(lambda: m.validation(1000, 800))],
    "common": [lambda m: m.DATA_HOME, lambda m: m.local_path("a", "b"),
               lambda m: m.have_local("no_such_dataset"),
               lambda m: m.synthetic_rng("tag").randint(0, 1 << 30, 16)],
}


def test_the_port_has_every_dataset_module():
    import paddle_tpu.dataset as jd
    import paddle_tpu_torch.dataset as pd

    assert sorted(pd.__all__) == sorted(jd.__all__) == sorted(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_dataset_streams_equal_the_jax_package(name):
    ref = importlib.import_module("paddle_tpu.dataset." + name)
    port = importlib.import_module("paddle_tpu_torch.dataset." + name)
    assert sorted(getattr(port, "__all__", [])) == sorted(getattr(ref, "__all__", []))
    for i, case in enumerate(CASES[name]):
        _same(case(port), case(ref), "%s case %d" % (name, i))
