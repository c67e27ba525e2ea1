"""DeepFM and the SelectedRows sparse path of the torch port against the JAX
package, on the CPU, from the same weights (the JAX package's startup state
carried over by name with convert.load_into_scope):

- the tests of tests/test_deepfm.py that need no mesh, each run in both
  packages: training with its convergence gates (200 Adam steps, the last
  5 losses under 0.9x the first 5, AUC above 0.65), sparse against dense
  SGD, the lazy-Adam touched-rows proof and the Adagrad / Momentum routing;
  the port's sparse and dense SGD runs (and the Adagrad and Momentum
  routes) give the same bits, losses and table;
- merge_rows (sentinel slots, all-duplicate rows), the hash op (num_hash 1
  and 3, ids past 2^32 and negative ids, through each package's executor)
  and sigmoid_cross_entropy_with_logits with ignore_index, each against
  the JAX function or op;
- the grad maker's routing: is_sparse=True with one consumer emits
  lookup_table_grad_sparse and the *_sparse optimizer ops, a twice-read
  table the dense grad, in both packages alike.

Tolerances: losses and tables rtol 1e-5 (atol 1e-6 for values near zero)
against the JAX package: the same f32 expressions, their sums taken in
another order by torch's and XLA's CPU kernels; merge_rows' sums in f32
exact (integer-valued inputs); hash bit for bit.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.embedding import selected_rows as jsr
from paddle_tpu_torch.embedding import selected_rows as psr

from torch_rnn_cases import build, check_op, exe_scope, lower_both, run_both

RTOL, ATOL = 1e-5, 1e-6
NUM_FEATURES, NUM_FIELDS = 2000, 6
SH_ROWS, SH_FIELDS, SH_DIM = 512, 4, 8


def _deepfm(fluid):
    pkg = fluid.__name__.split(".")[0]
    return importlib.import_module(pkg + ".models.deepfm").deepfm


def _make_batch(rng, n=64):
    ids = rng.randint(0, NUM_FEATURES, (n, NUM_FIELDS, 1)).astype("int64")
    p = 1.0 / (1.0 + np.exp((ids[:, 0, 0] - NUM_FEATURES / 2) / (NUM_FEATURES / 6)))
    label = (rng.rand(n) < p).astype("float32").reshape(n, 1)
    return {"ids": ids, "label": label}


def _sh_batches(n, batch=32, rows=SH_ROWS, seed=7):
    rng = np.random.RandomState(seed)
    return [{"ids": rng.randint(0, rows, (batch, SH_FIELDS, 1)).astype("int64"),
             "label": (rng.rand(batch, 1) < 0.5).astype("float32")} for _ in range(n)]


def _small(is_sparse, make_opt):
    def program_fn(fluid):
        ids = fluid.layers.data(name="ids", shape=[SH_FIELDS, 1], dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        loss, _, _ = _deepfm(fluid)(
            ids, label, num_features=SH_ROWS, num_fields=SH_FIELDS, embedding_size=SH_DIM,
            layer_sizes=(16,), is_sparse=is_sparse)
        make_opt(fluid).minimize(loss)
        return [loss]

    return program_fn


def _losses(steps):
    return np.array([float(np.asarray(s[0]).reshape(-1)[0]) for s in steps])


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def test_deepfm_trains_and_auc_beats_chance():
    """tests/test_deepfm.py:29 in both packages: 200 Adam steps from the same
    weights, losses close a step, both meet the gates; then the AUC of a
    fresh batch of 512 in the port."""
    rng = np.random.RandomState(0)
    batches = [_make_batch(rng) for _ in range(200)]
    eval_feed = _make_batch(rng, 512)

    def program_fn(fluid):
        ids = fluid.layers.data(name="ids", shape=[NUM_FIELDS, 1], dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        loss, pred, _ = _deepfm(fluid)(ids, label, num_features=NUM_FEATURES,
                                       num_fields=NUM_FIELDS)
        fluid.optimizer.Adam(learning_rate=5e-3).minimize(loss)
        return [loss, pred]

    want, got, names, (jfin, pfin) = run_both(program_fn, batches + [eval_feed], steps=201)
    jl, pl = _losses(want[:200]), _losses(got[:200])
    _close(pl, jl, "losses")
    for n in ("fm_emb", "fm_first"):
        _close(pfin[n], jfin[n], n)
    for losses in (jl, pl):
        assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.9
    p = got[200][1]
    lab = eval_feed["label"][:, 0]
    pos, neg = p[lab == 1, 0], p[lab == 0, 0]
    auc = (pos[:, None] > neg[None, :]).mean()
    assert auc > 0.65, auc


def _sgd(fluid):
    return fluid.optimizer.SGD(learning_rate=0.1)


def _adagrad(fluid):
    return fluid.optimizer.Adagrad(learning_rate=0.05)


def _momentum(fluid):
    return fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9)


# Adagrad's first step moves a weight by lr * g / (|g| + 1e-6): where a
# gradient entry is a near-cancelling sum of about 1e-6, the summation order
# alone changes that ratio by 1e-3 and the weight by up to 5e-5; the other
# optimizers keep the table within ATOL
ADAGRAD_TABLE_ATOL = 5e-5


@pytest.mark.parametrize("make_opt,steps,table_atol",
                         [(_sgd, 5, ATOL), (_adagrad, 3, ADAGRAD_TABLE_ATOL),
                          (_momentum, 3, ATOL)],
                         ids=["sgd", "adagrad", "momentum"])
def test_deepfm_sparse_matches_dense(make_opt, steps, table_atol):
    """tests/test_deepfm.py:99 (SGD) and :271 (Adagrad's per-row update,
    Momentum through selected_rows_to_dense): in the port, sparse against
    dense bit for bit, losses and the table; each against the JAX
    package's run of the same form."""
    batches = _sh_batches(steps)
    runs = {}
    for is_sparse in (False, True):
        want, got, names, (jfin, pfin) = run_both(_small(is_sparse, make_opt), batches,
                                                  steps=steps)
        runs[is_sparse] = (_losses(got), pfin["fm_emb"])
        _close(_losses(got), _losses(want), "losses, is_sparse=%s" % is_sparse)
        for n in names:
            np.testing.assert_allclose(pfin[n], jfin[n], rtol=RTOL, atol=table_atol,
                                       err_msg="%s, is_sparse=%s" % (n, is_sparse))
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    np.testing.assert_array_equal(runs[True][1], runs[False][1])


def test_sparse_adam_updates_only_touched_rows():
    """tests/test_deepfm.py:195 in both packages: after a step that hits rows
    3 and 7 alone, every other row of the table and of both moments keeps
    its bits; the touched rows move; the port's state matches the JAX
    package's after both steps."""
    rng = np.random.RandomState(1)
    feeds = [{"ids": rng.randint(0, 64, (32, 2, 1)).astype("int64")},
             {"ids": np.array([[[3], [7]]] * 4, dtype="int64")}]

    def program_fn(fluid):
        ids = fluid.layers.data(name="ids", shape=[2, 1], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[64, 8], is_sparse=True,
                                     param_attr=fluid.ParamAttr(name="tbl"))
        loss = fluid.layers.mean(emb)
        fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        return [loss]

    _, got1, names, (_, p1) = run_both(program_fn, feeds[:1], steps=1)
    want, got, _, (jfin, pfin) = run_both(program_fn, feeds, steps=2)
    state = ["tbl"] + sorted(n for n in names if n.startswith("tbl_") and p1[n].shape == (64, 8))
    assert len(state) == 3, state
    touched = np.zeros(64, bool)
    touched[[3, 7]] = True
    for n in state:
        np.testing.assert_array_equal(pfin[n][~touched], p1[n][~touched],
                                      err_msg="%s: untouched rows moved" % n)
        _close(pfin[n], jfin[n], n)
    assert not np.array_equal(pfin["tbl"][touched], p1["tbl"][touched])
    _close(_losses(got), _losses(want), "losses")


def test_grad_maker_routing_matches():
    """The sparse grad maker's choices, op for op in both packages: one
    consumer and is_sparse=True gives lookup_table_grad_sparse + adam_sparse
    with the rows var; a table read twice falls back to the dense grad."""

    def program_fn(twice):
        def fn(fluid):
            ids = fluid.layers.data(name="ids", shape=[2, 1], dtype="int64")
            emb = fluid.layers.embedding(ids, size=[64, 8], is_sparse=True,
                                         param_attr=fluid.ParamAttr(name="tbl"))
            loss = fluid.layers.mean(emb)
            if twice:
                emb2 = fluid.layers.embedding(ids, size=[64, 8], is_sparse=True,
                                              param_attr=fluid.ParamAttr(name="tbl"))
                loss = fluid.layers.elementwise_add(loss, fluid.layers.mean(emb2))
            fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
            return [loss]

        return fn

    for twice, want_types in ((False, {"lookup_table_grad_sparse", "adam_sparse"}),
                              (True, {"lookup_table_grad", "adam"})):
        progs = [build(p, program_fn(twice))[0] for p in ("paddle_tpu", "paddle_tpu_torch")]
        ops = [[(op.type, dict(op.inputs), dict(op.outputs)) for op in p.global_block().ops]
               for p in progs]
        assert ops[0] == ops[1]
        types = {t for t, _, _ in ops[1]}
        assert want_types <= types, types
        if not twice:
            g = progs[1].global_block().var("tbl@GRAD")
            assert psr.is_selected_rows(g) and g.selected_rows_rows == "tbl@GRAD@ROWS"
            assert g.selected_rows_height == 64


MERGE_CASES = {
    # sentinels and negative ids among repeats
    "sentinels": np.array([5, -1, 3, 5, 9, -1, 3, 0, -7, 5], np.int32),
    "all_duplicates": np.full(12, 6, np.int32),
    "all_sentinels": np.full(5, -1, np.int32),
    "distinct": np.array([11, 2, 7, 0], np.int32),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_rows_matches_jax(case):
    rows = MERGE_CASES[case]
    rng = np.random.RandomState(3)
    # integer-valued rows: every f32 sum is exact in any order
    vals = rng.randint(-8, 8, (rows.size, 4)).astype(np.float32)
    height = 16
    ju, js = jsr.merge_rows(jnp.asarray(rows), jnp.asarray(vals), height)
    pu, ps = psr.merge_rows(torch.from_numpy(rows), torch.from_numpy(vals), height)
    assert pu.dtype == torch.int32 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    jd = jsr.densify(jnp.asarray(rows), jnp.asarray(vals), height)
    pd = psr.densify(torch.from_numpy(rows), torch.from_numpy(vals), height)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


HASH_IDS = np.array([0, 1, 7, 2 ** 31 - 1, 2 ** 32, 2 ** 32 + 5, 2 ** 40 + 3, -1, -5, -(2 ** 33),
                     123456789012], np.int64).reshape(-1, 1)


@pytest.mark.parametrize("num_hash", [1, 3])
def test_hash_matches_jax(num_hash):
    """The hash op through each package's executor (int64 ids narrow to
    int32 at the feed in both), ids past 2^32 and negative ids, bit for bit;
    and the op alone over an int32 column."""

    def program_fn(fluid):
        x = fluid.layers.data(name="x", shape=[1], dtype="int64")
        return [fluid.layers.hash(x, hash_size=1000, num_hash=num_hash)]

    want, got, _, _ = run_both(program_fn, {"x": HASH_IDS})
    assert got[0][0].shape == (HASH_IDS.shape[0], num_hash, 1)
    np.testing.assert_array_equal(got[0][0].astype(np.int64), want[0][0].astype(np.int64))
    ids2 = np.stack([HASH_IDS[:, 0].astype(np.int32), np.arange(11, dtype=np.int32)], 1)
    outs = lower_both("hash", {"X": [ids2]}, {"num_hash": num_hash, "mod_by": 97})
    np.testing.assert_array_equal(outs[1]["Out"][0], outs[0]["Out"][0])


def test_sigmoid_ce_with_ignore_index_matches_jax():
    rng = np.random.RandomState(5)
    x = (rng.randn(6, 4) * 4).astype(np.float32)
    label = (rng.rand(6, 4) < 0.5).astype(np.float32)
    label[0, :2] = -100.0
    label[3, 1] = -100.0
    for ignore in (-100, 1):
        check_op("sigmoid_cross_entropy_with_logits", {"X": [x], "Label": [label]},
                 {"ignore_index": ignore}, 1e-6)


def test_deepfm_hashed_ids_run():
    """hash_size routes raw ids through the hash op in both packages: 2 SGD
    steps from the same weights, losses close."""

    def program_fn(fluid):
        ids = fluid.layers.data(name="ids", shape=[SH_FIELDS, 1], dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        loss, _, _ = _deepfm(fluid)(ids, label, num_fields=SH_FIELDS, embedding_size=SH_DIM,
                                    layer_sizes=(16,), is_sparse=True, hash_size=97)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss]

    rng = np.random.RandomState(11)
    feeds = [{"ids": rng.randint(-2 ** 40, 2 ** 40, (16, SH_FIELDS, 1)).astype("int64"),
              "label": (rng.rand(16, 1) < 0.5).astype("float32")} for _ in range(2)]
    want, got, names, (jfin, pfin) = run_both(program_fn, feeds, steps=2)
    _close(_losses(got), _losses(want), "losses")
    for n in names:
        _close(pfin[n], jfin[n], n)


def test_distributed_deepfm_raises():
    """use_distributed=True builds the EmbeddingEngine's row-sharded tables
    (tests/test_torch_parallel.py trains them at ep = 2); an ep mesh wider
    than the process group raises at the ParallelExecutor."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.parallel import MeshConfig

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[SH_FIELDS, 1], dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        loss = _deepfm(fluid)(ids, label, num_features=SH_ROWS, num_fields=SH_FIELDS,
                              use_distributed=True)[0]
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    block = main.global_block()
    assert [op.type for op in block.ops].count("distributed_lookup_table") == 2
    assert main._sharding_rules.match("fm_emb") == ("ep", None)  # the program's rule
    scope = fluid.Scope(place=fluid.CPUPlace())
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    with pytest.raises(ValueError, match="needs 2 devices"):
        fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope,
                               mesh_config=MeshConfig(dp=1, ep=2))


def test_sparse_step_keeps_static_shapes():
    """The sparse step on the port's CPU executor: the SelectedRows values
    and rows keep the batch's id-slot capacity, and the port's executor runs
    the same Program twice without new shapes (a capture needs static
    ones)."""
    main, startup, fetch = build("paddle_tpu_torch", _small(True, _sgd))
    block = main.global_block()
    assert tuple(block.var("fm_emb@GRAD").shape) == (-1, SH_DIM)
    assert tuple(block.var("fm_emb@GRAD@ROWS").shape) == (-1,)
    exe, scope, guard = exe_scope("paddle_tpu_torch")
    with guard(scope):
        exe.run(startup)
        for feed in _sh_batches(2):
            (loss,) = exe.run(main, feed=feed, fetch_list=[fetch[0].name])
            assert np.isfinite(loss).all()
