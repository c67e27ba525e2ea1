"""The online learning loop of the port (paddle_tpu_torch.online and the
delta-chain code of resilience/async_ckpt.py) against the JAX package, on
the CPU:

- the delta chain: the port's copies of tests/test_online.py's three
  delta-chain tests (the round trip with compaction and bf16, a torn delta
  ending the chain, untouched rows left out of a shard), each written by
  either package and read by both: load_with_deltas / apply_delta of the
  two packages give the same arrays bit for bit;
- ModelPublisher: one (arrays, train_step, touched) sequence through both
  publishers (a base, deltas with dense and row payloads, a clean skip, a
  compaction): the same pointers, files, manifests (the shards' sha256
  aside: a zip entry carries its write time) and npz contents bit for bit,
  and the same LATEST.json apart from its wall-clock stamp;
- OnlineTrainer: a small DeepFM from the JAX package's startup weights
  through both trainers for 4 publish intervals: the same touched rows,
  kinds and versions; losses and published arrays at rtol 2e-3, atol 2e-4
  (f32 sums in another order, compounded over 12 SGD steps);
- HotReloader: the port's reloader follows the JAX trainer's repository
  into a port ServingEngine: after each version its replies equal a fresh
  port engine restored at that version bit for bit, and the JAX engine at
  that version within rtol 1e-5, atol 1e-6; deltas take the incremental
  path, a cold start and a base change the full one; a torn delta is
  counted and the served version kept, a torn base a counted error; a
  delta's rows scatter into the served table in place (set_params' `rows`,
  on both serving engines), bit for bit with apply_delta, and a table of
  another shape or ids that repeat or fall outside it are refused;
- the port's copies of the rest: a hot swap under concurrent clients with
  zero errors, a geometry change rejected, the staleness throttle and its
  recovery, a trainer killed in the middle of a publish.
"""

import json
import os
import threading
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import online as jonline
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu.models.deepfm import deepfm as jdeepfm
from paddle_tpu.resilience import async_ckpt as jac
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.serving import ServingEngine as JServingEngine

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import convert, online
from paddle_tpu_torch.embedding import engines_of
from paddle_tpu_torch.models.deepfm import deepfm
from paddle_tpu_torch.resilience import async_ckpt as ac
from paddle_tpu_torch.resilience import faults, health
from paddle_tpu_torch.serving import ModelServer, ServingEngine

from torch_online_cases import tree

jax.config.update("jax_platforms", "cpu")

CPU = fluid.CPUPlace()
TRAIN_RTOL, TRAIN_ATOL = 2e-3, 2e-4
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-6
CTR = dict(rows=512, fields=4, dim=8, batch=32, layer_sizes=(16,), lr=0.05)
PACKAGES = ("paddle_tpu", "paddle_tpu_torch")


@pytest.fixture(autouse=True)
def _clean_faults():
    for mod in (faults, jfaults):
        mod.install(None)
    yield
    for mod in (faults, jfaults):
        mod.install(None)


def _arrays(seed, rows=12, dim=3):
    rng = np.random.RandomState(seed)
    return {
        "w": rng.rand(4, dim).astype(np.float32),
        "tbl": rng.rand(rows, dim).astype(np.float32),
    }


def _ckpt(package):
    return jac if package == "paddle_tpu" else ac


def _bf16(package, a):
    """`a` (f32 numpy) as the package's bf16 array."""
    if package == "paddle_tpu":
        return jnp.asarray(a, jnp.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def _f32(a):
    """A loaded array (numpy, a jax array or a torch tensor; bf16 included)
    as f32 numpy, exactly."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32) if str(np.asarray(a).dtype) == "bfloat16" else np.asarray(a)


def _dtype(a):
    return "bfloat16" if (isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16) \
        else str(np.asarray(a).dtype)


def _same_loaded(got, want):
    """Two loads' arrays: the same names, dtypes and bits."""
    assert sorted(got) == sorted(want)
    for n in want:
        assert _dtype(got[n]) == _dtype(want[n]), n
        g, w = _f32(got[n]), _f32(want[n])
        assert g.shape == w.shape and g.tobytes() == w.tobytes(), n


# --------------------------------------------------------------------------
# delta format, written by either package, read by both
# --------------------------------------------------------------------------


@pytest.mark.parametrize("writer", PACKAGES)
def test_delta_roundtrip_compaction_and_bf16(tmp_path, writer):
    """Base + two chained deltas reassemble bit-exact in both packages; a
    bf16 dense param survives the widen/narrow cycle losslessly; compaction
    GC retires the chain manifest-first."""
    w_ac = _ckpt(writer)
    root = str(tmp_path)
    base = _arrays(0)
    w32 = base["w"]
    base["w"] = _bf16(writer, w32)
    w_ac.write_elastic_checkpoint(root, base, 10)

    t12 = np.array(base["tbl"])
    t12[[3, 5]] += 1
    w12 = _bf16(writer, _f32(base["w"]) * 2)
    w_ac.write_elastic_delta(
        root, 12, 10, 10, {"w": w12},
        {"tbl": (np.array([3, 5]), t12[[3, 5]], list(t12.shape))},
    )
    t14 = t12.copy()
    t14[[5, 7]] -= 2
    w_ac.write_elastic_delta(
        root, 14, 10, 12, {},
        {"tbl": (np.array([5, 7]), t14[[5, 7]], list(t14.shape))},
    )

    loads = {}
    for reader in PACKAGES:
        step, arrays, info = _ckpt(reader).load_with_deltas(root)
        assert (step, info["base_step"], info["deltas"]) == (14, 10, [12, 14])
        assert _dtype(arrays["w"]) == "bfloat16"
        np.testing.assert_array_equal(_f32(arrays["w"]), _f32(w12))
        np.testing.assert_array_equal(np.asarray(arrays["tbl"]), t14)
        step, mid, _ = _ckpt(reader).load_with_deltas(root, upto_step=12)
        assert step == 12
        np.testing.assert_array_equal(np.asarray(mid["tbl"]), t12)
        loads[reader] = (arrays, mid)
    for got, want in zip(loads["paddle_tpu_torch"], loads["paddle_tpu"]):
        _same_loaded(got, want)

    # compaction: a new base at 14 makes the old chain garbage
    arrays = loads[writer][0]
    w_ac.write_elastic_checkpoint(root, dict(arrays, tbl=t14), 14)
    assert w_ac.gc_elastic_deltas(root, keep_base_step=14) == 2
    for reader in PACKAGES:
        r_ac = _ckpt(reader)
        assert r_ac.resolve_delta_chain(root)[0] == 14
        assert r_ac.load_with_deltas(root)[0] == 14


@pytest.mark.parametrize("writer", PACKAGES)
def test_torn_delta_ends_chain_not_recovery(tmp_path, writer):
    """A manifest-less delta dir is skipped (the chain ends at the previous
    link) by both packages' readers and never confuses base recovery; the
    retried delta commits cleanly."""
    w_ac = _ckpt(writer)
    w_faults = jfaults if writer == "paddle_tpu" else faults
    root = str(tmp_path)
    w_ac.write_elastic_checkpoint(root, _arrays(1), 5)
    w_ac.write_elastic_delta(root, 7, 5, 5, {"w": _arrays(2)["w"]}, {})
    w_faults.install("manifest_crash:step=1")
    with pytest.raises(w_faults.InjectedFault):
        w_ac.write_elastic_delta(root, 9, 5, 7, {"w": _arrays(3)["w"]}, {})
    w_faults.install(None)
    torn = os.path.join(root, "eckpt-delta-00000009")
    assert os.path.isdir(torn) and not os.path.exists(os.path.join(torn, ac.MANIFEST))
    before = health.get("delta_skipped_invalid")
    for reader in PACKAGES:
        with pytest.warns(UserWarning, match="torn/manifest-less delta"):
            base_step, _, chain = _ckpt(reader).resolve_delta_chain(root)
        assert (base_step, [s for s, _ in chain]) == (5, [7])
        assert _ckpt(reader).latest_valid_elastic(root)[0] == 5
    assert health.get("delta_skipped_invalid") > before
    with pytest.warns(UserWarning):
        got = ac.load_with_deltas(root)
    with pytest.warns(UserWarning):
        want = jac.load_with_deltas(root)
    assert got[0] == want[0] == 7
    _same_loaded(got[1], want[1])
    w_ac.write_elastic_delta(root, 9, 5, 7, {"w": _arrays(3)["w"]}, {})
    for reader in PACKAGES:
        assert [s for s, _ in _ckpt(reader).resolve_delta_chain(root)[2]] == [7, 9]


def test_untouched_rows_absent_from_delta_shard(tmp_path):
    """The port's SelectedRows touched-rows bookkeeping keeps a delta's table
    shard to exactly the rows the optimizer wrote; the JAX package's
    apply_delta replays the port's delta to the port's table bit for bit."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[2, 1], dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        loss, _, _ = deepfm(
            ids, label, num_features=64, num_fields=2, embedding_size=4,
            layer_sizes=(8,), is_sparse=True, use_distributed=True,
        )
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    engines = engines_of(main)
    emb = next(e for e in engines if e.table.name == "fm_emb")
    rows_var = emb.touched_rows_var_name()
    assert rows_var in main.global_block().vars

    exe = fluid.Executor(CPU)
    feed = {
        "ids": np.tile(np.array([[3], [9]], np.int64), (4, 1, 1)),
        "label": np.ones((4, 1), np.float32),
    }
    scope = fluid.Scope(seed=0, place=CPU)
    with fluid.scope_guard(scope):
        exe.run(startup)
        table0 = scope.find_var("fm_emb").numpy().copy()
        _, rows = exe.run(main, feed=feed, fetch_list=[loss.name, rows_var])
        emb.note_touched(1, np.asarray(rows))
        table = scope.find_var("fm_emb")
    got = emb.touched_rows_since(0)
    assert set(got.tolist()) == {3, 9}
    assert emb.touched_rows_since(1).size == 0

    from paddle_tpu_torch.online.publisher import _take_rows

    ac.write_elastic_delta(
        str(tmp_path), 2, 1, 1, {},
        {"fm_emb": (got, _take_rows(table, got), list(table.shape))},
    )
    d = os.path.join(str(tmp_path), "eckpt-delta-00000002")
    manifest = json.load(open(os.path.join(d, ac.MANIFEST)))
    assert manifest["arrays"]["fm_emb"]["rows"] == 2
    with np.load(os.path.join(d, next(iter(manifest["files"])))) as shard:
        assert set(shard["fm_emb" + ac.ROWS_KEY].tolist()) == {3, 9}
    for r_ac in (ac, jac):
        _, out, _ = r_ac.apply_delta(d, {"fm_emb": table0})
        assert out["fm_emb"].tobytes() == table.numpy().tobytes()


# --------------------------------------------------------------------------
# the publisher, file for file
# --------------------------------------------------------------------------


def test_publisher_files_match_jax_publisher(tmp_path):
    """The same (arrays, train_step, touched) sequence through both
    ModelPublishers (the port's arrays as CPU tensors, a bf16 dense one
    among them): the same pointers, the same files, manifests and npz
    contents, and the same LATEST.json, at every step."""
    a = _arrays(7, rows=16)
    a["b"] = np.arange(5, dtype=np.float32)
    bf = np.linspace(-2, 2, 6, dtype=np.float32).reshape(2, 3)
    bf_at = {1: 1.0, 2: 1.0, 3: 2.0, 4: 2.0, 5: 2.0, 6: 2.0}  # dirty at 3 only
    seq = []
    cur = dict(a)
    seq.append((dict(cur), 1, None))                      # base
    t = cur["tbl"].copy()
    t[[2, 9]] += 1.5
    cur = dict(cur, tbl=t, w=cur["w"] * 2)
    seq.append((dict(cur), 2, {"tbl": np.array([2, 9])}))  # rows + dense w
    t = cur["tbl"].copy()
    t[[9, 15]] -= 0.25
    cur = dict(cur, tbl=t)
    seq.append((dict(cur), 3, {"tbl": np.array([9, 15])}))  # rows only
    seq.append((dict(cur), 4, {"tbl": np.array([], np.int64)}))  # clean: skipped
    cur = dict(cur, b=cur["b"] + 1)
    seq.append((dict(cur), 5, {"tbl": np.array([], np.int64)}))  # dense b only
    seq.append((dict(cur), 6, {"tbl": np.array([], np.int64)}))  # compaction

    pubs = {"paddle_tpu": jonline.ModelPublisher(str(tmp_path / "j"), max_chain=3),
            "paddle_tpu_torch": online.ModelPublisher(str(tmp_path / "p"), max_chain=3)}
    for arrays, step, touched in seq:
        ptrs = {}
        for pkg, pub in pubs.items():
            conv = {n: (_bf16(pkg, bf * bf_at[step]) if n == "bf" else
                        (v if pkg == "paddle_tpu" else torch.from_numpy(v.copy())))
                    for n, v in dict(arrays, bf=bf).items()}
            ptrs[pkg] = pub.publish(conv, step, touched=touched)
        j, p = ptrs["paddle_tpu"], ptrs["paddle_tpu_torch"]
        if j is None:
            assert p is None, step
        else:
            for ptr in (j, p):
                ptr["stamp"].pop("wall_time")
            assert p == j, step
        assert tree(str(tmp_path / "p")) == tree(str(tmp_path / "j")), step
        assert pubs["paddle_tpu_torch"].stats() == pubs["paddle_tpu"].stats()
    assert [json.load(open(str(tmp_path / d / "LATEST.json")))["kind"] for d in "jp"] == \
        ["base", "base"]
    assert pubs["paddle_tpu_torch"].stats()["skipped_clean"] == 1
    assert pubs["paddle_tpu_torch"].stats()["published"] == 5


# --------------------------------------------------------------------------
# the trainer and the reloader against the JAX package
# --------------------------------------------------------------------------


def _ctr_program(package):
    fl = jfluid if package == "paddle_tpu" else fluid
    model = jdeepfm if package == "paddle_tpu" else deepfm
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        ids = fl.layers.data(name="ids", shape=[CTR["fields"], 1], dtype="int64")
        label = fl.layers.data(name="label", shape=[1], dtype="float32")
        loss, pred, _ = model(
            ids, label, num_features=CTR["rows"], num_fields=CTR["fields"],
            embedding_size=CTR["dim"], layer_sizes=CTR["layer_sizes"],
            is_sparse=True, use_distributed=True,
        )
        fl.optimizer.SGD(learning_rate=CTR["lr"]).minimize(loss)
    return main, startup, loss, pred


def _ctr_stream(n, seed=11):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield {
            "ids": rng.randint(0, CTR["rows"], (CTR["batch"], CTR["fields"], 1)).astype(np.int64),
            "label": (rng.rand(CTR["batch"], 1) < 0.5).astype(np.float32),
        }


def _serve_names(program):
    from paddle_tpu_torch.io import _is_persistable

    return sorted(
        v.name for v in program.list_vars()
        if _is_persistable(v) and "@" not in v.name
        and not v.name.startswith("learning_rate")
    )


def _spy(trainer, r_ac, repo, log):
    """Record every publish: (kind, version, touched rows, arrays at it)."""
    orig = trainer.publisher.publish

    def publish(arrays, step, touched=None, **kw):
        ptr = orig(arrays, step, touched=touched, **kw)
        log.append((ptr and ptr["kind"], ptr and ptr["version"],
                    {n: sorted(np.asarray(v).tolist()) for n, v in (touched or {}).items()},
                    r_ac.load_with_deltas(repo, upto_step=step)[1] if ptr else None))
        return ptr

    trainer.publisher.publish = publish


def test_online_trainer_matches_jax_trainer(tmp_path):
    """A small DeepFM (512 rows, 4 fields, dim 8, batch 32, SGD 0.05, sparse
    and distributed) from the JAX package's startup weights through both
    OnlineTrainers, publishing every 3 steps with compaction at 2 deltas:
    the same kinds, versions and touched rows; losses and published arrays
    close; the newest version is the port trainer's live scope bit for bit."""
    steps, interval = 12, 3
    logs, curves, shared = {}, {}, None
    live = None
    names = _serve_names(_ctr_program("paddle_tpu_torch")[0])
    for pkg in PACKAGES:
        main, startup, loss, _ = _ctr_program(pkg)
        repo = str(tmp_path / pkg)
        if pkg == "paddle_tpu":
            exe, scope, guard, mod, r_ac = jfluid.Executor(), JScope(seed=5), jscope_guard, \
                jonline, jac
        else:
            exe, scope, guard, mod, r_ac = fluid.Executor(CPU), fluid.Scope(seed=5, place=CPU), \
                fluid.scope_guard, online, ac
        with guard(scope):
            tr = mod.OnlineTrainer(
                exe, main, repo, names,
                publisher=mod.ModelPublisher(repo, max_chain=2),
                publish_interval=interval, scope=scope,
            )
            tr.resume(startup)
            if pkg == "paddle_tpu":
                shared = {n: np.asarray(scope.vars[n])
                          for n in convert.persistable_names(main)}
            else:
                convert.load_into_scope(scope, shared, convert.persistable_names(main))
            logs[pkg] = []
            _spy(tr, r_ac, repo, logs[pkg])
            curves[pkg] = tr.run(_ctr_stream(steps), fetch_list=[loss.name])
            assert tr.publisher.published == steps // interval
            if pkg == "paddle_tpu_torch":
                live = {n: scope.find_var(n).numpy().copy() for n in names}
                newest = ac.load_with_deltas(repo)
    j, p = logs["paddle_tpu"], logs["paddle_tpu_torch"]
    assert [(k, v) for k, v, _, _ in p] == [(k, v) for k, v, _, _ in j] == \
        [("base", 3), ("delta", 6), ("delta", 9), ("base", 12)]
    for (_, v, pt, parr), (_, _, jt, jarr) in zip(p, j):
        assert pt == jt, v
        assert all(pt[n] for n in ("fm_emb", "fm_first")), v
        assert sorted(parr) == sorted(jarr) == names
        for n in names:
            np.testing.assert_allclose(parr[n], np.asarray(jarr[n]), rtol=TRAIN_RTOL,
                                       atol=TRAIN_ATOL, err_msg="%s at %d" % (n, v))
    np.testing.assert_allclose(curves["paddle_tpu_torch"], curves["paddle_tpu"],
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    assert newest[0] == steps
    for n, v in live.items():
        assert np.asarray(newest[1][n]).tobytes() == v.tobytes(), n


def _engines_at(model_dir, repo, version, jeng):
    """(a fresh port engine restored at `version`, the JAX engine set to it)."""
    step, arrays, _ = ac.load_with_deltas(repo, upto_step=version)
    assert step == version
    fresh = ServingEngine(model_dir, name="fresh%d" % version, place=CPU, batch_buckets=(2,))
    fresh.set_params(arrays, version=version)
    jeng.set_params(arrays, version=version)
    return fresh


def test_hot_reloader_follows_jax_trainer(tmp_path):
    """The port's HotReloader lands each version the JAX trainer publishes in
    a live port ServingEngine: its replies equal a fresh port engine restored
    at that version bit for bit and the JAX engine's within rtol 1e-5, atol
    1e-6; deltas apply incrementally, a cold start and a base change (with
    versions missed) fully; a torn delta keeps the served version and is
    counted, a torn base is a counted error."""
    main, startup, loss, pred = _ctr_program("paddle_tpu")
    repo = str(tmp_path / "repo")
    model_dir = str(tmp_path / "model")
    scope = JScope(seed=0)
    exe = jfluid.Executor()
    with jscope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(model_dir, ["ids"], [pred], exe, main_program=main)
    eng = ServingEngine(model_dir, name="ctr", place=CPU, batch_buckets=(2,))
    jeng = JServingEngine(model_dir, name="jctr", batch_buckets=(2,))
    names = eng.param_names()
    table = eng.scope.vars["fm_emb"]
    # the tensor a delta replay seeds from is the one set_params writes into
    assert eng._ro["fm_emb"] is table
    reloader = online.HotReloader(repo, [eng], consumer="t")
    feed = {"ids": np.random.RandomState(5).randint(0, CTR["rows"], (2, CTR["fields"], 1))
            .astype(np.int64)}

    def check(version, kinds):
        n_hist = len(reloader.history)
        assert reloader.check_once() == len(kinds)
        assert [h["kind"] for h in reloader.history[n_hist:]] == kinds
        assert eng.model_version == version and eng.scope.vars["fm_emb"] is table
        (got,) = eng.run(feed)
        fresh = _engines_at(model_dir, repo, version, jeng)
        (want,) = fresh.run(feed)
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), version
        (jgot,) = jeng.run(feed)
        np.testing.assert_allclose(got, np.asarray(jgot), rtol=SERVE_RTOL, atol=SERVE_ATOL)
        assert json.load(open(os.path.join(repo, "ack-t.json")))["version"] == version
        return got

    stream = _ctr_stream(16)
    with jscope_guard(scope):
        tr = jonline.OnlineTrainer(exe, main, repo, names,
                                   publisher=jonline.ModelPublisher(repo, max_chain=3),
                                   publish_interval=2, scope=scope)
        outs = []
        # bases at 2 and 10 (compaction after 3 deltas), deltas between
        for upto, expect in ((2, ["base"]), (4, ["delta"]), (6, None), (8, ["delta", "delta"]),
                             (10, None), (12, ["base"])):
            tr.run(stream, fetch_list=[loss.name], max_steps=upto)
            if expect is not None:
                outs.append(check(upto, expect))
    assert not np.array_equal(outs[0], outs[-1])
    assert reloader.check_once() == 0 and reloader.errors == 0

    # a torn delta (its shard cut after the pointer named it): the chain
    # ends before it, the served version stays and the skip is counted
    with jscope_guard(scope):
        tr.run(stream, fetch_list=[loss.name], max_steps=14)
    delta = os.path.join(repo, "eckpt-delta-00000014")
    shard = os.path.join(delta, next(iter(json.load(open(os.path.join(delta, ac.MANIFEST)))
                                           ["files"])))
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) // 2)
    before = health.get("delta_skipped_invalid")
    with pytest.warns(UserWarning, match="torn/manifest-less delta"):
        assert reloader.check_once() == 0
    assert health.get("delta_skipped_invalid") > before
    assert eng.model_version == 12 and reloader.errors == 0
    (kept,) = eng.run(feed)
    assert np.asarray(kept).tobytes() == np.asarray(outs[-1]).tobytes()

    # a torn base and nothing else: a cold reloader counts the error and
    # its engine keeps serving what it has
    lone = str(tmp_path / "lone")
    online.ModelPublisher(lone).publish({n: eng.scope.vars[n] for n in names}, 3)
    base = os.path.join(lone, "eckpt-00000003")
    for f in os.listdir(base):
        if f.endswith(".npz"):
            os.remove(os.path.join(base, f))
    cold_eng = ServingEngine(model_dir, name="cold", place=CPU, batch_buckets=(2,))
    cold = online.HotReloader(lone, [cold_eng], consumer="c")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert cold.check_once() == 0
    assert cold.errors == 1 and cold_eng.model_version == 0


class _TableEngine:
    """An engine's face to the reloader over plain tensors on the CPU; its
    row swaps go through the serving engines' own scatter."""

    name = "tables"
    model_version = 0

    def __init__(self, tables):
        self.scope = type("S", (), {"vars": tables, "device": torch.device("cpu")})()

    def set_params(self, updates, version=None, stamp=None, rows=None):
        from paddle_tpu_torch.serving.engine import _row_update, _scatter_once

        scatter = [_row_update(n, self.scope.vars[n], ids, vals)
                   for n, (ids, vals) in (rows or {}).items()]
        for n, v in updates.items():
            self.scope.vars[n] = torch.as_tensor(v).to(self.scope.vars[n].dtype)
        _scatter_once(scatter)
        self.model_version = version


def test_card_replay_is_the_host_replay_bit_for_bit(tmp_path):
    """The reloader's replay of a delta (set_params' row scatter into the
    live table, in place) gives apply_delta's replay bit for bit, an f32
    and a bf16 table and a dense value among them; row ids that repeat or
    fall outside the table raise before anything is copied, and a live
    table of another shape is a counted error that keeps the version.
    Here the CPU stands in for the card."""
    from paddle_tpu_torch.serving.engine import _row_update

    root = str(tmp_path / "repo")
    rng = np.random.RandomState(9)
    arrays = {"tbl": torch.from_numpy(rng.rand(64, 5).astype(np.float32)),
              "bt": _bf16("paddle_tpu_torch", rng.rand(32, 5)),
              "w": torch.from_numpy(rng.rand(3, 5).astype(np.float32))}
    pub = online.ModelPublisher(root)
    pub.publish(arrays, 1)
    eng = _TableEngine({n: a.clone() for n, a in arrays.items()})
    reloader = online.HotReloader(root, [eng], consumer="t")
    assert reloader.check_once() == 1
    held = {n: eng.scope.vars[n] for n in ("tbl", "bt")}
    ids, bids = np.array([3, 17, 40, 63]), np.array([0, 31, 7])
    arrays["tbl"][torch.from_numpy(ids)] = torch.from_numpy(rng.rand(4, 5).astype(np.float32))
    arrays["bt"][torch.from_numpy(bids)] = _bf16("paddle_tpu_torch", rng.rand(3, 5) * 7)
    arrays["w"] = arrays["w"] * 3
    assert pub.publish(arrays, 2, touched={"tbl": ids, "bt": bids})["kind"] == "delta"
    delta = os.path.join(root, "eckpt-delta-00000002")
    seed = {n: t.clone() for n, t in held.items()}
    _, want, _ = ac.apply_delta(delta, seed)
    assert reloader.check_once() == 1
    assert [h["kind"] for h in reloader.history] == ["base", "delta"]
    for n in ("tbl", "bt"):
        assert eng.scope.vars[n] is held[n]  # scattered in place
    _same_loaded({n: eng.scope.vars[n] for n in want}, want)
    _, _, rows = ac.read_delta(delta)
    for bad in ([3, 3, 40, 63], [3, 17, 40, 64], [-1, 17, 40, 63]):
        t = held["tbl"].clone()
        with pytest.raises(ValueError, match="repeat or fall outside"):
            _row_update("tbl", t, np.array(bad), rows["tbl"][1])
        assert t.numpy().tobytes() == held["tbl"].numpy().tobytes()
    pub.publish(arrays, 3, touched={"tbl": ids})
    eng.scope.vars["tbl"] = torch.zeros(63, 5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert reloader.check_once() == 0
    assert reloader.errors == 1 and eng.model_version == 2


def test_generation_engine_scatters_rows_in_place():
    """GenerationEngine.set_params' `rows` (a delta's table rows) writes
    numpy's row assignment bit for bit into the tensor the scope and every
    variant read, in place, and decodes what a swap of the whole table
    decodes; a KV pool is never scattered, and row ids that repeat or fall
    outside the table raise before anything is copied."""
    from paddle_tpu_torch.models import GPTDecoder
    from paddle_tpu_torch.serving import GenerationEngine

    kw = dict(vocab_size=24, n_layer=2, n_head=2, d_model=16, d_inner=32, max_context=16)
    engines = [GenerationEngine(GPTDecoder(**kw), name="rows%d" % i, place=CPU, max_slots=3,
                                page_size=4, max_context=16) for i in range(2)]
    for e in engines:
        e.warmup()
    held = engines[0].scope.vars["gptd_tok_emb"]
    pool = engines[0].scope.vars["gptd_l0_kv_k"].clone()
    rng = np.random.RandomState(4)
    ids = np.array([1, 7, 23, 9])
    vals = rng.randn(4, 16).astype(np.float32)
    want = held.numpy().copy()
    want[ids] = vals
    for bad in ([1, 7, 7, 9], [1, 7, 24, 9], [-1, 7, 23, 9]):
        with pytest.raises(ValueError, match="repeat or fall outside"):
            engines[0].set_params({}, version=3, rows={"gptd_tok_emb": (np.array(bad), vals)})
    assert engines[0].model_version == 0 and held.numpy().tobytes() != want.tobytes()
    n = engines[0].set_params({}, version=3, rows={
        "gptd_tok_emb": (ids, vals), "gptd_l0_kv_k": (np.array([0]), np.ones((1, 16)))})
    engines[1].set_params({"gptd_tok_emb": want}, version=3)
    assert n == 1 and engines[0].model_version == 3
    assert engines[0].scope.vars["gptd_tok_emb"] is held and held.numpy().tobytes() == want.tobytes()
    for v in engines[0]._variants.values():
        assert v.ro["gptd_tok_emb"].numpy().tobytes() == want.tobytes()
    assert engines[0].scope.vars["gptd_l0_kv_k"].numpy().tobytes() == pool.numpy().tobytes()
    prompt = [4, 9, 1, 13, 7, 23]
    got = [e.generate(prompt, max_new_tokens=5, eos_id=999).tokens for e in engines]
    assert got[0] == got[1]


# --------------------------------------------------------------------------
# the port's copies of the rest of tests/test_online.py
# --------------------------------------------------------------------------


def _save_mlp(tmp_path, name, prefix):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="%s_x" % prefix, shape=[6], dtype="float32")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        y = fluid.layers.fc(input=h, size=3, act="softmax")
    exe = fluid.Executor(CPU)
    model_dir = str(tmp_path / name)
    with fluid.scope_guard(fluid.Scope(seed=3, place=CPU)):
        exe.run(startup)
        fluid.io.save_inference_model(model_dir, ["%s_x" % prefix], [y], exe, main_program=main)
    return model_dir, "%s_x" % prefix


def test_hot_swap_under_concurrent_clients_zero_errors(tmp_path):
    """Clients hammer :predict while set_params swaps repeatedly: zero
    failed requests, no preparations on the hot path, and each client's
    served model_version only moves forward."""
    model_dir, xname = _save_mlp(tmp_path, "hs", "hs")
    srv = ModelServer(port=0)
    eng = srv.add_model("hot", model_dir, place=CPU, batch_buckets=(1, 2, 4),
                        batcher_opts={"max_batch_delay_ms": 1.0})
    port = srv.start()
    base = "http://127.0.0.1:%d" % port
    stop = threading.Event()
    errors = []
    per_client = [[] for _ in range(4)]

    def client(i):
        while not stop.is_set():
            try:
                req = urllib.request.Request(
                    base + "/v1/models/hot:predict",
                    data=json.dumps({"inputs": {xname: np.ones((1 + i % 2, 6)).tolist()}}).encode(),
                    headers={"Content-Type": "application/json"},
                )
                doc = json.load(urllib.request.urlopen(req, timeout=30))
                per_client[i].append(int(doc["model_version"]))
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    swaps = 10
    try:
        traces0 = eng.traces
        params = {n: eng.scope.vars[n].numpy().copy() for n in eng.param_names()}
        for k in range(1, swaps + 1):
            applied = eng.set_params({n: v * (1.0 + 0.01 * k) for n, v in params.items()},
                                     version=k, stamp={"train_step": k})
            assert applied == len(params)
        deadline = 200
        while sum(map(len, per_client)) < 50 and deadline:
            stop.wait(0.05)
            deadline -= 1
        doc = json.load(urllib.request.urlopen(base + "/v1/models/hot"))
        assert doc["model_version"] == swaps
        assert doc["version_stamp"]["train_step"] == swaps
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        srv.stop(drain=True)
    assert not errors, errors
    assert eng.traces == traces0, "hot swap prepared a variant"
    assert eng.model_version == swaps
    versions = [v for vs in per_client for v in vs]
    assert max(versions) == swaps
    for vs in per_client:
        assert vs == sorted(vs)


def test_set_params_rejects_geometry_change(tmp_path):
    model_dir, _ = _save_mlp(tmp_path, "gm", "gm")
    eng = ServingEngine(model_dir, name="gm", place=CPU, batch_buckets=(1,))
    name = eng.param_names()[0]
    bad = np.zeros(tuple(eng.scope.vars[name].shape) + (1,), np.float32)
    with pytest.raises(ValueError, match="hot swap"):
        eng.set_params({name: bad})


def test_trainer_killed_mid_publish_leaves_loadable_chain(tmp_path):
    """A publish torn before its manifest leaves the previous version fully
    loadable and the pointer never names the torn step; a restarted
    publisher adopts the chain and the retried publish commits."""
    repo = str(tmp_path)
    pub = online.ModelPublisher(repo)
    a1 = {n: torch.from_numpy(v) for n, v in _arrays(4).items()}
    pub.publish(a1, 1)
    a2 = {n: v + 1 for n, v in a1.items()}
    faults.install("manifest_crash:step=1")
    with pytest.raises(faults.InjectedFault):
        pub.publish(a2, 2, touched={"tbl": np.array([0, 1])})
    faults.install(None)
    assert online.read_latest(repo)["version"] == 1
    step, arrays, _ = ac.load_with_deltas(repo)
    assert step == 1
    np.testing.assert_array_equal(arrays["w"], a1["w"].numpy())
    pub2 = online.ModelPublisher(repo)
    rec = pub2.publish(a2, 2, touched={"tbl": np.array([0, 1])})
    assert rec["version"] == 2 and rec["kind"] == "delta"
    step, arrays, _ = jac.load_with_deltas(repo)
    assert step == 2
    np.testing.assert_array_equal(arrays["tbl"][:2], a2["tbl"][:2].numpy())
    np.testing.assert_array_equal(arrays["tbl"][2:], a1["tbl"][2:].numpy())


def test_staleness_throttle_and_recovery(tmp_path):
    """A consumer ack far behind the last published version throttles the
    next publish; catching up releases it. The ack files are the JAX
    package's, which reads them alike."""
    repo = str(tmp_path)
    contract = online.StalenessContract(max_staleness_steps=3)
    pub = online.ModelPublisher(repo, contract=contract)
    pub.publish(_arrays(6), 10)
    online.write_ack(repo, "s", 10, {"train_step": 10})
    assert pub.should_publish()
    pub.publish({n: v + 1 for n, v in _arrays(6).items()}, 20)
    assert not pub.should_publish()
    assert pub.throttled == 1
    assert jonline.behind_steps(repo, 20) == online.behind_steps(repo, 20) == 10
    jonline.write_ack(repo, "s", 20, {"train_step": 20})
    assert pub.should_publish()
    assert online.read_acks(repo)["s"]["version"] == 20
