"""Step telemetry of the torch port (paddle_tpu_torch/observability/
stepstats.py, export.py, promparse.py, aggregate.py, slo.py) against the
JAX package's, on the CPU.

- The same 4-step static program through both executors with
  FLAGS_telemetry_dir set (interval 2): the step records' fields and
  counters equal (steps, cache hits, nan trips, training), the losses
  within rtol 1e-5 (weights carried by name); the port's JSONL shard and
  Prometheus file read back by both packages' promparse, equal to the
  port's registry snapshot; tools/monitor.py renders the port's directory;
  a NaN-guard trip counts in both.
- The pure-Python modules on the same inputs give equal output: the
  FleetAggregator's merge over scraped registries, the AlertEngine's alerts
  on one event stream and clock, the three drift sentinels.
- analytic_bubble is stepstats' own, imported by parallel/pipeline.py;
  a PyReader whose producer sleeps, and a DataRuntime whose decode sleeps,
  record a feed-stall at least the sleep.
- The five flags that were pending act: telemetry_dir (files),
  telemetry_interval_steps (snapshot records), telemetry_log_every (the
  stderr health line), tensor_stats (a reading), nan_provenance (a record).
"""

import contextlib
import json
import os
import sys
import time

import numpy as np
import pytest

import jax

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch as pt
from paddle_tpu import flags as jflags
from paddle_tpu.observability import (aggregate as jaggregate, promparse as jpromparse,
                                      registry as jregistry, slo as jslo,
                                      stepstats as jstepstats)
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.observability import (aggregate as taggregate, opprof as topprof,
                                            promparse as tpromparse, registry as tregistry,
                                            slo as tslo, stepstats as tstepstats)
from paddle_tpu_torch.resilience import faults as tfaults

import torch_obs_cases as cases

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
TOOLS = os.path.join(HERE, "..", "tools")
STEPS = 4
TELEMETRY_FLAGS = ("telemetry_dir", "telemetry_interval_steps", "telemetry_log_every",
                   "tensor_stats", "nan_provenance", "resilience_nan_guard")


def _mods(pkg):
    """(flags, stepstats, faults) of a package."""
    return (tflags, tstepstats, tfaults) if cases.is_port(pkg) else (
        jflags, jstepstats, jfaults)


@contextlib.contextmanager
def _telemetry(pkg, **values):
    """The package's telemetry flags set for the body, its collector fresh
    (reset, its exporter closed) before and after."""
    flags, stepstats, _ = _mods(pkg)
    saved = flags.get_flags(list(TELEMETRY_FLAGS))
    col = stepstats.collector()
    col.close()
    col.reset()
    flags.set_flags(values)
    try:
        yield col
    finally:
        col.close()
        col.reset()
        flags.set_flags(saved)


def _records(d, kind="step"):
    out = []
    for name in sorted(os.listdir(d)):
        if name.startswith("telemetry-host") and name.endswith(".jsonl"):
            with open(os.path.join(d, name)) as f:
                out.extend(r for r in map(json.loads, f) if r["kind"] == kind)
    return out


COUNTERS = ("steps_total", "compile_cache/hits", "compile_cache/misses", "nan_guard/trips")


def _counts(col):
    snap = col.registry.snapshot()
    return {n: sum(snap.get(n, {}).get("values", {}).values()) for n in COUNTERS}


def _telemetry_run(pkg, d, init=None, poison_step=None):
    """(losses, the registry snapshot after the flush, the counters' moves)
    of the startup run and 4 steps of fc_adam with telemetry on."""
    _, _, faults = _mods(pkg)
    with _telemetry(pkg, telemetry_dir=str(d), telemetry_interval_steps=2,
                    resilience_nan_guard=poison_step is not None) as col:
        before = _counts(col)
        run = cases.Run(pkg, cases.fc_adam, init=init)
        losses = []
        for s in range(STEPS):
            if s == poison_step:
                faults.install("nan_grad:step=1")
            try:
                losses.append(float(np.asarray(run.step(cases.fc_batch(s))[0]).reshape(-1)[0]))
            finally:
                faults.install(None)
        col.flush()
        snap = col.registry.snapshot()
        after = _counts(col)
    return losses, snap, {n: after[n] - before[n] for n in COUNTERS}


STEP_FIELDS = ("kind", "step", "n_steps", "cache_hit", "nan_trip", "training")


@pytest.mark.parametrize("poison_step", [None, 2], ids=["clean", "nan_guard_trip"])
def test_step_records_match_jax(tmp_path, poison_step):
    jd, td = tmp_path / "jax", tmp_path / "port"
    jlosses, _, jmoved = _telemetry_run(jfluid, jd, poison_step=poison_step)
    tlosses, tsnap, tmoved = _telemetry_run(pt, td, init=_startup_state(),
                                            poison_step=poison_step)
    jrec, trec = _records(jd), _records(td)
    assert len(trec) == len(jrec) == STEPS + 1  # the startup run and 4 steps
    assert [tuple(r[k] for k in STEP_FIELDS) for r in trec] == \
        [tuple(r[k] for k in STEP_FIELDS) for r in jrec]
    assert [sorted(r) for r in trec] == [sorted(r) for r in jrec]
    assert [r["host"] for r in trec] == [0] * len(trec)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tmoved == jmoved
    assert tmoved["nan_guard/trips"] == (poison_step is not None)
    # snapshot records every 2 steps and the Prometheus scrape file, which
    # both packages' parsers read back as the port's registry
    assert len(_records(td, "snapshot")) >= 2
    with open(td / "metrics-host0.prom") as f:
        text = f.read()
    # (a metric with no sample yet has no line to read back)
    sampled = {k: v for k, v in tsnap.items() if v["kind"] == "histogram" or v.get("values")}
    assert tpromparse.parse(text) == jpromparse.parse(text) == sampled
    sys.path.insert(0, TOOLS)
    try:
        import monitor
    finally:
        sys.path.remove(TOOLS)
    out = monitor.render(monitor.summarize(monitor.load_records(str(td))))
    assert "step" in out


_STARTUP = {}


def _startup_state():
    """The JAX package's startup state of fc_adam (made once)."""
    if not _STARTUP:
        _STARTUP.update(cases.Run(jfluid, cases.fc_adam).state())
    return dict(_STARTUP)


def test_merged_view_of_the_shards(tmp_path):
    from paddle_tpu_torch.observability import export

    with _telemetry(pt, telemetry_dir=str(tmp_path)):
        run = cases.Run(pt, cases.fc_adam)
        run.step(cases.fc_batch(0))
    merged = export.merge_host_shards(str(tmp_path))
    with open(merged) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["kind"] for r in recs] == ["step", "step"]


# ---------------------------------------------------------------- pure Python


def _fleet(agg_mod, reg_mod):
    up = reg_mod.MetricRegistry()
    up.counter("req").inc(5, code="200")
    up.histogram("lat_ms").observe(3.0)
    up.gauge("depth").set(2)
    texts = {"http://a": up.to_prometheus(), "http://b": up.to_prometheus()}

    def fetch(url, timeout_s):
        if url not in texts:
            raise ConnectionError("replica died: %s" % url)
        return texts[url]

    local = reg_mod.MetricRegistry()
    local.counter("routed").inc(3)
    agg = agg_mod.FleetAggregator(targets={"a": "http://a", "b": "http://b", "c": "http://c"},
                                  local_registry=local, fetch=fetch, clock=lambda: 100.0)
    fs = agg.scrape_once()
    return fs.merged, {k: v["ok"] for k, v in fs.targets.items()}, agg.stats()


def test_fleet_aggregator_merge_matches_jax():
    got, want = _fleet(taggregate, tregistry), _fleet(jaggregate, jregistry)
    assert got[0] == want[0] and got[1] == want[1]
    for k in ("counters", "gauges", "histograms"):
        assert got[2][k] == want[2][k]


def _alerts(slo_mod, reg_mod):
    clock = [1000.0]
    reg = reg_mod.MetricRegistry()
    req = reg.counter("req")
    sampler = slo_mod.LocalSampler(reg, clock=lambda: clock[0])
    eng = slo_mod.AlertEngine(
        slos=[slo_mod.SLO("avail", 0.99, counter="req", bad={"code": "5"}, min_events=1)],
        history=sampler, rules=[slo_mod.BurnRateRule("page", 60.0, 300.0, 10.0)],
        registry=reg, clock=lambda: clock[0], log_stderr=False, flightrec=False)
    seen = []
    for good, bad in [(10, 0)] * 40 + [(5, 5)] * 12 + [(10, 0)] * 12:
        if good:
            req.inc(good, code="200")
        if bad:
            req.inc(bad, code="500")
        clock[0] += 10.0
        sampler.sample()
        seen.extend((clock[0], e.name, e.severity, e.state) for e in eng.evaluate())
    return seen, reg.snapshot()


def test_alert_engine_matches_jax():
    got, want = _alerts(tslo, tregistry), _alerts(jslo, jregistry)
    assert got[0] == want[0] and any(s == "firing" for *_, s in got[0])
    assert got[1] == want[1]


def _sentinels(slo_mod, reg_mod):
    reg = reg_mod.MetricRegistry()
    h = reg.histogram("lat_ms")
    misses = reg.counter("compile_cache/misses")
    items = reg.counter("goodput/items_total")
    drift = slo_mod.DriftSentinel("d", "lat_ms", warmup=5, rel_threshold=0.5)
    retrace = slo_mod.RetraceSentinel(steady_ticks=3)
    good = slo_mod.GoodputSentinel("gp", "goodput/items_total", roofline_per_s=100.0,
                                   unit="img", min_frac=0.5, warmup=1, registry=reg)
    hist, states = [], []
    for i, m in enumerate([10.0] * 30 + [30.0] * 40):
        for _ in range(20):
            h.observe(m)
        if i in (1, 45):
            misses.inc(2)
        items.inc(90 if i % 17 else 10)
        hist.append((float(i), reg.snapshot()))
        states.append(tuple(s.evaluate(hist, float(i))[0] for s in (drift, retrace, good)))
    return states


def test_drift_sentinels_match_jax():
    got = _sentinels(tslo, tregistry)
    assert got == _sentinels(jslo, jregistry)
    assert {"firing"} <= {s for row in got for s in row}


# ---------------------------------------------------------------- bubble, stall


def test_analytic_bubble_lives_in_stepstats():
    from paddle_tpu_torch.parallel import pipeline

    assert pipeline.analytic_bubble is tstepstats.analytic_bubble
    for pp, m in ((2, 1), (4, 8), (8, 3)):
        assert tstepstats.analytic_bubble(pp, m) == jstepstats.analytic_bubble(pp, m)


SLEEP_S = 0.2


def _slow_batches():
    for i in range(2):
        time.sleep(SLEEP_S)
        yield {"x": np.full((4, 3), i, np.float32)}


def _slow_decode(shard_id):
    for b in range(2):
        time.sleep(SLEEP_S)
        yield {"x": np.full((4, 3), shard_id * 10 + b, np.float32)}


@pytest.mark.parametrize("source", ["py_reader", "data_runtime"])
def test_feed_stall_at_least_the_producer_sleep(tmp_path, source):
    from paddle_tpu_torch.data import DataRuntime
    from paddle_tpu_torch.py_reader import PyReader

    with _telemetry(pt, telemetry_dir=str(tmp_path)) as col:
        if source == "py_reader":
            r = PyReader(["x"], capacity=2, return_device_arrays=False, place=pt.CPUPlace())
            r.decorate_tensor_provider(_slow_batches)
            r.start()
            r.next_batch()
            r.reset()
        else:
            r = DataRuntime(_slow_decode, num_shards=1, num_workers=1, seed=0,
                            stage_device=False, place=pt.CPUPlace())
            try:
                r.start()
                r.next_batch()
            finally:
                r.close()
        st = col.record_step(1.0)
    assert st.feed_stall_ms >= SLEEP_S * 1e3 * 0.9


# ---------------------------------------------------------------- flags


def _flag_acts(name, tmp_path, capfd):
    d = str(tmp_path / name)
    if name == "telemetry_dir":
        with _telemetry(pt, telemetry_dir=d):
            cases.Run(pt, cases.fc_adam).step(cases.fc_batch(0))
        return os.path.exists(os.path.join(d, "telemetry-host0.jsonl"))
    if name == "telemetry_interval_steps":
        with _telemetry(pt, telemetry_dir=d, telemetry_interval_steps=1):
            run = cases.Run(pt, cases.fc_adam)
            run.step(cases.fc_batch(0))
        return len(_records(d, "snapshot")) == 2  # the startup run's and the step's
    if name == "telemetry_log_every":
        with _telemetry(pt, telemetry_log_every=1):
            cases.Run(pt, cases.fc_adam).step(cases.fc_batch(0))
        return "[telemetry] step=" in capfd.readouterr().err
    if name == "tensor_stats":
        with _telemetry(pt, tensor_stats="mul*"):
            cases.Run(pt, cases.fc_adam).step(cases.fc_batch(0))
            stats = topprof.last_tensor_stats()
        return bool(stats) and all(k.startswith("mul") for k in stats)
    if name == "nan_provenance":
        with _telemetry(pt, nan_provenance=True):
            tflags.set_flags({"check_nan_inf": True})
            run = cases.Run(pt, cases.log_net)
            try:
                run.step({"x": -np.ones((2, 6), np.float32)})
            except FloatingPointError as e:
                return "first non-finite output at op #0 log:" in str(e)
            finally:
                tflags.set_flags({"check_nan_inf": False})
        return False
    raise KeyError(name)


@pytest.mark.parametrize("name", ["telemetry_dir", "telemetry_interval_steps",
                                  "telemetry_log_every", "tensor_stats", "nan_provenance"])
def test_former_pending_flag_acts(name, tmp_path, capfd):
    assert not tflags.PENDING
    assert _flag_acts(name, tmp_path, capfd)
