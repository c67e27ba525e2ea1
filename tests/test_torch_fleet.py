"""The serving fleet of the port (paddle_tpu_torch.fleet) on the CPU: the
port's copies of tests/test_fleet.py's eleven tests (the circuit breaker at
zero wall time, the retry budget, router/replica parity, the staleness gate
over an online repository, failover on a reset connection, a browned-out
replica's breaker opening and closing again, hedged first-wins, drain with
nothing dropped, and SIGKILL mid-request with real
`paddle_tpu_torch.fleet.replica` children on "place": "cpu"), then against
the JAX package: the same saved MLP behind the port's Router (port
ModelServers) and the JAX Router (JAX ModelServers) gives replies within
rtol 1e-5, atol 1e-6 with the same model_version, and both packages'
breakers driven by one clock script take the same transitions. A replica
spec with no place on a machine without a card fails to boot.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import fleet as jfleet
from paddle_tpu.serving import ModelServer as JModelServer

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import fleet
from paddle_tpu_torch.fleet import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    CircuitBreaker,
    ReplicaProcess,
    RetryBudget,
    Router,
)
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import ModelServer

jax.config.update("jax_platforms", "cpu")

CPU = fluid.CPUPlace()
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.install(None)
    yield
    faults.install(None)


# --------------------------------------------------------------- breaker


def test_breaker_consecutive_failures_open_half_open_close():
    t = [0.0]
    flips = []
    b = CircuitBreaker(
        name="r0", failure_threshold=3, open_for_s=2.0, success_threshold=2,
        clock=lambda: t[0], on_transition=lambda n, old, new: flips.append(new),
    )
    assert b.state == CLOSED and b.allow()
    for _ in range(2):
        b.record_failure()
    assert b.state == CLOSED
    b.record_failure()
    assert b.state == OPEN and not b.allow() and b.opens == 1
    t[0] = 1.99
    assert not b.allow()
    t[0] = 2.0
    assert b.state == HALF_OPEN
    assert b.allow()
    assert not b.allow()
    b.record_success()
    assert b.state == HALF_OPEN
    assert b.allow()
    b.record_success()
    assert b.state == CLOSED and b.allow()
    assert flips == [OPEN, HALF_OPEN, CLOSED]


def test_breaker_failed_probe_doubles_open_interval_capped():
    t = [0.0]
    b = CircuitBreaker(name="r1", failure_threshold=1, open_for_s=1.0, max_open_s=4.0,
                       clock=lambda: t[0])
    b.record_failure()
    for expected in (2.0, 4.0, 4.0):
        t[0] += b.stats()["open_interval_s"]
        assert b.state == HALF_OPEN and b.allow()
        b.record_failure()
        assert b.state == OPEN
        assert b.stats()["open_interval_s"] == expected
    assert b.opens == 4


def test_breaker_error_rate_trip_needs_min_requests():
    b = CircuitBreaker(name="r2", failure_threshold=100, error_rate_threshold=0.5,
                       window=10, min_requests=6, clock=lambda: 0.0)
    for _ in range(2):
        b.record_failure()
        b.record_success()
    assert b.state == CLOSED
    b.record_failure()
    b.record_success()
    assert b.state == CLOSED
    b.record_failure()
    assert b.state == OPEN


def test_retry_budget_tokens():
    budget = RetryBudget(ratio=0.5, max_tokens=2.0)
    assert budget.take() and budget.take()
    assert not budget.take()
    budget.on_request()
    assert not budget.take()
    budget.on_request()
    assert budget.take()
    for _ in range(100):
        budget.on_request()
    assert budget.tokens == 2.0


# Each step of the script: ("t", seconds) sets the clock, any other name
# calls that method. A step records the state after it and what allow()
# returned.
BREAKER_SCRIPT = (
    [("record_success",)] * 3 + [("record_failure",)] * 2 + [("record_success",)]
    + [("record_failure",)] * 3 + [("allow",), ("t", 0.5), ("allow",), ("t", 1.0), ("allow",),
                                  ("allow",), ("record_failure",), ("t", 2.5), ("allow",),
                                  ("t", 3.0), ("allow",), ("record_success",), ("allow",),
                                  ("record_success",), ("allow",)]
    + [("record_failure",), ("record_success",)] * 6 + [("t", 9.0), ("allow",)]
    + [("record_success",)] * 3 + [("stats",)]
)


@pytest.mark.parametrize("opts", [
    dict(failure_threshold=3, open_for_s=1.0, max_open_s=8.0, success_threshold=2),
    dict(failure_threshold=50, error_rate_threshold=0.4, window=8, min_requests=4,
         open_for_s=0.5, half_open_probes=2, success_threshold=1),
], ids=["streak", "error_rate"])
def test_breakers_of_both_packages_take_the_same_transitions(opts):
    runs = []
    for mod in (jfleet, fleet):
        t = [0.0]
        flips = []
        b = mod.CircuitBreaker(name="b", clock=lambda: t[0],
                               on_transition=lambda n, old, new: flips.append((old, new)),
                               **opts)
        trace = []
        for step in BREAKER_SCRIPT:
            if step[0] == "t":
                t[0] = step[1]
                got = None
            else:
                got = getattr(b, step[0])()
            trace.append((b.state, got))
        runs.append((trace, flips, b.opens))
    assert runs[1] == runs[0]
    assert runs[0][2] >= 1 and (HALF_OPEN, CLOSED) in runs[0][1]


# ------------------------------------------------------------ http helpers


def _post(url, doc, timeout=30.0):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode())


def _start_server(model_dir, name="m", **server_kw):
    s = ModelServer(port=0, **server_kw)
    s.add_model(name, model_dir=model_dir, place=CPU)
    s.start()
    return s


def _save_mlp(tmp_path, prefix):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="%s_x" % prefix, shape=[6], dtype="float32")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        y = fluid.layers.fc(input=h, size=3, act="softmax")
    model_dir = str(tmp_path / ("%s_model" % prefix))
    with fluid.scope_guard(fluid.Scope(seed=3, place=CPU)):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        fluid.io.save_inference_model(model_dir, ["%s_x" % prefix], [y], exe,
                                      main_program=main)
    return model_dir, "%s_x" % prefix


@pytest.fixture()
def mlp_dir(tmp_path):
    return _save_mlp(tmp_path, "flt")


# ------------------------------------------------------- router integration


def test_router_parity_bit_equal_and_model_version(mlp_dir):
    model_dir, xname = mlp_dir
    servers = [_start_server(model_dir) for _ in range(2)]
    router = Router(port=0, hedge=False, probe_interval_s=60.0)
    rport = router.start()
    try:
        for i, s in enumerate(servers):
            router.register("rep%d" % i, s.url)
        router.probe_once()
        assert sorted(router.stats()["routable"]) == ["rep0", "rep1"]
        doc = {"inputs": {xname: np.random.RandomState(7).rand(3, 6).tolist()}}
        direct = [_post(s.url + "/v1/models/m:predict", doc)[1] for s in servers]
        assert direct[0]["outputs"] == direct[1]["outputs"]
        for _ in range(4):
            code, routed = _post("http://127.0.0.1:%d/v1/models/m:predict" % rport, doc)
            assert code == 200
            assert routed["outputs"] == direct[0]["outputs"]
            assert routed["model_version"] == direct[0]["model_version"]
    finally:
        router.stop()
        for s in servers:
            s.stop()


def test_staleness_gate_routes_only_acked_replicas(mlp_dir, tmp_path):
    from paddle_tpu_torch.online.publisher import ModelPublisher
    from paddle_tpu_torch.online.staleness import write_ack

    model_dir, xname = mlp_dir
    servers = [_start_server(model_dir) for _ in range(2)]
    repo = str(tmp_path / "repo")
    pub = ModelPublisher(repo)
    eng = servers[0]._models["m"].engine
    pub.publish({n: eng.scope.vars[n] for n in eng.param_names()}, 3)
    router = Router(port=0, hedge=False, probe_interval_s=60.0, repo=repo, repo_model="m",
                    total_deadline_s=2.0)
    rport = router.start()
    try:
        router.register("rep0", servers[0].url)
        router.register("rep1", servers[1].url)
        router.probe_once()
        assert router.target_versions() == {"m": 3}
        assert router.stats()["routable"] == []
        doc = {"inputs": {xname: [[0.5] * 6]}}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post("http://127.0.0.1:%d/v1/models/m:predict" % rport, doc, timeout=10.0)
        assert ei.value.code == 503
        write_ack(repo, "rep0", 3, {"train_step": 3})
        router.probe_once()
        assert router.stats()["routable"] == ["rep0"]
        code, _ = _post("http://127.0.0.1:%d/v1/models/m:predict" % rport, doc)
        assert code == 200
        write_ack(repo, "rep1", 3, {"train_step": 3})
        router.probe_once()
        assert router.stats()["routable"] == ["rep0", "rep1"]
        router.set_target_version("m", 4)
        assert router.stats()["routable"] == []
    finally:
        router.stop()
        for s in servers:
            s.stop()


def test_conn_reset_fails_over_to_other_replica(mlp_dir):
    model_dir, xname = mlp_dir
    servers = [_start_server(model_dir) for _ in range(2)]
    router = Router(port=0, hedge=False, probe_interval_s=60.0, seed=5)
    rport = router.start()
    try:
        router.register("rep0", servers[0].url)
        router.register("rep1", servers[1].url)
        router.probe_once()
        faults.install("conn_reset:step=1")
        code, out = _post("http://127.0.0.1:%d/v1/models/m:predict" % rport,
                          {"inputs": {xname: [[0.25] * 6]}})
        assert code == 200 and "outputs" in out
        assert router._m_retries.value(kind="predict") >= 1
        failed = [n for n, r in router.replicas().items() if r.requests_failed > 0]
        assert len(failed) == 1
    finally:
        faults.install(None)
        router.stop()
        for s in servers:
            s.stop()


def test_breaker_opens_on_broken_replica_then_recloses(mlp_dir):
    model_dir, xname = mlp_dir
    servers = [_start_server(model_dir) for _ in range(2)]
    router = Router(port=0, hedge=False, probe_interval_s=60.0, seed=3,
                    breaker_opts=dict(failure_threshold=2, open_for_s=0.05, success_threshold=1),
                    retry_budget_ratio=1.0)
    rport = router.start()
    try:
        router.register("rep0", servers[0].url)
        router.register("rep1", servers[1].url)
        router.probe_once()
        eng = servers[0]._models["m"].engine
        orig_run = eng.run

        def broken(feed):
            raise RuntimeError("injected engine brown-out")

        eng.run = broken
        doc = {"inputs": {xname: [[0.1] * 6]}}
        url = "http://127.0.0.1:%d/v1/models/m:predict" % rport
        for _ in range(12):
            code, _out = _post(url, doc)
            assert code == 200
        rep0 = router.replicas()["rep0"]
        assert rep0.breaker.stats()["opens"] >= 1
        assert router._m_breaker.value(replica="rep0", to="open") >= 1
        eng.run = orig_run
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            _post(url, doc)
            if rep0.breaker.state == CLOSED and rep0.requests_ok > 0:
                break
            time.sleep(0.05)
        assert rep0.breaker.state == CLOSED
        assert rep0.requests_ok > 0
    finally:
        router.stop()
        for s in servers:
            s.stop()


def test_hedged_predict_first_wins_and_loser_unpunished(mlp_dir):
    model_dir, xname = mlp_dir
    servers = [_start_server(model_dir) for _ in range(2)]
    router = Router(port=0, hedge=True, hedge_delay_ms=60.0,
                    hedge_after_observations=10 ** 9, probe_interval_s=60.0, seed=1)
    rport = router.start()
    eng0 = servers[0]._models["m"].engine
    orig = eng0.run
    try:
        router.register("rep0", servers[0].url)
        router.register("rep1", servers[1].url)
        router.probe_once()
        doc = {"inputs": {xname: [[0.9] * 6]}}
        url = "http://127.0.0.1:%d/v1/models/m:predict" % rport
        _code, baseline = _post(url, doc)
        eng0.run = lambda feed: (time.sleep(0.5), orig(feed))[1]
        t0 = time.perf_counter()
        wins_before = router._m_hedges.value(event="won")
        for _ in range(6):
            code, out = _post(url, doc)
            assert code == 200
            assert out["outputs"] == baseline["outputs"]
        assert time.perf_counter() - t0 < 2.5
        assert router._m_hedges.value(event="launched") >= 1
        rep0 = router.replicas()["rep0"]
        assert rep0.breaker.stats()["opens"] == 0
        assert rep0.requests_failed == 0
        assert router._m_hedges.value(event="won") > wins_before
    finally:
        eng0.run = orig
        router.stop()
        for s in servers:
            s.stop()


def test_drain_then_stop_drops_nothing(mlp_dir):
    model_dir, xname = mlp_dir
    servers = [_start_server(model_dir) for _ in range(2)]
    router = Router(port=0, hedge=False, probe_interval_s=60.0, seed=2)
    rport = router.start()
    results = []
    stop = threading.Event()

    def client():
        doc = {"inputs": {xname: [[0.3] * 6]}}
        url = "http://127.0.0.1:%d/v1/models/m:predict" % rport
        while not stop.is_set():
            try:
                code, _ = _post(url, doc)
                results.append(code)
            except Exception as e:
                results.append(repr(e))

    try:
        router.register("rep0", servers[0].url)
        router.register("rep1", servers[1].url)
        router.probe_once()
        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        assert router.drain("rep0", wait_s=10.0)
        assert router.replicas()["rep0"].inflight == 0
        servers[0].stop()
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(10.0)
        assert len(results) > 20
        assert all(code == 200 for code in results), results[:10]
        assert router.replicas()["rep1"].requests_ok > 0
    finally:
        stop.set()
        router.stop()
        for s in servers:
            s.stop()


# ------------------------------------------------- subprocess chaos (SIGKILL)


def _runs_the_port(rep):
    """The child's own report and its command line both name the port."""
    info = rep.info()
    assert info["package"] == "paddle_tpu_torch" and info["device"] == "cpu"
    with open("/proc/%d/cmdline" % info["pid"], "rb") as f:
        argv = f.read().split(b"\0")
    assert b"paddle_tpu_torch.fleet.replica" in argv, argv


def test_sigkill_mid_request_failover_and_rejoin(tmp_path):
    """REAL process death: two `paddle_tpu_torch.fleet.replica` children on
    the CPU, one armed to SIGKILL itself on its first request. Every client
    request still gets a 200 via failover; the killed replica goes DOWN at
    the router, and a restart rejoins the pool."""
    model_dir, xname = _save_mlp(tmp_path, "kfl")
    spec = lambda name: {
        "name": name, "place": "cpu", "request_timeout_ms": 10000.0,
        "predict": {"model": "m", "model_dir": model_dir},
    }
    exit_file = str(tmp_path / "kr1.exit.json")
    fault_file = str(tmp_path / "kr1.faults")
    reps = [ReplicaProcess(spec("kr0"), str(tmp_path), faults="replica_kill:step=1"),
            ReplicaProcess(dict(spec("kr1"), exit_file=exit_file, fault_file=fault_file),
                           str(tmp_path))]
    router = Router(port=0, hedge=False, probe_interval_s=0.2, seed=4,
                    total_deadline_s=30.0, attempt_timeout_s=10.0, down_after=2)
    rport = router.start()
    try:
        for r in reps:
            r.start()
        for r in reps:
            r.wait_ready(timeout=180.0)
            _runs_the_port(r)
            router.register(r.name, r.url)
        router.probe_once()
        assert sorted(router.stats()["routable"]) == ["kr0", "kr1"]
        doc = {"inputs": {xname: [[0.7] * 6]}}
        url = "http://127.0.0.1:%d/v1/models/m:predict" % rport
        codes = [_post(url, doc, timeout=60.0)[0] for _ in range(10)]
        assert codes == [200] * 10
        deadline = time.monotonic() + 30.0
        while reps[0].alive() and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not reps[0].alive()
        router.probe_once()
        router.probe_once()
        assert router.stats()["routable"] == ["kr1"]
        reps[0]._extra_env.pop(faults.ENV_VAR, None)
        reps[0].restart()
        reps[0].wait_ready(timeout=180.0)
        _runs_the_port(reps[0])
        router.register(reps[0].name, reps[0].url)
        router.probe_once()
        assert sorted(router.stats()["routable"]) == ["kr0", "kr1"]
        codes = [_post(url, doc, timeout=60.0)[0] for _ in range(4)]
        assert codes == [200] * 4
        # a fault plan armed in the running kr1 through its fault file: its
        # resets fail over, then the plan is dropped with the file
        with open(fault_file, "w") as f:
            f.write("conn_reset:every=2")
        time.sleep(0.5)
        direct = [urllib.request.Request(
            reps[1].url + "/v1/models/m:predict", data=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"}) for _ in range(2)]
        outcomes = []
        for req in direct:
            try:
                outcomes.append(urllib.request.urlopen(req, timeout=30).status)
            except Exception as e:
                outcomes.append(type(e).__name__)
        assert outcomes[0] == 200 and outcomes[1] != 200, outcomes
        os.remove(fault_file)
        time.sleep(0.5)
        assert [_post(reps[1].url + "/v1/models/m:predict", doc)[0] for _ in range(2)] == \
            [200, 200]
        # a polite stop: the child drains, exits 0 and reports at its exit
        assert reps[1].terminate() == 0
        report = json.load(open(exit_file))
        assert report["package"] == "paddle_tpu_torch" and report["name"] == "kr1"
        assert not any(report["paged_launches"].values())  # no kernel on the CPU
    finally:
        router.stop()
        for r in reps:
            try:
                r.kill()
            except Exception:
                pass


def test_replica_without_place_fails_to_boot_without_a_card(tmp_path):
    """A spec with no "place" asks for the card: on a machine without one the
    child raises before it serves and exits non-zero, never serving on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    model_dir, _ = _save_mlp(tmp_path, "np")
    rep = ReplicaProcess({"name": "nocard", "predict": {"model": "m", "model_dir": model_dir}},
                         str(tmp_path))
    rep.start()
    try:
        with pytest.raises(RuntimeError, match="exited rc=1 before ready"):
            rep.wait_ready(timeout=120.0)
    finally:
        rep.kill()
    log = open(rep.log_path).read()
    assert "no CUDA device" in log, log[-2000:]
    assert not os.path.exists(rep.port_file)


# ------------------------------------------------ against the JAX package


def test_router_matches_jax_router(mlp_dir):
    """The same saved MLP behind the port's Router (two port ModelServers)
    and the JAX package's Router (two JAX ModelServers): replies within rtol
    1e-5, atol 1e-6 and the same model_version, through each router."""
    model_dir, xname = mlp_dir
    port_servers = [_start_server(model_dir) for _ in range(2)]
    jax_servers = []
    for _ in range(2):
        s = JModelServer(port=0)
        s.add_model("m", model_dir=model_dir)
        s.start()
        jax_servers.append(s)
    routers = [(Router(port=0, hedge=False, probe_interval_s=60.0), port_servers),
               (jfleet.Router(port=0, hedge=False, probe_interval_s=60.0), jax_servers)]
    try:
        urls = []
        for router, servers in routers:
            rport = router.start()
            for i, s in enumerate(servers):
                router.register("rep%d" % i, s.url)
            router.probe_once()
            assert sorted(router.stats()["routable"]) == ["rep0", "rep1"]
            urls.append("http://127.0.0.1:%d/v1/models/m:predict" % rport)
        rng = np.random.RandomState(11)
        for rows in (1, 3, 5):
            doc = {"inputs": {xname: rng.rand(rows, 6).tolist()}}
            (pc, port_out), (jc, jax_out) = (_post(u, doc) for u in urls)
            assert pc == jc == 200
            assert port_out["model_version"] == jax_out["model_version"]
            assert sorted(port_out["outputs"]) == sorted(jax_out["outputs"])
            for k in port_out["outputs"]:
                np.testing.assert_allclose(np.asarray(port_out["outputs"][k]),
                                           np.asarray(jax_out["outputs"][k]),
                                           rtol=RTOL, atol=ATOL)
        assert routers[0][0].stats()["target_versions"] == routers[1][0].stats()[
            "target_versions"]
    finally:
        for router, servers in routers:
            router.stop()
            for s in servers:
                s.stop()
