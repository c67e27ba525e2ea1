"""The rest of serving in the torch port (paddle_tpu_torch/serving/server.py,
compile_cache.py, the engines' trailing_pad, set_params and cache_dir,
resilience/faults.py and observability/flightrec.py) on the CPU, against
the JAX package at the small sizes of tests/test_serving.py.

- The ModelServer over HTTP on 127.0.0.1 (port 0) hosting two models, an
  MLP saved by the JAX package and a small GPTDecoder carrying the JAX
  engine's parameters: the JAX server and the port's, given the same
  requests, give equal :predict outputs (rtol 1e-5, atol 1e-6, JSON and
  npz) and equal greedy :generate tokens; the routes, readiness and
  /metrics by code.
- The compile cache's second boot (tests/test_serving.py:273): no
  preparation, one hit per bucket, equal outputs; a torn entry is a miss.
- trailing_pad "exact" against "pow2" (tests/test_serving.py:165).
- set_params on both engines, each reply naming its version, and the
  swapped engine equal to one built on the new parameters.
- The three fault hooks (slow_response, conn_reset, replica_kill in a
  child process) and the 503 / 504 mapping with Retry-After, the 5xx
  flight-recorder bundle.

Every HTTP call has a client timeout and every server is stopped in a
`finally`.
"""

import io as stdio
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import framework as jframework
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu.models.gpt_decoder import GPTDecoder as JaxGPTDecoder
from paddle_tpu.serving import GenerationEngine as JaxGenerationEngine
from paddle_tpu.serving import ModelServer as JaxModelServer
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch import CPUPlace, convert
from paddle_tpu_torch import flags as pt_flags
from paddle_tpu_torch.models import GPTDecoder
from paddle_tpu_torch.observability import flightrec
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import (
    GenerationEngine,
    ModelServer,
    ServingEngine,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60  # seconds, every client call
GPT_KW = dict(vocab_size=24, n_layer=2, n_head=2, d_model=16, d_inner=32, max_context=16)
GEN_KW = dict(max_slots=2, page_size=4, max_context=16, prefill_buckets=(4, 8))
NO_EOS = 999


def _save_mlp(tmp_path, name="m", width=6, out_dim=3, seed=3, prefix="srv"):
    """The JAX package's small softmax MLP, saved by its io (the format the
    port loads)."""
    main, startup = jframework.Program(), jframework.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        x = jfluid.layers.data(name="%s_x" % prefix, shape=[width], dtype="float32")
        h = jfluid.layers.fc(input=x, size=8, act="relu")
        y = jfluid.layers.fc(input=h, size=out_dim, act="softmax")
    exe = jfluid.Executor(jfluid.CPUPlace())
    model_dir = str(tmp_path / name)
    scope = JScope(seed=seed)
    with jscope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(model_dir, ["%s_x" % prefix], [y], exe, main_program=main)
    return model_dir, main, scope, "%s_x" % prefix, y.name


def _save_seq_mlp(tmp_path, name="sq", width=6, out_dim=3, seed=5, prefix="sq"):
    """A softmax MLP over a mean-pooled dynamic sequence dim: zero rows
    padded along it change the mean (tests/test_serving.py:140)."""
    main, startup = jframework.Program(), jframework.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        x = jfluid.layers.data(name="%s_x" % prefix, shape=[-1, width], dtype="float32")
        pooled = jfluid.layers.reduce_mean(x, dim=1)
        y = jfluid.layers.fc(input=pooled, size=out_dim, act="softmax")
    exe = jfluid.Executor(jfluid.CPUPlace())
    model_dir = str(tmp_path / name)
    scope = JScope(seed=seed)
    with jscope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(model_dir, ["%s_x" % prefix], [y], exe, main_program=main)
    return model_dir, main, scope, "%s_x" % prefix, y.name


def _http(base, path, body=None, ctype="application/json", timeout=TIMEOUT):
    """(code, headers, body bytes) of one call; HTTP errors come back as
    their code, not raised."""
    req = urllib.request.Request(base + path, data=body,
                                 headers={"Content-Type": ctype} if body is not None else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _predict_json(base, model, feed):
    body = json.dumps({"inputs": {k: np.asarray(v).tolist() for k, v in feed.items()}}).encode()
    code, _, out = _http(base, "/v1/models/%s:predict" % model, body)
    assert code == 200, out
    return json.loads(out)


def _predict_npz(base, model, feed):
    buf = stdio.BytesIO()
    np.savez(buf, **feed)
    code, headers, out = _http(base, "/v1/models/%s:predict" % model, buf.getvalue(),
                               ctype="application/x-npz")
    assert code == 200 and headers["Content-Type"] == "application/x-npz"
    got = np.load(stdio.BytesIO(out))
    return [got[k] for k in got.files]


def _generate(base, model, prompt, **kw):
    code, _, out = _http(base, "/v1/models/%s:generate" % model,
                         json.dumps(dict(prompt=prompt, **kw)).encode())
    assert code == 200, out
    return json.loads(out)


@pytest.fixture
def fresh_faults():
    faults.install(None)
    yield
    faults.reset()


def _gpt_pair():
    """(JAX engine, port engine on the CPU carrying the JAX parameters)."""
    jeng = JaxGenerationEngine(JaxGPTDecoder(**GPT_KW), name="ts_gpt_jax", cache_dir=None,
                               **GEN_KW)
    model = GPTDecoder(**GPT_KW)
    peng = GenerationEngine(model, name="ts_gpt_port", place=CPUPlace(), **GEN_KW)
    arrays = {n: np.asarray(jeng.scope.vars[n]) for n in model.param_names()}
    convert.load_into_scope(peng.scope, arrays, model.param_names())
    return jeng, peng


def test_model_server_matches_jax_server(tmp_path):
    """Two models behind each server; the same requests give equal outputs
    and tokens, and the port's routes answer as the JAX server's do."""
    md, _, _, xname, yname = _save_mlp(tmp_path, prefix="hs")
    jeng, peng = _gpt_pair()
    jsrv, psrv = JaxModelServer(port=0), ModelServer(port=0)
    try:
        jsrv.add_model("mlp", md, batch_buckets=(1, 2, 4))
        psrv.add_model("mlp", md, batch_buckets=(1, 2, 4), place=CPUPlace())
        jsrv.add_generation_model("gpt", engine=jeng)
        psrv.add_generation_model("gpt", engine=peng)
        jbase = "http://127.0.0.1:%d" % jsrv.start()
        pbase = "http://127.0.0.1:%d" % psrv.start()
        rng = np.random.RandomState(7)
        for rows in (1, 3, 4, 7):
            x = rng.randn(rows, 6).astype("float32")
            if rows > 4:  # past the top bucket: the batcher refuses, 400
                code, _, _ = _http(pbase, "/v1/models/mlp:predict",
                                   json.dumps({"inputs": {xname: x.tolist()}}).encode())
                assert code == 400
                continue
            want = _predict_json(jbase, "mlp", {xname: x})
            got = _predict_json(pbase, "mlp", {xname: x})
            assert list(got["outputs"]) == [yname] and got["model_version"] == 0
            np.testing.assert_allclose(np.asarray(got["outputs"][yname], np.float32),
                                       np.asarray(want["outputs"][yname], np.float32),
                                       rtol=1e-5, atol=1e-6)
            (wz,) = _predict_npz(jbase, "mlp", {xname: x})
            (gz,) = _predict_npz(pbase, "mlp", {xname: x})
            assert gz.shape == (rows, 3) and gz.dtype == np.float32
            np.testing.assert_allclose(gz, wz, rtol=1e-5, atol=1e-6)
        for prompt, n in (([3, 7, 11, 2, 9], 4), ([1, 2], 6), ([9, 8, 7, 6, 5, 4, 3, 2, 1], 3)):
            want = _generate(jbase, "gpt", prompt, max_new_tokens=n, eos_id=NO_EOS)
            got = _generate(pbase, "gpt", prompt, max_new_tokens=n, eos_id=NO_EOS)
            assert got["tokens"] == want["tokens"] and len(got["tokens"]) == n
            assert got["finish_reason"] == want["finish_reason"] == "length"
            assert got["prompt_len"] == len(prompt) and got["model_version"] == 0
        # seeded sampling repeats itself
        a = _generate(pbase, "gpt", [4, 5, 6], max_new_tokens=5, temperature=1.3, seed=11)
        b = _generate(pbase, "gpt", [4, 5, 6], max_new_tokens=5, temperature=1.3, seed=11)
        assert a["tokens"] == b["tokens"]

        code, _, body = _http(pbase, "/healthz")
        health = json.loads(body)
        assert code == 200 and health["ready"] is True
        assert health["models"]["mlp"]["kind"] == "predict"
        assert health["models"]["gpt"]["kind"] == "generate"
        assert set(json.loads(_http(pbase, "/healthz?verbose=0")[2])["models"]) == {"mlp", "gpt"}
        models = json.loads(_http(pbase, "/v1/models")[2])
        assert models["mlp"]["feeds"] == [xname] and models["mlp"]["batch_buckets"] == [1, 2, 4]
        assert models["gpt"]["kind"] == "generate"
        assert _http(pbase, "/v1/models/nope")[0] == 404
        assert _http(pbase, "/v1/models/nope:predict", b"{}")[0] == 404
        assert _http(pbase, "/v1/models/gpt:predict", b"{}")[0] == 400
        assert _http(pbase, "/v1/models/mlp:generate", b'{"prompt": [1]}')[0] == 400
        assert _http(pbase, "/v1/models/mlp:predict", b"not json")[0] == 400
        assert _http(pbase, "/nowhere")[0] == 404
        prom = _http(pbase, "/metrics")[2].decode()
        assert "serving_http_requests" in prom
        assert 'code="200"' in prom and 'code="404"' in prom and 'code="400"' in prom
    finally:
        jsrv.stop(drain=True)
        assert psrv.stop(drain=True)


def test_compile_cache_hit_on_second_boot(tmp_path):
    """First boot prepares every bucket and writes artifacts; a second
    engine on the same cache dir prepares none, hits every bucket and
    serves the same outputs (tests/test_serving.py:273). A torn entry is a
    miss, prepared again."""
    model_dir, _, _, xname, _ = _save_mlp(tmp_path, prefix="cc")
    cache_dir = str(tmp_path / "cache")
    feed = {xname: np.random.RandomState(3).rand(2, 6).astype("float32")}

    eng1 = ServingEngine(model_dir, name="cc1", batch_buckets=(1, 2), cache_dir=cache_dir,
                         place=CPUPlace())
    eng1.warmup()
    assert eng1.traces == 2 and eng1.cache_hits == 0
    (out1,) = eng1.run(feed)

    eng2 = ServingEngine(model_dir, name="cc2", batch_buckets=(1, 2), cache_dir=cache_dir,
                         place=CPUPlace())
    eng2.warmup()
    assert eng2.traces == 0, "second boot must not prepare"
    assert eng2.cache_hits == 2
    (out2,) = eng2.run(feed)
    np.testing.assert_array_equal(out2, out1)
    jeng = JaxServingEngine(model_dir, name="cc_jax", batch_buckets=(1, 2), cache_dir=None)
    (want,) = jeng.run(feed)
    np.testing.assert_allclose(out2, np.asarray(want), rtol=1e-5, atol=1e-6)

    entries = sorted(f for f in os.listdir(cache_dir) if f.endswith(".variant.json"))
    assert len(entries) == 2
    with open(os.path.join(cache_dir, entries[0]), "w") as f:
        f.write('{"key": "torn"')
    eng3 = ServingEngine(model_dir, name="cc3", batch_buckets=(1, 2), cache_dir=cache_dir,
                         place=CPUPlace())
    eng3.warmup()
    assert (eng3.traces, eng3.cache_hits) == (1, 1)
    np.testing.assert_array_equal(eng3.run(feed)[0], out1)
    assert eng3.stats()["cache"]["hits"] >= 3


def test_generation_compile_cache_second_boot(tmp_path):
    """The GenerationEngine on a cache dir: the second boot prepares no
    variant, hits each (the decode step and every prefill bucket) and
    generates the same tokens."""
    cache_dir = str(tmp_path / "gcache")
    toks = []
    for boot in range(2):
        eng = GenerationEngine(GPTDecoder(**GPT_KW), name="gc%d" % boot, place=CPUPlace(),
                               cache_dir=cache_dir, **GEN_KW)
        eng.warmup()
        n = 1 + len(eng.prefill_buckets)
        assert (eng.traces, eng.cache_hits) == ((n, 0) if boot == 0 else (0, n))
        toks.append(eng.generate([3, 1, 4, 1, 5, 9], max_new_tokens=5, eos_id=NO_EOS).tokens)
    assert toks[0] == toks[1]
    # another geometry keys apart: a miss for every variant
    other = GenerationEngine(GPTDecoder(**GPT_KW), name="gc_other", place=CPUPlace(),
                             cache_dir=cache_dir, **dict(GEN_KW, max_slots=3))
    other.warmup()
    assert other.cache_hits == 0 and other.traces == 1 + len(other.prefill_buckets)


def test_trailing_pad_policies(tmp_path):
    """trailing_pad='exact' serves a sequence-reducing model exactly at
    lengths that are not powers of two; 'pow2' pads them and visibly
    changes its output (tests/test_serving.py:165)."""
    model_dir, main, scope, xname, yname = _save_seq_mlp(tmp_path)
    rng = np.random.RandomState(11)
    feed5 = {xname: rng.rand(3, 5, 6).astype("float32")}
    feed7 = {xname: rng.rand(2, 7, 6).astype("float32")}
    with jscope_guard(scope):
        (ref5,) = jfluid.Executor().run(main, feed=feed5, fetch_list=[yname])
        (ref7,) = jfluid.Executor().run(main, feed=feed7, fetch_list=[yname])

    eng = ServingEngine(model_dir, name="tsq", batch_buckets=(1, 2, 4), place=CPUPlace())
    assert eng.trailing_pad == "exact" and eng.stats()["trailing_pad"] == "exact"
    (out5,) = eng.run(feed5)
    (out7,) = eng.run(feed7)
    np.testing.assert_allclose(out5, np.asarray(ref5), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out7, np.asarray(ref7), rtol=1e-5, atol=1e-6)
    assert eng._bucket_shape(xname, (3, 5, 6)) == (4, 5, 6)
    assert eng.stats()["variants"] == 2  # one per (bucket, trailing shape) seen

    pow2 = ServingEngine(model_dir, name="tsq2", batch_buckets=(1, 2, 4), trailing_pad="pow2",
                         place=CPUPlace())
    assert pow2._bucket_shape(xname, (3, 5, 6)) == (4, 8, 6)
    (p5,) = pow2.run(feed5)
    assert not np.allclose(p5, np.asarray(ref5), rtol=1e-3)
    (p7,) = pow2.run(feed7)
    assert pow2.stats()["variants"] == 2  # lengths 5 and 7 share the 8-wide variant per bucket
    jpow2 = JaxServingEngine(model_dir, name="tsq2_jax", batch_buckets=(1, 2, 4),
                             trailing_pad="pow2", cache_dir=None)
    np.testing.assert_allclose(p5, np.asarray(jpow2.run(feed5)[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p7, np.asarray(jpow2.run(feed7)[0]), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="trailing_pad"):
        ServingEngine(model_dir, trailing_pad="sometimes", place=CPUPlace())


def test_serving_engine_set_params_versions_per_reply(tmp_path):
    """set_params over HTTP: every reply names the version that computed
    it, equal to an engine loaded at that version's parameters (here the
    JAX engine swapped the same way); a KV or unknown name is ignored, a
    shape change raises and leaves the version."""
    md, _, _, xname, yname = _save_mlp(tmp_path, prefix="sp")
    srv = ModelServer(port=0)
    try:
        eng = srv.add_model("mlp", md, batch_buckets=(1, 2, 4), place=CPUPlace())
        jeng = JaxServingEngine(md, name="sp_jax", batch_buckets=(1, 2, 4), cache_dir=None)
        assert eng.param_names() == jeng.param_names()
        base = "http://127.0.0.1:%d" % srv.start()
        x = np.random.RandomState(2).randn(3, 6).astype("float32")
        rng = np.random.RandomState(9)
        for version in (1, 2, 3):
            new = {n: (np.asarray(jeng.scope.vars[n])
                       + rng.randn(*np.shape(jeng.scope.vars[n])).astype("float32") * 0.1)
                   for n in jeng.param_names()}
            assert eng.set_params(dict(new, not_a_param=np.zeros(2)),
                                  stamp={"step": version}) == len(new)
            jeng.set_params(new)
            doc = _predict_json(base, "mlp", {xname: x})
            assert doc["model_version"] == version == eng.model_version
            np.testing.assert_allclose(np.asarray(doc["outputs"][yname], np.float32),
                                       np.asarray(jeng.run({xname: x})[0]), rtol=1e-5, atol=1e-6)
            # this thread never served: the live version, as in the JAX engine
            assert eng.last_served_version() == version
        one = json.loads(_http(base, "/v1/models/mlp")[2])
        assert one["model_version"] == 3 and one["version_stamp"] == {"step": 3}
        name = eng.param_names()[0]
        with pytest.raises(ValueError, match="hot swap"):
            eng.set_params({name: np.zeros((1, 1), np.float32)})
        assert eng.model_version == 3 and eng.stats()["traces"] == len(eng.batch_buckets)
    finally:
        assert srv.stop(drain=True)


def test_generation_set_params_matches_fresh_engine():
    """GenerationEngine.set_params: the swapped engine's greedy tokens equal
    an engine built on the new parameters; the KV pools never swap; each
    :generate reply carries the version; a shape change raises."""
    model = GPTDecoder(**GPT_KW)
    eng = GenerationEngine(model, name="gs_a", place=CPUPlace(), **GEN_KW)
    eng.warmup()
    rng = np.random.RandomState(4)
    new = {n: rng.randn(*eng.scope.vars[n].shape).astype("float32") * 0.2
           for n in model.param_names()}
    fresh = GenerationEngine(GPTDecoder(**GPT_KW), name="gs_b", place=CPUPlace(), **GEN_KW)
    convert.load_into_scope(fresh.scope, new, model.param_names())
    before = eng.generate([2, 3, 5, 7], max_new_tokens=6, eos_id=NO_EOS).tokens
    pools = {n: eng.scope.vars[n].clone() for n in eng._state}
    poison = {n: np.full(tuple(t.shape), 7, t.numpy().dtype) for n, t in pools.items()}
    assert eng.set_params(dict(new, **poison)) == len(new)
    for n, t in pools.items():
        assert eng.scope.vars[n] is eng._state[n]
        np.testing.assert_array_equal(eng.scope.vars[n].numpy(), t.numpy())
    assert eng.model_version == 1 and eng.traces == 1 + len(eng.prefill_buckets)
    want = fresh.generate([2, 3, 5, 7], max_new_tokens=6, eos_id=NO_EOS).tokens
    got = eng.generate([2, 3, 5, 7], max_new_tokens=6, eos_id=NO_EOS).tokens
    assert got == want and got != before
    srv = ModelServer(port=0)
    try:
        srv.add_generation_model("gpt", engine=eng, warmup=False)
        base = "http://127.0.0.1:%d" % srv.start()
        assert _generate(base, "gpt", [1, 2, 3], max_new_tokens=3)["model_version"] == 1
        eng.set_params({}, version=5, stamp={"step": 50})
        assert _generate(base, "gpt", [1, 2, 3], max_new_tokens=3)["model_version"] == 5
        one = json.loads(_http(base, "/v1/models/gpt")[2])
        assert one["model_version"] == 5 and one["version_stamp"] == {"step": 50}
    finally:
        assert srv.stop(drain=True)
    with pytest.raises(ValueError, match="hot swap"):
        eng.set_params({model.param_names()[0]: np.zeros((2, 2), np.float32)})
    assert eng.model_version == 5


def test_fault_hooks_slow_response_and_conn_reset(tmp_path, fresh_faults):
    """slow_response delays the reply by its ms; conn_reset closes the
    socket unanswered (the client sees a reset); the server keeps serving."""
    md, _, _, xname, _ = _save_mlp(tmp_path, prefix="fh")
    srv = ModelServer(port=0)
    try:
        srv.add_model("mlp", md, batch_buckets=(1, 2), place=CPUPlace())
        base = "http://127.0.0.1:%d" % srv.start()
        x = np.ones((1, 6), np.float32)
        _predict_json(base, "mlp", {xname: x})
        faults.install("slow_response:ms=400")
        t0 = time.perf_counter()
        _predict_json(base, "mlp", {xname: x})
        assert time.perf_counter() - t0 >= 0.4
        assert faults.active().count("slow_response") == 1
        faults.install("conn_reset:step=1")
        with pytest.raises((urllib.error.URLError, ConnectionError, OSError)) as e:
            _http(base, "/v1/models/mlp:predict",
                  json.dumps({"inputs": {xname: x.tolist()}}).encode(), timeout=10)
        assert not isinstance(e.value, urllib.error.HTTPError)
        assert faults.active().count("conn_reset") == 1
        _predict_json(base, "mlp", {xname: x})  # step=1 fired once; serving goes on
        faults.install(None)
        assert _http(base, "/healthz")[0] == 200
    finally:
        assert srv.stop(drain=True)


_KILL_CHILD = r"""
import sys
sys.path.insert(0, %(root)r)
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import ModelServer
srv = ModelServer(port=0)
srv.add_model("mlp", %(md)r, batch_buckets=(1,), place=CPUPlace())
port = srv.start()
faults.install("replica_kill:step=2")
print(port, flush=True)
sys.stdin.read()
"""


def test_fault_hook_replica_kill_in_a_child(tmp_path):
    """replica_kill SIGKILLs the serving process at the planned request:
    the first request is answered, the second finds the process dead."""
    md, _, _, xname, _ = _save_mlp(tmp_path, prefix="rk")
    child = subprocess.Popen([sys.executable, "-c", _KILL_CHILD % {"root": ROOT, "md": md}],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        port = int(child.stdout.readline())
        base = "http://127.0.0.1:%d" % port
        body = json.dumps({"inputs": {xname: [[1.0] * 6]}}).encode()
        assert _http(base, "/v1/models/mlp:predict", body)[0] == 200
        with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
            _http(base, "/v1/models/mlp:predict", body, timeout=10)
        assert child.wait(TIMEOUT) == -9
    finally:
        if child.poll() is None:
            child.kill()
        child.wait(TIMEOUT)


def test_full_queue_503_and_timeout_504_with_retry_after(tmp_path, fresh_faults):
    """A blocked engine (its call lock held) fills the batcher's queue: the
    next request gets 503 with Retry-After; a request past the server's
    timeout gets 504 with Retry-After, and the 5xx leaves a flight-recorder
    bundle. Released, the queued requests are answered."""
    md, _, _, xname, _ = _save_mlp(tmp_path, prefix="qf")
    rec_dir = str(tmp_path / "flightrec")
    pt_flags.set_flags({"flightrec_dir": rec_dir, "flightrec_min_interval_s": 0.0})
    flightrec.reset()
    srv = ModelServer(port=0, request_timeout_ms=1500.0)
    eng = srv.add_model("mlp", md, batch_buckets=(1, 2),
                        batcher_opts={"max_queue_rows": 4, "max_batch_delay_ms": 1.0,
                                      "timeout_ms": 30000.0}, place=CPUPlace())
    try:
        base = "http://127.0.0.1:%d" % srv.start()
        body = json.dumps({"inputs": {xname: np.ones((2, 6)).tolist()}}).encode()
        codes, lock = [], threading.Lock()

        def client():
            code, headers, _ = _http(base, "/v1/models/mlp:predict", body)
            with lock:
                codes.append((code, headers.get("Retry-After")))

        eng._swap_lock.acquire()
        try:
            threads = []
            for _ in range(4):
                t = threading.Thread(target=client)
                t.start()
                threads.append(t)
                time.sleep(0.1)
            for t in threads:
                t.join(TIMEOUT)
        finally:
            eng._swap_lock.release()
        got = sorted(c for c, _ in codes)
        assert 503 in got and 504 in got, codes
        assert all(ra is not None and int(ra) >= 1 for c, ra in codes if c in (503, 504))
        batcher = srv._models["mlp"].batcher
        deadline = time.time() + TIMEOUT
        while batcher.stats()["queued_rows"] and time.time() < deadline:
            time.sleep(0.05)  # the timed-out requests drain first
        assert _predict_json(base, "mlp", {xname: np.ones((2, 6))})["model_version"] == 0
        bundles = flightrec.recorder().bundles()
        assert bundles and all(os.path.exists(os.path.join(b, "event.json")) for b in bundles)
        event = json.load(open(os.path.join(bundles[0], "event.json")))
        assert event["reason"] == "http_5xx" and event["info"]["code"] in (503, 504)
        prom = _http(base, "/metrics")[2].decode()
        assert 'code="503"' in prom and 'code="504"' in prom
    finally:
        srv.stop(drain=True)
        pt_flags.set_flags({"flightrec_dir": "", "flightrec_min_interval_s": 2.0})
        flightrec.reset()


def test_swap_under_concurrent_calls_stays_coherent(tmp_path):
    """Stress: 12 threads call run() while another swaps between two
    parameter sets, with a short switch interval: every output equals the
    outputs of the set its call's version names (no call straddles a
    swap)."""
    md, _, _, xname, _ = _save_mlp(tmp_path, prefix="st")
    eng = ServingEngine(md, name="st", batch_buckets=(4,), place=CPUPlace())
    rng = np.random.RandomState(21)
    sets = [{n: rng.randn(*eng.scope.vars[n].shape).astype("float32")
             for n in eng.param_names()} for _ in range(2)]
    x = {xname: rng.randn(4, 6).astype("float32")}
    want = []
    for p in sets:
        eng.set_params(p)
        want.append(eng.run(x)[0])
    assert not np.allclose(want[0], want[1])
    base, stop, errors = eng.model_version, threading.Event(), []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def caller():
        try:
            while not stop.is_set():
                (out,) = eng.run(x)
                k = eng.last_served_version() - base - 1
                np.testing.assert_array_equal(out, want[k % 2] if k >= 0 else want[1])
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=caller) for _ in range(12)]
    try:
        for t in threads:
            t.start()
        for k in range(200):
            eng.set_params(sets[k % 2], version=base + 1 + k)
    finally:
        stop.set()
        for t in threads:
            t.join(TIMEOUT)
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
