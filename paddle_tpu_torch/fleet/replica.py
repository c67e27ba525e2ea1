"""Replica child process + launcher for the serving fleet (the torch port
of paddle_tpu/fleet/replica.py).

`python -m paddle_tpu_torch.fleet.replica <spec.json>` boots ONE ModelServer from
a declarative spec and serves until SIGTERM (drain + exit 0) or SIGKILL
(the chaos case — no goodbye, in-flight requests fail over at the router).
`ReplicaProcess` is the parent-side handle chip_smoke.py and the fleet tests use
to spawn/kill/restart replicas as real OS processes — a SIGKILLed thread is
not a thing, so fleet failover can only be exercised with subprocesses.

Spec (JSON):
  name                 replica name == HotReloader consumer == ack identity
  host, port           bind address (port 0 = ephemeral; see port_file)
  request_timeout_ms   ModelServer request timeout
  predict: {model, model_dir, cache_dir?, batch_buckets?, batcher_opts?}
  generate: {model, model_kw, seed?, max_slots?, page_size?, max_context?,
             scheduler_opts?}        (GPTDecoder; seed fixes the params, so
                                      same-seed replicas decode bit-equal)
  repo, poll_interval_s  model repository to follow: a HotReloader applies
                         published versions to the predict engine and acks
                         as `name` — the router's staleness gate reads
                         those acks
  port_file            where to atomically write {"port", "url", "pid"}
                       once serving (the parent's readiness rendezvous)
  router_url           optional: self-register with the fleet router
  place                "cpu" serves on the CPU; absent (or "cuda" /
                       "cuda:N") serves on the card, and on a machine
                       without one the child raises before it serves and
                       exits non-zero — it never carries on on the CPU
  exit_file            optional: where the child writes, at its SIGTERM
                       exit, its paged kernels' launches since it was
                       ready, its boot seconds and its device memory
                       reserved
  fault_file           optional: a fault plan (resilience.faults grammar)
                       the child installs whenever the file's text changes
                       and drops when the file goes (polled every 50 ms by
                       a thread that runs only when the key is set), so a
                       parent arms and disarms faults in a running replica.
                       PADDLE_TPU_FAULTS is read once, at start, and a
                       replica on the card boots in 12-30 s (NVIDIA H100
                       80GB HBM3, 700 W): a restart for each fault round
                       would cost more than the round itself

The port file names the package the child runs ("package") beside its
boot seconds and, on the card, the memory it reserved once ready. Both
entry points stay import-light at module load so the launcher can be
imported without paying for torch until a replica actually boots.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

__all__ = ["ReplicaProcess", "main"]

# the module a ReplicaProcess child runs: this package's, never the JAX one
CHILD_MODULE = __package__ + ".replica"
PACKAGE = __package__.split(".")[0]


def _atomic_json(path, doc):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _register_with_router(router_url, name, url, attempts=10):
    import http.client

    from .health import parse_url

    host, port = parse_url(router_url)
    body = json.dumps({"name": name, "url": url}).encode()
    for i in range(attempts):
        try:
            conn = http.client.HTTPConnection(host, port, timeout=2.0)
            try:
                conn.request("POST", "/fleet/register", body=body,
                             headers={"Content-Type": "application/json"})
                if conn.getresponse().status == 200:
                    return True
            finally:
                conn.close()
        except OSError:
            pass
        time.sleep(0.1 * (i + 1))
    return False


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m %s <spec.json>" % CHILD_MODULE,
              file=sys.stderr)
        return 2
    t_boot = time.perf_counter()
    with open(argv[0]) as f:
        spec = json.load(f)

    from ..place import to_device
    from ..serving import ModelServer

    place = _place(spec.get("place"))
    device = to_device(place)  # no card and no "place": "cpu" raises here

    name = spec.get("name", "replica")
    server = ModelServer(
        host=spec.get("host", "127.0.0.1"),
        port=int(spec.get("port", 0)),
        request_timeout_ms=float(spec.get("request_timeout_ms", 5000.0)),
    )
    engines = {}

    p = spec.get("predict")
    if p:
        kw = {}
        if p.get("cache_dir"):
            kw["cache_dir"] = p["cache_dir"]
        if p.get("batch_buckets"):
            kw["batch_buckets"] = tuple(p["batch_buckets"])
        eng = server.add_model(
            p["model"], model_dir=p["model_dir"],
            batcher_opts=p.get("batcher_opts"), place=place, **kw
        )
        engines[p["model"]] = eng

    g = spec.get("generate")
    if g:
        from ..executor import Scope
        from ..models.gpt_decoder import GPTDecoder

        model = GPTDecoder(**g.get("model_kw", {}))
        server.add_generation_model(
            g["model"], model=model,
            scope=Scope(seed=int(g.get("seed", 0)), place=place),
            place=place,
            max_slots=int(g.get("max_slots", 4)),
            page_size=int(g.get("page_size", 8)),
            max_context=g.get("max_context"),
            scheduler_opts=g.get("scheduler_opts"),
        )

    reloader = None
    if spec.get("repo") and engines:
        from ..online.reloader import HotReloader

        reloader = HotReloader(
            spec["repo"], engines, consumer=name,
            poll_interval_s=float(spec.get("poll_interval_s", 0.2)),
        )
        reloader.check_once()  # land whatever is already published, pre-ack
        reloader.start()

    from ..ops import paged_flash

    paged_flash.reset_kernel_launches()  # count what serving launches
    port = server.start()
    boot_s = time.perf_counter() - t_boot
    if spec.get("port_file"):
        _atomic_json(spec["port_file"], {
            "name": name, "port": port, "url": server.url, "pid": os.getpid(),
            "package": PACKAGE, "device": str(device), "boot_s": boot_s,
            "memory_reserved_bytes": _reserved(device),
        })
    if spec.get("router_url"):
        _register_with_router(spec["router_url"], name, server.url)

    done = threading.Event()
    if spec.get("fault_file"):
        threading.Thread(target=_watch_faults, args=(spec["fault_file"], done),
                         name="replica-faults", daemon=True).start()

    def _term(signum, frame):
        done.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    done.wait()
    if reloader is not None:
        reloader.stop()
    server.stop(drain=True)
    if spec.get("exit_file"):
        _atomic_json(spec["exit_file"], {
            "name": name, "pid": os.getpid(), "package": PACKAGE,
            "boot_s": boot_s, "memory_reserved_bytes": _reserved(device),
            "paged_launches": paged_flash.kernel_launches(),
        })
    return 0


def _watch_faults(path, done, poll_s=0.05):
    """Install the fault plan in `path` whenever its text changes; drop it
    when the file goes."""
    from ..resilience import faults

    last = None
    while not done.wait(poll_s):
        try:
            with open(path) as f:
                text = f.read().strip()
        except OSError:
            text = None
        if text != last:
            faults.install(text or None)
            last = text


def _place(spec_place):
    """The spec's "place": "cpu", or the card ("cuda", "cuda:N", absent)."""
    from ..place import CPUPlace, CUDAPlace

    if spec_place is None:
        return CUDAPlace(0)
    text = str(spec_place)
    if text == "cpu":
        return CPUPlace()
    if text == "cuda" or text.startswith("cuda:"):
        return CUDAPlace(int(text.partition(":")[2] or 0))
    raise ValueError("replica spec place %r: 'cpu', 'cuda' or 'cuda:N'" % (spec_place,))


def _reserved(device):
    if device.type != "cuda":
        return 0
    import torch

    return int(torch.cuda.memory_reserved(device))


class ReplicaProcess:
    """Parent-side handle on one replica subprocess.

    start() writes the spec + spawns the child; wait_ready() blocks on the
    port-file rendezvous and then on /healthz ready; kill() is SIGKILL (the
    chaos primitive); terminate() is the polite SIGTERM drain. restart()
    re-spawns with the same spec — same name, so after its HotReloader
    re-acks, the router's staleness gate lets it rejoin.
    """

    def __init__(self, spec, workdir, env=None, faults=None):
        self.spec = dict(spec)
        self.workdir = workdir
        self.name = self.spec.get("name", "replica")
        self.spec_path = os.path.join(workdir, "%s.spec.json" % self.name)
        self.port_file = os.path.join(workdir, "%s.port.json" % self.name)
        self.log_path = os.path.join(workdir, "%s.log" % self.name)
        self.spec["port_file"] = self.port_file
        self._extra_env = dict(env or {})
        if faults:
            from ..resilience.faults import ENV_VAR

            self._extra_env[ENV_VAR] = faults
        self.proc = None
        self._log = None

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self.proc is not None and self.proc.poll() is None:
            raise RuntimeError("replica %s already running" % self.name)
        try:
            os.remove(self.port_file)  # stale rendezvous from a prior run
        except OSError:
            pass
        _atomic_json(self.spec_path, self.spec)
        env = dict(os.environ)
        env.update(self._extra_env)
        # the child imports this package from the directory that holds it,
        # wherever the parent runs from
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        self._log = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", CHILD_MODULE, self.spec_path],
            stdout=self._log, stderr=subprocess.STDOUT, env=env,
        )
        return self

    def wait_ready(self, timeout=120.0):
        """Block until the child serves AND reports ready; returns its url."""
        import http.client

        deadline = time.monotonic() + float(timeout)
        port = None
        while time.monotonic() < deadline:
            if self.proc is not None and self.proc.poll() is not None:
                raise RuntimeError(
                    "replica %s exited rc=%d before ready (log: %s)"
                    % (self.name, self.proc.returncode, self.log_path)
                )
            if port is None:
                try:
                    with open(self.port_file) as f:
                        port = json.load(f)["port"]
                except (OSError, ValueError, KeyError):
                    time.sleep(0.05)
                    continue
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=2.0)
                try:
                    conn.request("GET", "/healthz")
                    doc = json.loads(conn.getresponse().read().decode())
                finally:
                    conn.close()
                if doc.get("ready"):
                    return self.url
            except (OSError, ValueError):
                pass
            time.sleep(0.05)
        raise TimeoutError(
            "replica %s not ready in %.0fs (log: %s)"
            % (self.name, timeout, self.log_path)
        )

    def info(self):
        """The child's port file: its port, url, pid, package, device, boot
        seconds and memory reserved."""
        with open(self.port_file) as f:
            return json.load(f)

    @property
    def port(self):
        return self.info()["port"]

    @property
    def url(self):
        return "http://127.0.0.1:%d" % self.port

    def alive(self):
        return self.proc is not None and self.proc.poll() is None

    def kill(self):
        """SIGKILL — no drain, no handlers; the chaos primitive."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(10.0)
        self._close_log()

    def terminate(self, timeout=30.0):
        """SIGTERM — the child drains its batchers and exits 0."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(10.0)
        self._close_log()
        return self.proc.returncode if self.proc is not None else None

    def restart(self):
        """Spawn a fresh process from the same spec (post-kill rejoin)."""
        if self.alive():
            raise RuntimeError("replica %s still running" % self.name)
        self._close_log()
        return self.start()

    def _close_log(self):
        if self._log is not None:
            try:
                self._log.close()
            except OSError:
                pass
            self._log = None


if __name__ == "__main__":
    sys.exit(main())
