"""The port's public API held to the JAX package's paddle_tpu/API.spec (the
reference's API-stability gate, tests/test_api_spec.py), on the CPU:
tools/print_signatures.py lists the port's counterpart of every module it
lists, and each name of those modules must be in the port with the spec's
signature (a class of the port named in a default is read under the JAX
package's name). The differences it allows are named here: what needs no
counterpart off a TPU, the port's added keywords, the port's own
additions, and the names whose modules still wait in ROADMAP queue A (each
must still be missing, so the list shrinks as they land). Also Scope's
drop_kids and the host profiler's defaults, as in the reference.
"""

import importlib
import inspect
import json
import os
import sys

import pytest

from paddle_tpu_torch import Scope, profiler
from paddle_tpu_torch.place import CPUPlace

HERE = os.path.dirname(os.path.abspath(__file__))
SPEC = os.path.join(HERE, "..", "paddle_tpu", "API.spec")
TOOLS = os.path.join(HERE, "..", "tools")
REF, PORT = "paddle_tpu", "paddle_tpu_torch"

# the TPU place and the JAX device / compiled HLO accessors: nothing to
# port to a CUDA card
NO_COUNTERPART = ("TPUPlace", "jax_device", "compiled_hlo")
# the port's keywords beside the spec's: the device of a scope, of an
# imported tensor and of the data runtime's staged batches, and a hot
# swap's table rows, scattered in place (an online delta's rows reach a
# table on the card without the whole table crossing back to the host)
ADDED_KEYWORDS = {"paddle_tpu.fluid.Scope.__init__": "place",
                  "paddle_tpu.lod_tensor.from_dlpack": "place",
                  "paddle_tpu.data.DataRuntime.__init__": "place",
                  "paddle_tpu.serving.ServingEngine.set_params": "rows",
                  "paddle_tpu.serving.GenerationEngine.set_params": "rows"}
# the port's own public names (spec names, as the reference would list them)
PORT_ADDED = {
    "paddle_tpu.fluid.CPUPlace.torch_device", "paddle_tpu.fluid.CUDAPlace.torch_device",
    "paddle_tpu.fluid.CUDAPinnedPlace.torch_device",
    "paddle_tpu.fluid.Executor.stats", "paddle_tpu.fluid.Scope.bind",
    "paddle_tpu.fluid.Scope.reseed", "paddle_tpu.serving.GenerationEngine.captures",
    "paddle_tpu.serving.ServingEngine.run_op_by_op",
    # the child's port file (package, device, boot seconds, memory
    # reserved): how a parent shows its replicas run this package
    "paddle_tpu.fleet.ReplicaProcess.info",
    # a decode or prefill program as a torch.export program (the JAX engine
    # exports each variant it builds with jax.export, inside the engine)
    "paddle_tpu.serving.GenerationEngine.export_variant",
}
# keys of a replica spec (fleet/replica.py's "Spec (JSON)") beside the JAX
# package's: the device a replica serves on (the card unless "cpu"; the JAX
# package forces its replicas onto the CPU platform instead), the file its
# SIGTERM exit reports its kernel launches into, and a fault plan a parent
# arms and disarms while the replica runs (a replica on the card boots in
# tens of seconds, too long to restart one for each fault)
REPLICA_SPEC_ADDED = {"place", "exit_file", "fault_file"}
# names of modules the port has, missing because what defines them waits in
# ROADMAP queue A: (name prefix, the item)
PENDING = ()


def _spec():
    with open(SPEC) as f:
        return dict(ln.split(" ", 1) for ln in f.read().splitlines() if ln.strip())


def _listing():
    """({spec name: signature} of the port's listing, the reference modules
    the port has), by tools/print_signatures.py run over the port's
    counterparts of its modules."""
    sys.path.insert(0, TOOLS)
    try:
        import print_signatures as ps

        ref_modules = list(ps.MODULES)
        ported = []
        for mod in ref_modules:
            try:
                importlib.import_module(PORT + mod[len(REF):])
            except ModuleNotFoundError:
                continue
            ported.append(mod)
        saved = ps.MODULES
        ps.MODULES = [PORT + mod[len(REF):] for mod in ported]
        try:
            lines = ps.collect()
        finally:
            ps.MODULES = saved
    finally:
        sys.path.remove(TOOLS)
    got = {}
    for ln in lines:
        name, sig = ln.split(" ", 1)
        # a default that is a class of the port prints its module path
        # (RetryPolicy's fatal=(<class '...resilience.retry.FatalError'>,)):
        # the spec names the JAX package's module at the same path
        got[REF + name[len(PORT):]] = sig.replace(PORT + ".", REF + ".")
    return got, ref_modules, ported


@pytest.fixture(scope="module")
def api():
    got, ref_modules, ported = _listing()

    def module_of(name):
        owners = [m for m in ref_modules if name.startswith(m + ".")]
        return max(owners, key=len) if owners else None

    spec = {n: s for n, s in _spec().items() if module_of(n) in ported}
    return got, spec


def _no_counterpart(name):
    return any(part in NO_COUNTERPART for part in name.split("."))


def _pending(name):
    return next((item for prefix, item in PENDING if name.startswith(prefix)), None)


def test_api_ported_names_keep_the_spec_signatures(api):
    got, spec = api
    wrong = {}
    for name, sig in spec.items():
        if name not in got or got[name] == sig:
            continue
        kw = ADDED_KEYWORDS.get(name)
        if kw and got[name] == sig[:-1] + ", %s=None)" % kw:
            continue
        wrong[name] = (sig, got[name])
    assert not wrong, wrong
    # the allowed keywords are still the only differences
    for name, kw in ADDED_KEYWORDS.items():
        assert got[name] == spec[name][:-1] + ", %s=None)" % kw, (name, got[name])


def test_api_missing_names_are_accounted_for(api):
    got, spec = api
    missing = [n for n in spec if n not in got]
    unaccounted = [n for n in missing if not _no_counterpart(n) and not _pending(n)]
    assert not unaccounted, unaccounted
    # every pending entry still names something missing: the list shrinks
    # as queue A lands
    stale = [prefix for prefix, _ in PENDING
             if not any(n.startswith(prefix) for n in missing)]
    assert not stale, stale


def test_api_port_additions_are_the_listed_ones(api):
    got, _ = api
    spec = _spec()
    assert {n for n in got if n not in spec} == PORT_ADDED


def _spec_keys(package):
    """The top-level keys a replica spec documents in `package`'s
    fleet/replica.py."""
    text = open(os.path.join(HERE, "..", package, "fleet", "replica.py")).read()
    doc = text.split("Spec (JSON):", 1)[1].split('"""', 1)[0]
    keys = set()
    for ln in doc.splitlines():
        if ln.startswith("  ") and not ln.startswith("   "):
            head = ln.split()[0]
            keys.update(k.strip(",:") for k in head.split(",") if k.strip(",:"))
            if head.endswith(","):
                keys.add(ln.split()[1].strip(",:"))
    return keys


def test_replica_spec_keys_are_the_reference_ones_and_the_listed_ones():
    ref, port = _spec_keys(REF), _spec_keys(PORT)
    assert "predict" in ref and "repo" in ref
    assert port == ref | REPLICA_SPEC_ADDED


def test_scope_drop_kids_is_a_noop():
    scope = Scope(seed=3, place=CPUPlace())
    scope.vars["w"] = object()
    before = dict(scope.vars)
    assert scope.drop_kids() is None
    assert scope.vars == before and scope.row_shards == {}


@pytest.mark.parametrize("fn", ["profiler", "stop_profiler"])
def test_profiler_defaults_match_the_reference(fn):
    """The spec's defaults, "/tmp/profile" among them (what
    tools/timeline.py's usage reads)."""
    sig = inspect.signature(getattr(profiler, fn))
    assert str(sig) == _spec()["paddle_tpu.profiler.%s" % fn]
    assert sig.parameters["profile_path"].default == "/tmp/profile"


def test_profiler_dump_converts_with_timeline(tmp_path, capsys):
    """A dump at a given profile_path is what tools/timeline.py converts;
    None writes nothing."""
    profiler.reset_profiler()
    profiler.start_profiler("All")
    with profiler.RecordEvent("outer"):
        with profiler.RecordEvent("inner"):
            pass
    path = tmp_path / "profile"
    profiler.stop_profiler("total", str(path))
    profiler.start_profiler("All")
    profiler.stop_profiler("total", None)
    capsys.readouterr()
    assert sorted(os.listdir(tmp_path)) == ["profile"]
    sys.path.insert(0, TOOLS)
    try:
        import timeline
    finally:
        sys.path.remove(TOOLS)
    out = tmp_path / "timeline.json"
    timeline.convert(str(path), str(out))
    names = {e["name"] for e in json.loads(out.read_text())["traceEvents"] if e["ph"] == "X"}
    assert names == {"outer", "outer/inner"}
    profiler.reset_profiler()
