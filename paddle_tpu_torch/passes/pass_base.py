"""Pass base class + string-keyed PassRegistry (reference framework/ir/pass.h
REGISTER_PASS; registry shape mirrors ops/registry.py). A copy of
paddle_tpu/passes/pass_base.py.

A Pass is a named Program→Program rewrite expressed over the Graph IR
(passes/graph.py). Passes mutate the graph's shadow program and record any
caller-facing payload (reuse mappings, fold counts, the donation plan) into
`ctx.results[pass_name]`; the PassManager re-verifies graph invariants and
emits telemetry after each one.
"""

__all__ = [
    "Pass",
    "PassContext",
    "register_pass",
    "get_pass",
    "registered_passes",
    "PASSES",
]

PASSES = {}  # name -> Pass subclass (string-keyed, like ops/registry.OPS)


class PassContext:
    """Everything a pass may consult beyond the graph itself.

    scope: executor Scope holding parameter values (None for purely
    structural pipelines — passes needing values must degrade to no-ops).
    feed_names / fetch_names: the run's external inputs and requested
    outputs — the reachability roots (a fetched var must survive every
    pass, constant_fold included).
    attrs: free-form per-invocation knobs (e.g. memory_optimize's
    skip_opt_set). results: per-pass payloads, keyed by pass name.
    """

    def __init__(self, scope=None, feed_names=(), fetch_names=(), attrs=None):
        self.scope = scope
        self.feed_names = tuple(feed_names)
        self.fetch_names = tuple(fetch_names)
        self.attrs = dict(attrs or {})
        self.results = {}


class Pass:
    """Base class. Subclasses set `name` via @register_pass and implement
    apply(graph, ctx) mutating the graph in place (return value ignored)."""

    name = None

    def apply(self, graph, ctx):
        raise NotImplementedError(
            "pass %r does not implement apply()" % type(self).__name__
        )

    def __repr__(self):
        return "<Pass %s>" % (self.name or type(self).__name__)


def register_pass(name):
    """Class decorator: `@register_pass("constant_fold")` — same idiom as
    ops/registry.register. Re-registration raises (a silent shadow would make
    pipeline behavior depend on import order)."""

    def deco(cls):
        if name in PASSES and PASSES[name] is not cls:
            raise ValueError("pass %r already registered" % name)
        cls.name = name
        PASSES[name] = cls
        return cls

    return deco


def get_pass(name):
    """Instantiate a registered pass by name."""
    _ensure_builtin()
    cls = PASSES.get(name)
    if cls is None:
        raise KeyError(
            "unknown pass %r (registered: %s)" % (name, registered_passes())
        )
    return cls()


def registered_passes():
    _ensure_builtin()
    return sorted(PASSES)


def _ensure_builtin():
    # the built-in battery self-registers on import; lazy so that importing
    # pass_base alone registers nothing
    from . import builtin  # noqa: F401
