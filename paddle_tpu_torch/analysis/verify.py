"""The FLAGS_static_verify compile gate (the torch counterpart of
paddle_tpu/analysis/verify.py).

With the flag on (off by default), every preparation path proves the
program against the fluidlint checker suite BEFORE the block is prepared
and captured: Executor.run when a cache key is first seen,
aot_serve_lowering (the serving / generation model-load path), the
serving engines at load, and the PassManager's pipeline (stage 0 plus a
cheap structural re-verification after every pass). Error findings raise
`StaticVerifyError` listing every finding with op/var provenance; warnings
count through the observability registry (`analysis/*`) and pass.

Verification never mutates the program, so gated and ungated runs give the
same bits. Results memoize per (program uid/version, feeds, fetches, scope,
mode): the gate costs one dict lookup once a program verified.
"""

from .checkers import ERROR, STRUCTURAL_CHECKS, lint_program, render_findings

__all__ = [
    "StaticVerifyError",
    "static_verify",
    "maybe_static_verify",
    "verify_graph",
]


class StaticVerifyError(RuntimeError):
    """The static analyzer rejected a program. `findings` carries every
    Finding (errors and warnings) from the failing lint."""

    def __init__(self, where, findings):
        self.where = where
        self.findings = list(findings)
        errors = [f for f in self.findings if f.severity == ERROR]
        RuntimeError.__init__(
            self,
            "static verification failed at %s (%d error%s):\n%s"
            % (
                where or "compile",
                len(errors),
                "" if len(errors) == 1 else "s",
                render_findings(self.findings),
            ),
        )


def _flag_on():
    from .. import flags as _flags

    return _flags.get_flags("static_verify")["static_verify"]


def _metrics():
    from ..observability import registry as _registry

    reg = _registry.default_registry()
    return {
        "verifies": reg.counter(
            "analysis/verifies", "static_verify gate runs, labeled by where"
        ),
        "findings": reg.counter(
            "analysis/findings",
            "fluidlint findings, labeled by check and severity",
        ),
        "wall_ms": reg.gauge(
            "analysis/verify_wall_ms", "last static_verify wall time (ms)"
        ),
    }


def static_verify(program, feed_names=(), fetch_names=(), scope=None,
                  mesh=None, rules=None, mode="training", where="",
                  checks=None, deep=True):
    """Lint and raise StaticVerifyError on any error-severity finding;
    returns the full findings list (warnings included) otherwise. Counters
    land in the observability registry either way."""
    import time

    t0 = time.perf_counter()
    _, findings = lint_program(
        program, feed_names, fetch_names, scope=scope, mesh=mesh,
        rules=rules, mode=mode, checks=checks, deep=deep,
    )
    m = _metrics()
    m["verifies"].inc(where=where or "direct")
    m["wall_ms"].set((time.perf_counter() - t0) * 1000.0)
    for f in findings:
        m["findings"].inc(check=f.check, severity=f.severity)
    if any(f.severity == ERROR for f in findings):
        raise StaticVerifyError(where, findings)
    return findings


_VERIFIED = {}  # memo key -> findings (successful verifications only)
_VERIFIED_CAP = 256


def maybe_static_verify(program, feed_names=(), fetch_names=(), scope=None,
                        mesh=None, rules=None, mode="training", where=""):
    """The flag-gated, memoized gate the executor and serving loaders call
    at their preparation points. No flag → no work; verified programs cost
    one dict lookup per later preparation."""
    if not _flag_on():
        return None
    key = (
        program._uid,
        program._version,
        tuple(sorted(feed_names)),
        tuple(fetch_names),
        getattr(scope, "_uid", None),
        mode,
        repr(rules) if rules is not None else None,
    )
    hit = _VERIFIED.get(key)
    if hit is not None:
        return hit
    findings = static_verify(
        program, feed_names, fetch_names, scope=scope, mesh=mesh,
        rules=rules, mode=mode, where=where,
    )
    if len(_VERIFIED) >= _VERIFIED_CAP:
        _VERIFIED.pop(next(iter(_VERIFIED)))
    _VERIFIED[key] = findings
    return findings


def verify_graph(graph, ctx, stage=""):
    """The PassManager hook: with FLAGS_static_verify on, run the cheap
    structural checker subset (STRUCTURAL_CHECKS — no forward
    interpretation) over the pipeline's live graph, raising on errors.
    Called as stage 0 before any pass and re-run after every pass, so a
    pass that breaks control-flow capture or drops a fetched producer is
    named immediately, not at the next compile."""
    if not _flag_on():
        return None
    return static_verify(
        graph, ctx.feed_names, ctx.fetch_names, scope=ctx.scope,
        where="pipeline:%s" % (stage or "0"), checks=STRUCTURAL_CHECKS,
        deep=False,
    )
