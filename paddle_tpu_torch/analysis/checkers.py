"""fluidlint: registered checkers over an `Analysis` (analysis/dataflow.py),
the torch counterpart of paddle_tpu/analysis/checkers.py: the same check
ids, severities, provenance and messages, so both packages give equal
findings on one program.

Each checker is a pure function `fn(analysis) -> iterable[Finding]`
registered under a stable check id — the string a finding carries, the CLI
filters on, and the seeded-defect tests assert. The catalog
(docs/static_analysis.md):

- donation-alias   (error)   the inplace_donation_plan disagrees with the
                             lowering's mut/ro state classification —
                             statically pre-empts the block preparation's
                             divergence raise (executor.py).
- sharding-rules   (mixed)   rule rank exceeds an explicit target's rank
                             (error); dead rules matching zero vars
                             (warning). The rules are `program.
                             _sharding_rules`, (pattern, spec) pairs, with
                             the caller's; with a mesh bound, dims the
                             mesh does not divide (warning).
- dtype-boundary   (warning) an op mixes 16-bit and 32-bit float inputs
                             without an explicit cast — silent upcast
                             drift at op edges.
- determinism      (error)   stochastic or host ops reachable in an
                             inference/serving program (a host op splits
                             the served block's CUDA graph).
- dead-write       (warning) a non-persistable value overwritten before
                             any read (shadowed store).
- write-never-read (warning) an op none of whose outputs are ever read,
                             fetched, or persisted — dead code.
- fetch-unwritten  (error)   a fetch name no op writes, nothing feeds, and
                             no scope/persistable var backs — pre-empts
                             the executor's "fetch var has no value".
- cf-capture       (error)   a sub-block reads a parent var not threaded
                             through the control-flow op's inputs (KeyError
                             deep inside the lowering), or writes a parent
                             var the op does not output (silently dropped
                             by the functional lowering).

`lint_program` is the one-call entry: analyze + run checkers; `deep=False`
skips the forward interpretation for the structural subset the PassManager
re-runs per pass (analysis/verify.py).
"""

import re

from ..executor import op_display_name
from ..framework import Block as _Block
from ..ops import registry
from .dataflow import Analysis, SymDim, analyze_program

__all__ = [
    "Finding",
    "CHECKERS",
    "STRUCTURAL_CHECKS",
    "register_checker",
    "lint_program",
    "run_checkers",
    "render_findings",
]

ERROR = "error"
WARNING = "warning"

# ops whose value is their side effect, never their outputs
_SIDE_EFFECT_OPS = frozenset({"print"})

# the optimizer ops whose moment slots may be bf16 beside f32 masters (the
# JAX package's core_ops.ZERO1_STATE_SLOTS keys; ops/core_ops._opt_f32 here)
ZERO1_STATE_SLOTS = ("momentum", "lars_momentum", "adam", "adagrad", "decayed_adagrad",
                     "rmsprop", "adadelta", "adamax", "ftrl")


# deliberate mixed-precision seams: explicit casts and the optimizer tier
# (master f32 math over bf16 moments/params is the design, core_ops._opt_f32)
def _dtype_boundary_exempt():
    return frozenset({"cast", "sgd"}) | frozenset(ZERO1_STATE_SLOTS)


class Finding:
    """One lint finding with op/var provenance. `op_display` is the
    "<type>:<first output>" instance handle (op_display_name) — fluid ops
    are anonymous, outputs are the stable identity."""

    __slots__ = (
        "check", "severity", "message", "var", "block_idx", "op_index",
        "op_type", "op_display",
    )

    def __init__(self, check, severity, message, var=None, block_idx=None,
                 op_index=None, op_type=None, op_display=None):
        self.check = check
        self.severity = severity
        self.message = message
        self.var = var
        self.block_idx = block_idx
        self.op_index = op_index
        self.op_type = op_type
        self.op_display = op_display

    def format(self):
        where = ""
        if self.block_idx is not None and self.op_index is not None:
            where = " b%d/op%d" % (self.block_idx, self.op_index)
        op = " %s" % self.op_display if self.op_display else ""
        var = " var=%r" % self.var if self.var else ""
        return "%s[%s]%s%s%s: %s" % (
            self.severity, self.check, where, op, var, self.message
        )

    def __repr__(self):
        return "Finding(%s)" % self.format()


def _op_finding(check, severity, message, op=None, block_idx=None,
                op_index=None, var=None):
    display = op_display_name(op) if op is not None else None
    return Finding(
        check, severity, message, var=var, block_idx=block_idx,
        op_index=op_index, op_type=op.type if op is not None else None,
        op_display=display,
    )


def _node_site(a, name, block_idx=0):
    """(op, block_idx, op_index) of the last producer of `name`, else its
    first consumer, else Nones — the provenance handle for var-keyed
    findings."""
    vn = a.graph.var_node(name, block_idx)
    if vn is not None:
        if vn.producers:
            n = vn.producers[-1]
            return n.op, n.block_idx, n.index
        if vn.consumers:
            n = vn.consumers[0]
            return n.op, n.block_idx, n.index
    return None, None, None


CHECKERS = {}  # check id -> fn(analysis) -> iterable[Finding]

# checkers needing no forward facts — the cheap subset the PassManager
# re-runs after every pass (analysis/verify.py verify_graph)
STRUCTURAL_CHECKS = ("cf-capture", "fetch-unwritten", "donation-alias")


def register_checker(check_id):
    """Decorator registering a checker under a stable id (the ops/registry
    idiom). Re-registration raises — a silent shadow would make lint
    results depend on import order."""

    def deco(fn):
        if check_id in CHECKERS and CHECKERS[check_id] is not fn:
            raise ValueError("checker %r already registered" % check_id)
        CHECKERS[check_id] = fn
        return fn

    return deco


# ---------------------------------------------------------------------------
# 1. donation-alias
# ---------------------------------------------------------------------------


@register_checker("donation-alias")
def _check_donation_alias(a):
    """Recompute the lowering's mut/ro state classification exactly as the
    block preparation does (executor.py _PerOpProfiledBlock) and diff it
    against the program's riding inplace_donation_plan — a divergence means
    a donated buffer would back a read-only value (use-after-donate) or a
    mutated buffer would skip donation. The executor raises at preparation;
    this pre-empts."""
    plan = getattr(a.program, "_donation_plan", None)
    if not plan or plan.get("unknown"):
        return
    scope = a.scope
    if scope is None or plan.get("scope_uid") != getattr(scope, "_uid", None):
        return
    if plan.get("feed") != sorted(a.feed_names):
        return
    if list(plan.get("fetch", ())) != list(a.fetch_names):
        return
    block = a.program.global_block()
    if not all(registry.is_registered(op.type) for op in block.ops):
        return
    ops = [op for op in block.ops if not registry.get(op.type).skip_exec]
    produced, state = set(), []
    fed = set(a.feed_names)
    for op in ops:
        for name in op.input_arg_names:
            if name == registry.EMPTY_VAR_NAME:
                continue
            if name in fed or name in produced or name in state:
                continue
            if scope.find_var(name) is not None:
                state.append(name)
        produced.update(
            n for n in op.output_arg_names if n != registry.EMPTY_VAR_NAME
        )
    for name in a.fetch_names:
        if (
            name not in fed
            and name not in produced
            and name not in state
            and scope.find_var(name) is not None
        ):
            state.append(name)
    written = set()
    for op in ops:
        written.update(
            n for n in op.output_arg_names if n != registry.EMPTY_VAR_NAME
        )
    mut = sorted(set(state) & written)
    ro = sorted(set(state) - written)
    for name in sorted(set(plan.get("mut", ())) - set(mut)):
        op, bi, oi = _node_site(a, name)
        yield _op_finding(
            "donation-alias", ERROR,
            "donation plan donates %r but the lowering classifies it "
            "read-only — the donated buffer stays live after the call "
            "(use-after-donate)" % name,
            op=op, block_idx=bi, op_index=oi, var=name,
        )
    for name in sorted(set(mut) - set(plan.get("mut", ()))):
        op, bi, oi = _node_site(a, name)
        yield _op_finding(
            "donation-alias", ERROR,
            "the lowering mutates state %r but the donation plan classifies "
            "it read-only — a pass likely corrupted def-use edges" % name,
            op=op, block_idx=bi, op_index=oi, var=name,
        )
    for name in sorted(set(plan.get("ro", ())) - set(ro) - set(mut)):
        op, bi, oi = _node_site(a, name)
        yield _op_finding(
            "donation-alias", ERROR,
            "donation plan lists %r as read-only state but the lowering "
            "sees no such state input" % name,
            op=op, block_idx=bi, op_index=oi, var=name,
        )


# ---------------------------------------------------------------------------
# 2. sharding-rules
# ---------------------------------------------------------------------------


@register_checker("sharding-rules")
def _check_sharding_rules(a):
    """Lint the declarative rule set (`program._sharding_rules`, (pattern,
    spec) pairs as the JAX package's parallel/sharding_rules iterates
    them): a rule matching nothing is dead weight (warning); an
    explicit-target rank mismatch silently resolves to replicated (error —
    the author asked for a layout the engine cannot apply). With a mesh
    bound, non-divisible static dims degrade to replication per dim
    (warning, the Resolver's documented but silent behaviour)."""
    rules = (a.resolver.rules if a.resolver is not None and a.resolver.rules is not None
             else getattr(a.program, "_sharding_rules", None))
    if not rules:
        return
    names = set()
    declared = {}
    for blk in a.program.blocks:
        for name, v in blk.vars.items():
            names.add(name)
            declared.setdefault(name, v)
    if a.scope is not None:
        names.update(a.scope.vars)
    for pattern, spec in rules:
        rx = re.compile(pattern)
        matched = sorted(n for n in names if rx.search(n))
        if not matched:
            yield Finding(
                "sharding-rules", WARNING,
                "sharding rule %r matches no variable in the program or "
                "scope — dead rule" % pattern,
                var=pattern,
            )
            continue
        if spec is None:
            continue
        for name in matched:
            v = declared.get(name)
            fact = a.facts.get(name)
            shape = None
            if fact is not None and fact.kind == "tensor":
                shape = fact.shape
            elif v is not None and v.shape is not None:
                shape = tuple(v.shape)
            elif a.scope is not None and a.scope.find_var(name) is not None:
                shape = tuple(a.scope.vars[name].shape)
            if shape is None:
                continue
            explicit = v is not None and (
                getattr(v, "trainable", None) is not None or v.is_data
            )
            if len(spec) > len(shape):
                if explicit:
                    op, bi, oi = _node_site(a, name)
                    yield _op_finding(
                        "sharding-rules", ERROR,
                        "rule %r assigns a rank-%d spec %r to %r of rank %d "
                        "— the Resolver silently resolves it replicated"
                        % (pattern, len(spec), spec, name, len(shape)),
                        op=op, block_idx=bi, op_index=oi, var=name,
                    )
                continue
            if a.mesh is None:
                continue
            for dim, entry in enumerate(spec):
                axes = () if entry is None else (
                    tuple(entry) if isinstance(entry, tuple) else (entry,))
                kept = tuple(ax for ax in axes if a.mesh.shape.get(ax, 1) > 1)
                if not kept:
                    continue
                d = shape[dim]
                if isinstance(d, SymDim) or d < 0:
                    continue
                extent = 1
                for ax in kept:
                    extent *= a.mesh.shape[ax]
                if int(d) % extent != 0:
                    op, bi, oi = _node_site(a, name)
                    yield _op_finding(
                        "sharding-rules", WARNING,
                        "rule %r shards dim %d of %r (extent %d) over %s "
                        "(mesh extent %d) — not divisible, the Resolver "
                        "silently degrades this dim to replication"
                        % (pattern, dim, name, int(d), "x".join(kept), extent),
                        op=op, block_idx=bi, op_index=oi, var=name,
                    )


# ---------------------------------------------------------------------------
# 3. dtype-boundary
# ---------------------------------------------------------------------------

_LOW_FLOATS = frozenset({"float16", "bfloat16"})
_HIGH_FLOATS = frozenset({"float32", "float64"})


@register_checker("dtype-boundary")
def _check_dtype_boundary(a):
    """An op consuming both 16-bit and 32-bit float inputs mixes precisions
    implicitly — type promotion upcasts inside the lowering, so the boundary
    (and its memory/accuracy cost) is invisible in the program. Explicit
    `cast` ops and the optimizer tier (master-f32 math by design) are
    exempt."""
    exempt = _dtype_boundary_exempt()
    for rec in a.records:
        if rec.op.type in exempt or rec.op.type.endswith("_grad"):
            continue
        low, high = [], []
        for slot, names in rec.op.inputs.items():
            facts = rec.ins.get(slot, ())
            for name, f in zip(names, facts):
                if f is None or f.kind != "tensor" or f.dtype is None:
                    continue
                if f.dtype in _LOW_FLOATS:
                    low.append((name, f.dtype))
                elif f.dtype in _HIGH_FLOATS:
                    high.append((name, f.dtype))
        if low and high:
            yield _op_finding(
                "dtype-boundary", WARNING,
                "implicit mixed-precision boundary: %s vs %s — insert an "
                "explicit cast where the precision change is intended"
                % (
                    ", ".join("%s:%s" % p for p in low[:3]),
                    ", ".join("%s:%s" % p for p in high[:3]),
                ),
                op=rec.op, block_idx=rec.block_idx, op_index=rec.index,
                var=low[0][0],
            )


# ---------------------------------------------------------------------------
# 4. determinism
# ---------------------------------------------------------------------------


@register_checker("determinism")
def _check_determinism(a):
    """Inference/serving programs must be pure functions of their feeds:
    clone(for_test) prunes training-only stochastic ops, so any survivor
    here means the program was exported wrong (results differ run to run),
    and a host op cannot run inside the served block's CUDA graph."""
    if a.mode not in ("inference", "serving") and not getattr(
        a.program, "_is_test", False
    ):
        return
    for rec in a.records:
        if rec.opdef is None:
            continue
        if rec.opdef.stochastic and not rec.op.attrs.get("is_test", False):
            yield _op_finding(
                "determinism", ERROR,
                "stochastic op %r reachable in a%s program — outputs would "
                "differ run to run; export with clone(for_test=True)"
                % (rec.op.type,
                   "n inference" if a.mode != "serving" else " serving"),
                op=rec.op, block_idx=rec.block_idx, op_index=rec.index,
                var=next(iter(rec.op.output_arg_names), None),
            )
        if rec.opdef.is_host:
            yield _op_finding(
                "determinism", ERROR,
                "host op %r reachable in a %s program — host ops cannot be "
                "jitted by the serving lowering" % (rec.op.type, a.mode),
                op=rec.op, block_idx=rec.block_idx, op_index=rec.index,
                var=next(iter(rec.op.output_arg_names), None),
            )


# ---------------------------------------------------------------------------
# 5 + 6. dead-write / write-never-read (backward liveness)
# ---------------------------------------------------------------------------


def _real_outputs(op):
    return [
        n for n in op.output_arg_names if n != registry.EMPTY_VAR_NAME
    ]


def _liveness_exempt(a, node):
    if node.sub_blocks or node.type in _SIDE_EFFECT_OPS:
        return True
    try:
        opdef = registry.get(node.type)
    except KeyError:
        return True
    return opdef.skip_exec or opdef.is_host


@register_checker("dead-write")
def _check_dead_write(a):
    """A write whose value is overwritten before any read (shadowed store):
    the op ran for nothing, and under donation the stale buffer may alias.
    Flagged only when a LATER op writes the same name — a never-again-
    written dead value is write-never-read's finding instead."""
    nodes = a.graph.op_nodes(0)
    live = a.live_after(0)
    writers = {}
    for i, node in enumerate(nodes):
        for vn in node.outputs:
            writers.setdefault(vn.name, []).append(i)
    for i, node in enumerate(nodes):
        if _liveness_exempt(a, node):
            continue
        for vn in node.outputs:
            if vn.persistable or vn.name in live[i]:
                continue
            later = [j for j in writers.get(vn.name, ()) if j > i]
            if later:
                yield _op_finding(
                    "dead-write", WARNING,
                    "value written to %r is overwritten by op %d (%s) before "
                    "any read — shadowed store"
                    % (vn.name, later[0], nodes[later[0]].type),
                    op=node.op, block_idx=0, op_index=i, var=vn.name,
                )


@register_checker("write-never-read")
def _check_write_never_read(a):
    """An op none of whose outputs are ever read, fetched, persisted, or
    referenced by a sub-block is dead code the dead_op_eliminate pass would
    remove — flag it so the author deletes the source, not just the op.

    `*_grad` ops are exempt: the backward generator emits a gradient for
    every forward input, and grads of stop_gradient / non-trainable vars
    (fixed positional embeddings, labels) land unconsumed by design — DCE
    removes them; the lint targets user-written dead code."""
    nodes = a.graph.op_nodes(0)
    live = a.live_after(0)
    writers = {}
    for i, node in enumerate(nodes):
        for vn in node.outputs:
            writers.setdefault(vn.name, []).append(i)
    for i, node in enumerate(nodes):
        if _liveness_exempt(a, node) or node.type.endswith("_grad"):
            continue
        outs = _real_outputs(node.op)
        if not outs:
            continue
        dead = all(
            n not in live[i] and not any(j > i for j in writers.get(n, ()))
            for n in outs
        )
        if dead:
            yield _op_finding(
                "write-never-read", WARNING,
                "no output of this op is ever read, fetched, or persisted — "
                "dead code (dead_op_eliminate would remove it)",
                op=node.op, block_idx=0, op_index=i, var=outs[0],
            )


# ---------------------------------------------------------------------------
# 7. fetch-unwritten
# ---------------------------------------------------------------------------


@register_checker("fetch-unwritten")
def _check_fetch_unwritten(a):
    """Every fetch must be fed, produced by a block-0 op, or backed by
    scope/persistable state — otherwise the executor raises 'fetch var has
    no value' only after the pass pipeline and lowering already ran."""
    produced = set()
    block = a.program.global_block()
    for op in block.ops:
        produced.update(
            n for n in op.output_arg_names if n != registry.EMPTY_VAR_NAME
        )
    for name in a.fetch_names:
        if name in a.feed_names or name in produced:
            continue
        if a.scope is not None and a.scope.find_var(name) is not None:
            continue
        if a.scope is None and block.has_var_recursive(name):
            if block._var_recursive(name).persistable:
                continue
        yield Finding(
            "fetch-unwritten", ERROR,
            "fetch %r is never written: no op produces it, nothing feeds "
            "it, and no scope/persistable var backs it" % name,
            var=name,
        )


# ---------------------------------------------------------------------------
# 8. cf-capture
# ---------------------------------------------------------------------------


def _block_tree_sets(program, block_idx, memo):
    """(reads, writes, locals) over the block TREE rooted at block_idx —
    the sets layers/control_flow._external_reads_writes derives x_names
    and carried/written names from, extended through nesting."""
    hit = memo.get(block_idx)
    if hit is not None:
        return hit
    reads, writes, locals_ = set(), set(), set()
    stack = [block_idx]
    while stack:
        idx = stack.pop()
        blk = program.blocks[idx]
        locals_.update(blk.vars)
        for op in blk.ops:
            reads.update(op.input_arg_names)
            writes.update(op.output_arg_names)
            stack.extend(
                v.idx for v in op.attrs.values() if isinstance(v, _Block)
            )
    reads.discard(registry.EMPTY_VAR_NAME)
    writes.discard(registry.EMPTY_VAR_NAME)
    memo[block_idx] = (reads, writes, locals_)
    return memo[block_idx]


def _resolvable_above(a, name, block_idx):
    """Does `name` resolve outside the sub-tree: an ancestor block's
    declaration or the executor scope?"""
    idx = block_idx
    prog = a.program
    while idx >= 0:
        if name in prog.blocks[idx].vars:
            return True
        idx = prog.blocks[idx].parent_idx
    return a.scope is not None and a.scope.find_var(name) is not None


@register_checker("cf-capture")
def _check_cf_capture(a):
    """Control-flow capture: the functional lowering of while/cond/recurrent
    sees ONLY the names threaded through the op's input/output slots
    (ops/control_flow_ops.py builds its env from x_names). A sub-block read
    outside that set KeyErrors deep inside the lowering; a sub-block write
    to a parent var the op does not output is dropped on the floor each
    iteration."""
    memo = {}
    for node in a.graph.all_op_nodes():
        sub_idxs = node.sub_blocks
        if not sub_idxs:
            continue
        op = node.op
        ins = set(op.input_arg_names)
        outs = set(op.output_arg_names)
        parent_idx = node.block_idx
        for sub_idx in sub_idxs:
            reads, writes, locals_ = _block_tree_sets(
                a.program, sub_idx, memo
            )
            for name in sorted(reads - locals_ - ins):
                yield _op_finding(
                    "cf-capture", ERROR,
                    "sub-block %d reads %r which is not threaded through "
                    "the %r op's inputs — the functional lowering cannot "
                    "see it (KeyError at trace time; under a donation plan "
                    "the read would alias a donated buffer)"
                    % (sub_idx, name, op.type),
                    op=op, block_idx=parent_idx, op_index=node.index,
                    var=name,
                )
            for name in sorted(writes - locals_ - outs):
                if not _resolvable_above(a, name, parent_idx):
                    continue
                yield _op_finding(
                    "cf-capture", ERROR,
                    "sub-block %d writes parent variable %r but the %r op "
                    "does not output it — the write is dropped by the "
                    "functional lowering every iteration"
                    % (sub_idx, name, op.type),
                    op=op, block_idx=parent_idx, op_index=node.index,
                    var=name,
                )


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def run_checkers(analysis, checks=None):
    """Run registered checkers (all, or the given ids in registration
    order) over an Analysis; returns [Finding], errors first."""
    findings = []
    for check_id, fn in CHECKERS.items():
        if checks is not None and check_id not in checks:
            continue
        findings.extend(fn(analysis) or ())
    findings.sort(key=lambda f: 0 if f.severity == ERROR else 1)
    return findings


def lint_program(program, feed_names=(), fetch_names=(), scope=None,
                 mesh=None, rules=None, mode="training", checks=None,
                 deep=True):
    """Analyze + lint in one call; returns (analysis, findings).

    deep=False skips the forward abstract interpretation — only the
    structural checkers (STRUCTURAL_CHECKS) see enough; the PassManager's
    per-pass re-verification uses it to stay cheap."""
    if deep:
        analysis = analyze_program(
            program, feed_names, fetch_names, scope=scope, mesh=mesh,
            rules=rules, mode=mode,
        )
    else:
        from ..passes.graph import Graph

        graph = program if isinstance(program, Graph) else Graph(program)
        analysis = Analysis(
            program if not isinstance(program, Graph) else graph.program,
            graph, feed_names, fetch_names, scope, mesh, None, mode,
        )
        if checks is None:
            checks = STRUCTURAL_CHECKS
    return analysis, run_checkers(analysis, checks=checks)


def render_findings(findings):
    """One line per finding, errors first (the CLI/report format)."""
    return "\n".join(f.format() for f in findings)
