"""Declarative sharding rules: param/activation names -> layouts (the
counterpart of paddle_tpu/parallel/sharding_rules.py).

The rule engine is the JAX module's, numpy code with the same precedence,
pruning, degrading, accumulator aliasing and ZeRO-1 tier:

- `ShardingRules` holds ordered (regex, spec) pairs. A name resolves by
  re.search against every rule, LAST match wins (append more-specific rules
  after catch-alls). Unmatched names stay replicated. Specs follow the
  sharding_spec tuple convention: one entry per dim, each None | axis name |
  tuple of axis names, e.g. ("fsdp", "tp") or (("fsdp", "tp"), None).
- `SpecLayout` names the canonical layouts for the transformer roles
  (embedding / column-parallel / row-parallel / vector).
- `Resolver` binds rules to a live mesh: prunes axes the mesh doesn't have,
  degrades non-divisible dims to replication, aliases optimizer
  accumulators to their parameter's layout, and layers the legacy
  `Variable.sharding_spec` attribute (parallel.shard_parameter) and the
  ZeRO-1 state tier underneath explicit rules.

The JAX package hands the resolved specs to GSPMD, which places the
collectives. The port runs one process per device and writes them out
(the second half of this module):

- **storage** (`storage_specs`): a persistable whose resolved spec splits
  it over fsdp or tp is stored as this rank's piece, and so are its
  optimizer accumulators (aliased by the Resolver): the 1/extent memory
  FSDP and tp are for. `Scope.row_shards` records the layout;
  collectives.gathered_state / reshard_state give the whole value back.
  A row spec over ep keeps the row-sharded embedding's own path.
- **use** (`Layouts`, the run's record of which values are pieces): every
  op lowers through it (registry._lower_one). Ops that know a layout run
  on the pieces: the Megatron pair (a column-parallel `mul` / `matmul`
  with its weight split over tp on the out-features leaves its activation
  split on the last dimension; a row-parallel one takes that activation
  and all-reduces its output over tp, once), a bias placed ("tp",) and the
  elementwise ops, activations and dropout on a split activation,
  `reshape2` / `transpose2` of a head-split projection (the local head
  count n_head / tp goes into the shape), `flash_attention` on the local
  heads, softmax over an unsplit axis, and the grads of all of these (a
  column-parallel product's input gradient is all-reduced over tp). Any
  other op gathers its split operands whole first, and its results are
  whole: that is FSDP's wire behaviour (a parameter all-gathered where it
  is used), correct for any rule.
- **gradients**: before the optimizer section the ParallelExecutor's plan
  brings each parameter's gradient to the parameter's stored layout,
  reduce-scattered where the gradient is whole and the parameter split
  (FSDP), averaged over the batch axes (dp and fsdp); the optimizer ops
  then update the pieces (`Layouts`' optimizer form: every floating input
  of the parameter's whole shape is taken as its piece, the counterpart of
  opt_constrain_ins / opt_constrain_outs).

Dropout under tp: a random op on a split activation draws its piece on
each rank from that rank's generator (the pieces' masks are independent
draws, not slices of one whole mask); a random op on a whole value draws
the same numbers on every tp rank, since every rank's device generator
starts from the scope's seed and advances through the same ops. The
multi-card checks hold dropout at 0.
"""

import re

import numpy as np
import torch

__all__ = [
    "MESH_AXES",
    "ShardingRules",
    "SpecLayout",
    "program_rules",
    "Resolver",
    "ZERO1_STATE_SLOTS",
    "Layouts",
    "storage_specs",
]

# the canonical mesh axes (parallel.mesh.MeshConfig order). Rules may only
# name these; anything else is a typo caught at add() time, not a silent
# replication at run time.
MESH_AXES = ("dp", "fsdp", "tp", "sp", "ep", "pp")


def _normalize_spec(spec):
    """Canonicalize one spec tuple: each dim entry None | axis | tuple of
    axes. Returns a hashable nested tuple; raises ValueError on unknown
    axis names or malformed entries."""
    if spec is None:
        return None
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        for a in axes:
            if a not in MESH_AXES:
                raise ValueError(
                    "unknown mesh axis %r in sharding spec %r (valid: %s)"
                    % (a, tuple(spec), ", ".join(MESH_AXES))
                )
        if len(set(axes)) != len(axes):
            raise ValueError("repeated axis in sharding spec entry %r" % (entry,))
        out.append(tuple(axes) if len(axes) > 1 else axes[0])
    return tuple(out)


class ShardingRules:
    """Ordered (regex, PartitionSpec-tuple) rules, LAST match wins.

    Matching uses re.search (a bare parameter name matches anywhere in the
    var name — anchor with ^…$ when that is too loose; note an unanchored
    pattern also matches derived names like `<param>@GRAD` and the
    `<param>_<slot>_acc_<k>` accumulators, which is usually what you want
    for a storage layout). `add` validates axis names eagerly and returns
    self for chaining."""

    def __init__(self, rules=()):
        self._rules = []  # [(pattern str, compiled, spec)]
        for pattern, spec in rules:
            self.add(pattern, spec)

    def add(self, pattern, spec):
        self._rules.append((pattern, re.compile(pattern), _normalize_spec(spec)))
        return self

    def extend(self, other):
        """Append another rule set's rules after this one's (so `other`
        wins ties under last-match)."""
        if other is not None:
            for pattern, _, spec in other._rules:
                self._rules.append((pattern, re.compile(pattern), spec))
        return self

    def match(self, name):
        """Resolved spec tuple for `name`, or None (replicated) when no rule
        matches. A matching rule with spec None explicitly forces
        replication (useful to exempt names from an earlier catch-all)."""
        found = None
        for _, rx, spec in self._rules:
            if rx.search(name):
                found = (spec,)
        return found[0] if found is not None else None

    def fingerprint(self):
        """Hashable identity for executor compile-cache keys: rules are
        attached to live Program objects and may grow after a first run."""
        return tuple((p, s) for p, _, s in self._rules)

    def __len__(self):
        return len(self._rules)

    def __iter__(self):
        for pattern, _, spec in self._rules:
            yield pattern, spec

    def __repr__(self):
        return "ShardingRules(%r)" % (list(self),)


class SpecLayout:
    """Canonical per-role layouts over the standard axes — the MaxText-style
    vocabulary model code uses instead of hand-written axis tuples.

    Roles (2-D weights are [in_features, out_features], fluid convention):

    - embedding():        ((fsdp, tp), None) — vocab rows split over both
                          model axes, feature dim whole.
    - column_parallel():  (fsdp, tp)  — qkv / ffn-up: out-features over tp
                          (per-head shards), in-features over fsdp.
    - row_parallel():     (tp, fsdp)  — attn-out / ffn-down: in-features
                          over tp so the pair's reduce lands HERE (GSPMD
                          places one tp all-reduce after the second matmul).
    - vector():           (fsdp,)     — biases / norm scales: fsdp only
                          (tp-sharding rank-1 state buys nothing).
    """

    def __init__(self, fsdp_axis="fsdp", tp_axis="tp", ep_axis="ep"):
        self.fsdp_axis = fsdp_axis
        self.tp_axis = tp_axis
        self.ep_axis = ep_axis

    def embedding(self):
        return ((self.fsdp_axis, self.tp_axis), None)

    def column_parallel(self):
        return (self.fsdp_axis, self.tp_axis)

    def row_parallel(self):
        return (self.tp_axis, self.fsdp_axis)

    def vector(self):
        return (self.fsdp_axis,)

    def transformer_rules(self, column=(), row=(), vector=(), embedding=()):
        """Build a ShardingRules from name patterns per role (the common
        case: one call listing the model's weight-name regexes)."""
        rules = ShardingRules()
        for pat in embedding:
            rules.add(pat, self.embedding())
        for pat in column:
            rules.add(pat, self.column_parallel())
        for pat in row:
            rules.add(pat, self.row_parallel())
        for pat in vector:
            rules.add(pat, self.vector())
        return rules


def program_rules(program):
    """The ShardingRules attached to `program`, created on first use.
    Model-building code (embedding engine, user layers) registers storage
    layouts here; ParallelExecutor merges them with
    BuildStrategy.sharding_rules (build-strategy rules win ties) and the
    pass pipeline carries them across program rewrites."""
    rules = getattr(program, "_sharding_rules", None)
    if rules is None:
        rules = ShardingRules()
        program._sharding_rules = rules
    return rules


class Resolver:
    """Rules bound to a live mesh (the port's parallel.Mesh: its `shape`
    dict is all the Resolver reads): name -> pruned spec.

    Precedence per name (first hit wins):
      1. explicit rules (program rules + BuildStrategy rules, last match
         wins within the combined list);
      2. accumulator alias: optimizer-state tensors (ZERO1_STATE_SLOTS)
         resolve through their parameter's name, so moments always inherit
         the param's storage layout without name-pattern gymnastics;
      3. the legacy `Variable.sharding_spec` attribute
         (parallel.shard_parameter);
      4. ZeRO-1 state names (set by the executor) -> (zero1_axis,);
      5. replicated.

    Pruning makes any program runnable on any mesh: axes the mesh lacks (or
    has at extent 1) drop out; a dim whose size doesn't divide its axes'
    combined extent degrades to replication for that dim; a spec longer
    than the value's rank resolves to replicated. All-None specs collapse
    to None so callers can treat None as 'no placement opinion'.

    The JAX Resolver's `named_sharding`, `constrain` and `constrain_outputs`
    tell GSPMD where a value lives; the port has no partitioner, so what a
    rank stores (`storage_specs`) and what it sends (`Layouts`) take their
    place."""

    def __init__(self, mesh, rules=None, var_lookup=None):
        self.mesh = mesh
        self.rules = rules if rules is not None and len(rules) else None
        self._var_lookup = var_lookup  # name -> Variable or None (legacy attr)
        self.aliases = {}  # state/accumulator name -> param name
        self.zero1_axis = None
        self.zero1_names = frozenset()
        # structured record of every divisibility degradation _prune applied
        # (was silent before the static analyzer landed): [(name, dim, axes,
        # dim_size, extent)], recorded once per (name, dim) and counted into
        # the observability registry (analysis/sharding_degraded). fluidlint's
        # sharding-rules checker reports the same condition statically.
        self.degraded = []
        self._degraded_seen = set()

    def set_zero1(self, axis, names):
        self.zero1_axis = axis
        self.zero1_names = frozenset(names)

    def add_aliases(self, ops):
        """Map every optimizer-state input (ZERO1_STATE_SLOTS) to its op's
        Param name so layer 2 can resolve accumulators."""
        for op in ops:
            slots = ZERO1_STATE_SLOTS.get(op.type)
            if not slots:
                continue
            params = op.inputs.get("Param", ())
            if not params:
                continue
            for slot in slots:
                for name in op.inputs.get(slot, ()):
                    self.aliases[name] = params[0]

    def _record_degraded(self, name, dim, axes, dim_size, extent):
        key = (name, dim)
        if name is None or key in self._degraded_seen:
            return
        self._degraded_seen.add(key)
        self.degraded.append((name, dim, axes, dim_size, extent))
        from ..observability import registry as _registry

        _registry.default_registry().counter(
            "analysis/sharding_degraded",
            "spec dims degraded to replication because the dim size did not "
            "divide the mesh-axes extent",
        ).inc(axes="+".join(axes))

    def _prune(self, spec, shape, name=None):
        if spec is None:
            return None
        shape = tuple(shape) if shape is not None else None
        if shape is not None and len(spec) > len(shape):
            return None
        out = []
        for dim, entry in enumerate(spec):
            axes = () if entry is None else (
                tuple(entry) if isinstance(entry, tuple) else (entry,)
            )
            kept = tuple(a for a in axes if self.mesh.shape.get(a, 1) > 1)
            if kept and shape is not None:
                extent = int(np.prod([self.mesh.shape[a] for a in kept]))
                if shape[dim] % extent != 0:
                    self._record_degraded(name, dim, kept, shape[dim], extent)
                    kept = ()
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        if all(e is None for e in out):
            return None
        return tuple(out)

    def rule_spec(self, name, shape=None):
        """Layers 1-3 only (explicit rules / alias / legacy attr), pruned to
        this mesh. The layer the ZeRO-1 tier defers to: a param whose rule
        survives pruning leaves the zero1 path entirely."""
        raw = None
        if self.rules is not None:
            raw = self.rules.match(name)
            if raw is None and name in self.aliases:
                raw = self.rules.match(self.aliases[name])
        if raw is None and self._var_lookup is not None:
            v = self._var_lookup(name)
            if v is None and name in self.aliases:
                v = self._var_lookup(self.aliases[name])
            spec = getattr(v, "sharding_spec", None)
            if spec is not None:
                raw = _normalize_spec(spec)
        return self._prune(raw, shape, name=name)

    def audit(self, names):
        """Dead-rule audit: patterns matching none of `names` (typically the
        lowered block's vars plus the scope's persistables) are typos or
        stale layouts silently replicating their target. Returns the dead
        pattern list and counts each into the observability registry
        (analysis/sharding_dead_rules); the executor runs this once per
        compile, fluidlint's sharding-rules checker statically."""
        if self.rules is None:
            return []
        names = list(names)
        dead = []
        for pattern, rx, _ in self.rules._rules:
            if not any(rx.search(n) for n in names):
                dead.append(pattern)
        if dead:
            from ..observability import registry as _registry

            c = _registry.default_registry().counter(
                "analysis/sharding_dead_rules",
                "sharding rules whose pattern matched no var at compile",
            )
            for pattern in dead:
                c.inc(pattern=pattern)
        return dead

    def spec(self, name, shape=None):
        """Full precedence chain -> pruned spec tuple or None (replicated)."""
        s = self.rule_spec(name, shape)
        if s is not None:
            return s
        if name in self.zero1_names:
            return (self.zero1_axis,)
        return None


# ---------------------------------------------------------------------------
# what a rank stores and what it sends (the port's counterpart of
# named_sharding / constrain / opt_constrain_ins / opt_constrain_outs)
# ---------------------------------------------------------------------------

# optimizer state slots aliased to their parameter (the JAX package's
# core_ops.ZERO1_STATE_SLOTS); ZeRO-1 stores the same slots sharded
ZERO1_STATE_SLOTS = {
    "momentum": ("Velocity",),
    "lars_momentum": ("Velocity",),
    "adam": ("Moment1", "Moment2"),
    "adagrad": ("Moment",),
    "decayed_adagrad": ("Moment",),
    "rmsprop": ("MeanSquare", "Moment", "MeanGrad"),
    "adadelta": ("AvgSquaredGrad", "AvgSquaredUpdate"),
    "adamax": ("Moment", "InfNorm"),
    "ftrl": ("SquaredAccumulator", "LinearAccumulator"),
}

# the axes whose layouts Layouts carries; a row spec over ep is the
# row-sharded embedding's own path (embedding/, ops/parallel_ops.py)
LAYOUT_AXES = ("fsdp", "tp")

_EMPTY = "@EMPTY@"


def _entry_axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _pad(spec, ndim):
    """spec padded with None to ndim entries; None when nothing is split."""
    if spec is None:
        return None
    spec = tuple(spec)[:ndim] + (None,) * (ndim - len(spec))
    return spec if any(e is not None for e in spec) else None


def storage_specs(resolver, names, shapes):
    """{name: spec} of the persistables a rank stores as pieces over fsdp /
    tp: each name's resolved spec (resolver.rule_spec, pruned to the mesh)
    padded to its rank. A spec over ep alone is left to the row-sharded
    embedding; one that mixes ep with fsdp or tp raises."""
    out = {}
    for n in names:
        shape = shapes[n]
        spec = resolver.rule_spec(n, shape)
        if spec is None:
            continue
        axes = {a for e in spec for a in _entry_axes(e)}
        if not axes & set(LAYOUT_AXES):
            continue
        if axes - set(LAYOUT_AXES):
            raise NotImplementedError(
                "%s: spec %s mixes %s with fsdp / tp; a rule places a variable over fsdp "
                "and tp only, or over ep alone (the row-sharded embedding)"
                % (n, spec, sorted(axes - set(LAYOUT_AXES))))
        out[n] = _pad(spec, len(shape))
    return out


def _tp_only(spec):
    """The part of a layout the tp-aware ops keep split: its dims over tp
    alone (an fsdp piece is gathered where it is used)."""
    if spec is None:
        return None
    out = tuple("tp" if e == "tp" else None for e in spec)
    return out if any(out) else None


def _last(ndim):
    return (None,) * (ndim - 1) + ("tp",)


class _Plan:
    """How one op lowers over pieces: `want` (name -> the layout its input
    must have; absent: whole), `outs` (name -> the layout of an output;
    absent: whole), `like` ((spec, shape): an output of that local shape
    takes spec), `attrs` (in place of the op's), `post` ((name, kind) of
    outputs all-reduced over tp after the lowering, the Megatron g)."""

    def __init__(self, want=None, outs=None, like=None, attrs=None, post=()):
        self.want = want or {}
        self.outs = outs or {}
        self.like = like
        self.attrs = attrs
        self.post = list(post)


def _slot(op, slot):
    names = op.inputs.get(slot) or op.outputs.get(slot) or []
    return names[0] if names and names[0] != _EMPTY else None


class Layouts:
    """One run's layouts: `lay` maps a name to the layout of the piece the
    run's env holds (one entry a dimension: None or the axes it is split
    over); a name it lacks is whole. It starts from the stored pieces
    (storage_specs) and follows every op (`lower_one`, called by
    registry._lower_one for each op of the run)."""

    def __init__(self, mesh, stored):
        self.mesh = mesh
        self.lay = {n: s for n, s in stored.items() if s is not None}

    # ------------------------------------------------------------ pieces
    def spec(self, name, t):
        s = self.lay.get(name)
        return None if s is None or not hasattr(t, "dim") else _pad(s, t.dim())

    def full_shape(self, name, t):
        s = self.spec(name, t)
        if s is None:
            return tuple(t.shape)
        return tuple(d * self.mesh.axis_size(e) if e is not None else d
                     for d, e in zip(t.shape, s))

    def piece_shape(self, shape, spec):
        if spec is None:
            return tuple(shape)
        return tuple(d // self.mesh.axis_size(e) if e is not None else d
                     for d, e in zip(shape, spec))

    def convert(self, t, have, want):
        """t (a piece under `have`) as the piece under `want`: a dimension
        split differently is all-gathered, then sliced."""
        from . import collectives as C

        nd = t.dim()
        have, want = _pad(have, nd) or (None,) * nd, _pad(want, nd) or (None,) * nd
        for d in range(nd):
            if have[d] == want[d]:
                continue
            if have[d] is not None:
                t = C._gather(t, have[d], d, self.mesh)
            if want[d] is not None:
                t = C._piece(t, want[d], d, self.mesh)
        return t

    def whole(self, name, t):
        """The whole value of env's `name` (gathered if it is a piece)."""
        s = self.spec(name, t)
        return t if s is None else self.convert(t, s, None)

    def use(self, name, env):
        t = env.get(name)
        return _tp_only(self.spec(name, t)) if t is not None else None

    # ------------------------------------------------------------ ops
    def lower_one(self, ctx, op, env, opdef):
        from ..ops.registry import lower_op

        ins = [n for n in op.input_arg_names if n != _EMPTY and n in env]
        if not any(self.spec(n, env[n]) for n in ins):
            lower_op(ctx, op, env, opdef)
            for n in op.output_arg_names:
                self.lay.pop(n, None)
            return
        plan = None
        handler = _HANDLERS.get(op.type[:-5] if op.type.endswith("_grad") else op.type)
        if handler is not None:
            plan = handler(self, op, env, op.type.endswith("_grad"))
        if plan is None and _is_opt(op):
            plan = self._optimizer_plan(op, env)
        self._run(ctx, op, env, opdef, plan or _Plan(), ins)

    def _run(self, ctx, op, env, opdef, plan, ins):
        from ..ops.registry import lower_op
        from . import collectives as C

        saved = {}
        for n in set(ins):
            t = env[n]
            have = self.spec(n, t)
            want = _pad(plan.want.get(n), t.dim()) if hasattr(t, "dim") else None
            if have != want:
                saved[n] = t
                env[n] = self.convert(t, have, want)
        lower_op(ctx, op, env, opdef, plan.attrs)
        outs = {n for n in op.output_arg_names if n != _EMPTY}
        for n, t in saved.items():
            if n not in outs:
                env[n] = t
        for n in outs:
            t = env.get(n)
            spec = plan.outs.get(n)
            if spec is None and plan.like is not None and hasattr(t, "shape") \
                    and tuple(t.shape) == plan.like[1]:
                spec = plan.like[0]
            if spec is not None and any(e is not None for e in spec):
                self.lay[n] = spec
            else:
                self.lay.pop(n, None)
        for n, kind in plan.post:
            if n in env and n in outs:
                env[n] = C._sum(env[n], "tp", self.mesh, kind)

    def _optimizer_plan(self, op, env):
        """An optimizer op over a placed parameter updates its piece: every
        floating input of the parameter's whole shape is taken as its piece
        (the gradient, the moments), every output of the piece's shape is
        one (ParamOut, the moments out); scalar state stays whole."""
        p = _slot(op, "Param")
        if p is None or p not in env:
            return None
        spec = self.spec(p, env[p])
        if spec is None:
            return None
        full = self.full_shape(p, env[p])
        want = {}
        for n in op.input_arg_names:
            t = env.get(n)
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and self.full_shape(n, t) == full):
                want[n] = spec
        return _Plan(want, like=(spec, tuple(env[p].shape)))


def _is_opt(op):
    from ..transpiler.gradient_merge import OPTIMIZER_OP_TYPES

    return op.type in OPTIMIZER_OP_TYPES


def _h_unary(L, op, env, grad):
    """Elementwise ops of one operand (activations, scale, dropout, cast)
    and their grads: a split operand keeps its layout, and so does every
    input and output of its shape."""
    main = next((n for n in op.input_arg_names if n in env and L.spec(n, env[n])), None)
    spec = L.use(main, env)
    if spec is None or spec != L.spec(main, env[main]):
        return None
    full = L.full_shape(main, env[main])
    want = {n: spec for n in op.input_arg_names
            if n in env and hasattr(env[n], "shape") and L.full_shape(n, env[n]) == full}
    return _Plan(want, like=(spec, L.piece_shape(full, spec)))


def _h_rowwise(L, op, env, grad):
    """softmax (and its grad) over the last axis of an operand split on
    another."""
    if int(op.attrs.get("axis", -1)) != -1:
        return None
    main = next((n for n in op.input_arg_names if n in env and L.spec(n, env[n])), None)
    spec = L.use(main, env)
    if spec is None or spec[-1] is not None:
        return None
    return _h_unary(L, op, env, grad)


def _h_binary(L, op, env, grad):
    """elementwise_{add,sub,mul,div,max,min}: X split keeps its layout; Y
    takes the pieces of the dims it shares with X (a bias placed ("tp",)
    is used as it is stored, a whole one is sliced), broadcast dims whole."""
    x, y = _slot(op, "X"), _slot(op, "Y")
    if x is None or y is None or x not in env or y not in env:
        return None
    lx = L.use(x, env)
    if lx is None or lx != L.spec(x, env[x]):
        return None
    fx, fy = L.full_shape(x, env[x]), L.full_shape(y, env[y])
    axis = int(op.attrs.get("axis", -1))
    start = len(fx) - len(fy) if axis == -1 else axis
    wy = []
    for j, d in enumerate(fy):
        k = start + j
        wy.append(lx[k] if 0 <= k < len(fx) and d != 1 and d == fx[k] else None)
    wy = tuple(wy) if any(wy) else None
    want = {x: lx, y: wy}
    outs = {}
    for slot in ("Out", "Out@GRAD"):
        n = _slot(op, slot)
        if n is not None:
            want[n] = lx
            outs[n] = lx
    if grad:
        if _slot(op, "X@GRAD"):
            outs[op.outputs["X@GRAD"][0]] = lx
        if _slot(op, "Y@GRAD"):
            outs[op.outputs["Y@GRAD"][0]] = wy
    return _Plan(want, outs)


def _h_sum(L, op, env, grad):
    """sum (gradient accumulation): addends of one layout keep it."""
    xs = [n for n in op.input("X") if n in env]
    specs = {L.spec(n, env[n]) for n in xs}
    if len(specs) != 1 or None in specs:
        return None
    spec = specs.pop()
    return _Plan({n: spec for n in xs}, {op.output("Out")[0]: spec})


def _h_product(L, op, env, grad):
    """mul / matmul. A weight split over tp on its out-features (column
    parallel) takes the whole input and leaves its product split on the
    last dimension; its input gradient is all-reduced over tp. A weight
    split over tp on its in-features (row parallel) takes the input split
    on its last dimension and all-reduces its product over tp. matmul of
    two operands split on one batch dimension runs on the pieces."""
    x, y = _slot(op, "X"), _slot(op, "Y")
    if x is None or y is None or x not in env or y not in env:
        return None
    tx, ty = env[x], env[y]
    dout = _slot(op, "Out@GRAD")
    out = None if grad else _slot(op, "Out")
    fwd_out = _slot(op, "Out") if grad else None  # a generic grad reads the forward's Out
    gx = op.outputs.get("X@GRAD", [None])[0] if grad else None
    gy = op.outputs.get("Y@GRAD", [None])[0] if grad else None
    ly = L.use(y, env)
    if op.type.startswith("matmul"):
        lx = L.use(x, env)
        if (lx is not None and lx == ly and tx.dim() == ty.dim() and tx.dim() > 2
                and all(e is None for e in lx[-2:]) and lx == L.spec(x, tx)
                and ly == L.spec(y, ty)):
            want = {x: lx, y: ly}
            outs = {}
            for n in (dout, fwd_out):
                if n:
                    want[n] = lx
            for n, s in ((out, lx), (gx, lx), (gy, ly)):
                if n:
                    outs[n] = s
            return _Plan(want, outs)
        if (op.attrs.get("transpose_X", False) or op.attrs.get("transpose_Y", False)
                or ty.dim() != 2):
            return None
    else:
        if int(op.attrs.get("y_num_col_dims", 1)) != 1 or ty.dim() != 2:
            return None
        if int(op.attrs.get("x_num_col_dims", 1)) != tx.dim() - 1:
            return None
    nd = tx.dim()
    if ly == (None, "tp"):  # column parallel
        want, outs, post = {x: None, y: ly}, {}, []
        if out:
            outs[out] = _last(nd)
        for n in (dout, fwd_out):
            if n:
                want[n] = _last(nd)
        if gy:
            outs[gy] = ly
        if gx:
            post.append((gx, "all_reduce_bwd"))
        return _Plan(want, outs, post=post)
    if ly == ("tp", None):  # row parallel
        want, outs, post = {x: _last(nd), y: ly}, {}, []
        if out:
            post.append((out, "all_reduce_fwd"))
        if dout:
            want[dout] = None
        if gx:
            outs[gx] = _last(nd)
        if gy:
            outs[gy] = ly
        return _Plan(want, outs, post=post)
    return None


def _h_reshape(L, op, env, grad):
    """reshape / reshape2 of an operand split on one dimension: the split
    moves to the output dimension that starts the same block of the
    row-major layout (a [b, t, n_head * d] projection split on its last
    dimension becomes [b, t, n_head, d] split on the heads), and the shape
    attribute takes the local extent (n_head / tp)."""
    from ..ops.core_ops import _reshape_shape

    x = _slot(op, "X")
    if x is None or x not in env:
        return None
    lx = L.use(x, env)
    if lx is None or lx != L.spec(x, env[x]) or sum(e is not None for e in lx) != 1:
        return None
    d = next(i for i, e in enumerate(lx) if e is not None)
    n = L.mesh.axis_size(lx[d])
    fin = L.full_shape(x, env[x])
    fout = tuple(_reshape_shape(torch.empty(fin, device="meta"), op.attrs["shape"]))
    pre = int(np.prod(fin[:d]))
    j = None
    for k in range(len(fout)):
        if (int(np.prod(fout[:k])) == pre and fout[k] % n == 0 and fout[k] > 1
                and int(np.prod(fout[k:])) == int(np.prod(fin[d:]))):
            j = k
            break
    if j is None:
        return None
    local = list(fout)
    local[j] //= n
    lo = tuple(lx[d] if k == j else None for k in range(len(fout)))
    attrs = dict(op.attrs, shape=local)
    want, outs = {x: lx}, {}
    o = _slot(op, "Out")
    if o is not None:
        if grad:
            want[o] = lo
        else:
            outs[o] = lo
    if _slot(op, "Out@GRAD"):
        want[op.inputs["Out@GRAD"][0]] = lo
    if grad and _slot(op, "X@GRAD"):
        outs[op.outputs["X@GRAD"][0]] = lx
    return _Plan(want, outs, attrs=attrs)


def _h_transpose(L, op, env, grad):
    """transpose / transpose2: the split follows its dimension."""
    x = _slot(op, "X")
    if x is None or x not in env:
        return None
    lx = L.use(x, env)
    if lx is None or lx != L.spec(x, env[x]):
        return None
    perm = list(op.attrs["axis"])
    lo = tuple(lx[p] for p in perm)
    want, outs = {x: lx}, {}
    o = _slot(op, "Out")
    if o is not None:
        if grad:
            want[o] = lo
        else:
            outs[o] = lo
    if _slot(op, "Out@GRAD"):
        want[op.inputs["Out@GRAD"][0]] = lo
    if grad and _slot(op, "X@GRAD"):
        outs[op.outputs["X@GRAD"][0]] = lx
    return _Plan(want, outs)


def _h_flash(L, op, env, grad):
    """flash_attention on (b, h, t, d) operands split on the heads: each
    rank runs the kernels on its own heads."""
    q, k, v = _slot(op, "Q"), _slot(op, "K"), _slot(op, "V")
    if any(n is None or n not in env for n in (q, k, v)):
        return None
    lq = L.use(q, env)
    if (lq is None or any(L.spec(n, env[n]) != lq for n in (q, k, v))
            or any(e is not None for i, e in enumerate(lq) if i != 1)):
        return None
    lse = lq[:3]
    want = {q: lq, k: lq, v: lq}
    outs = {}
    for slot, s in (("Out", lq), ("Lse", lse)):
        n = _slot(op, slot)
        if n is not None:
            (want if grad else outs)[n] = s
    if _slot(op, "Out@GRAD"):
        want[op.inputs["Out@GRAD"][0]] = lq
    if grad:
        for slot in ("Q@GRAD", "K@GRAD", "V@GRAD"):
            if _slot(op, slot):
                outs[op.outputs[slot][0]] = lq
    return _Plan(want, outs)


_HANDLERS = {"mul": _h_product, "matmul": _h_product, "sum": _h_sum,
             "reshape": _h_reshape, "reshape2": _h_reshape,
             "transpose": _h_transpose, "transpose2": _h_transpose,
             "flash_attention": _h_flash, "softmax": _h_rowwise}
for _t in ("elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
           "elementwise_max", "elementwise_min"):
    _HANDLERS[_t] = _h_binary
for _t in ("relu", "gelu", "tanh", "sigmoid", "scale", "dropout", "cast", "exp", "sqrt",
           "square", "abs", "leaky_relu", "elu", "relu6", "swish", "softplus", "softsign",
           "hard_sigmoid", "brelu", "log", "rsqrt", "reciprocal", "assign"):
    _HANDLERS[_t] = _h_unary
