"""Program pretty-printer + graphviz export (the torch port of
paddle_tpu/debugger.py; per-op costs from the port's
observability.opprof).

Reference analog: python/paddle/fluid/debugger.py (pprint_program_codes /
pprint_block_codes over the protobuf descs, draw_block_graphviz) and
graphviz.py/net_drawer.py dot emitters; C++ side had ir/graph_viz_pass.cc.
Here the IR is the in-memory Program, so the printers walk Blocks directly.
"""

__all__ = ["pprint_program_codes", "pprint_block_codes", "draw_block_graphviz"]

from . import framework


def _repr_var(v):
    shape = "?" if v.shape is None else "x".join(str(d) for d in v.shape)
    return "%s[%s,%s]" % (v.name, v.dtype or "?", shape)


def _repr_op(op):
    ins = ", ".join(
        "%s=%s" % (slot, names) for slot, names in sorted(op.inputs.items()) if names
    )
    outs = ", ".join(
        "%s=%s" % (slot, names) for slot, names in sorted(op.outputs.items()) if names
    )
    attrs = {
        k: v
        for k, v in op.attrs.items()
        if not k.startswith("__") and k not in (framework.OpRole.OP_ROLE_KEY,)
        and not isinstance(v, framework.Block)
    }
    return "%s(%s) -> %s  %s" % (op.type, ins, outs, attrs if attrs else "")


def pprint_block_codes(block, show_backward=False):
    lines = ["block_%d {" % block.idx]
    for v in block.vars.values():
        lines.append("  var %s%s" % (_repr_var(v), " persist" if v.persistable else ""))
    for op in block.ops:
        role = op.attrs.get(framework.OpRole.OP_ROLE_KEY)
        # op_role is a bitflag (Backward|Loss on the loss-seed op): test the bit
        if (
            not show_backward
            and role is not None
            and int(role) & int(framework.OpRole.Backward)
        ):
            continue
        lines.append("  " + _repr_op(op))
    lines.append("}")
    return "\n".join(lines)


def pprint_program_codes(program, show_backward=False):
    return "\n".join(
        pprint_block_codes(program.block(i), show_backward)
        for i in range(program.num_blocks)
    )


def _normalize_costs(costs):
    """Accepts either a plain {op name: ms} mapping or a full op_profile
    record (observability/opprof.py build_record: {"ops": [{"op", "total_ms",
    ...}]}) and returns {name: ms}."""
    if not costs:
        return {}
    if isinstance(costs, dict) and isinstance(costs.get("ops"), list):
        return {
            str(row["op"]): float(row.get("total_ms", 0.0))
            for row in costs["ops"]
            if row.get("op")
        }
    return {str(k): float(v) for k, v in dict(costs).items()}


def _heat_color(frac):
    """Cold (the default box blue #d2e5ff) → hot (red) by cost fraction."""
    frac = min(max(frac, 0.0), 1.0)
    r = int(0xD2 + frac * (0xFF - 0xD2))
    g = int(0xE5 + frac * (0x84 - 0xE5))
    b = int(0xFF + frac * (0x66 - 0xFF))
    return "#%02x%02x%02x" % (r, g, b)


def _op_cost(op, costs):
    """ms for one op: exact instance match ("<type>:<out>") first, then the
    bare type (host-events tables may only resolve to type granularity)."""
    from .observability import opprof as _opprof

    ms = costs.get(_opprof.op_display_name(op))
    if ms is None:
        ms = costs.get(op.type)
    return ms


def draw_block_graphviz(block, highlights=None, path="./temp.dot", costs=None):
    """Emit a dot graph: op nodes (boxes) wired through var nodes (ellipses),
    like the reference's draw_block_graphviz / graph_viz_pass.

    costs: optional per-op device time — a {op name: ms} mapping or an
    op_profile record from tools/op_profile.py --json / the telemetry stream.
    Matching op nodes get a "(x.xx ms)" label line and a heat fill (cost
    relative to the block's most expensive op)."""
    highlights = set(highlights or [])
    costs = _normalize_costs(costs)
    max_ms = max(costs.values()) if costs else 0.0
    lines = ["digraph G {", "  rankdir=TB;"]
    seen_vars = set()

    def var_node(name):
        if name not in seen_vars:
            seen_vars.add(name)
            color = ' style=filled fillcolor="#ffd2d2"' if name in highlights else ""
            lines.append('  "v_%s" [label="%s" shape=ellipse%s];' % (name, name, color))
        return '"v_%s"' % name

    for i, op in enumerate(block.ops):
        op_id = '"op_%d_%s"' % (i, op.type)
        label = op.type
        fill = "#d2e5ff"
        ms = _op_cost(op, costs) if costs else None
        if ms is not None:
            label = "%s\\n(%.2f ms)" % (op.type, ms)
            fill = _heat_color(ms / max_ms if max_ms > 0 else 0.0)
        lines.append(
            '  %s [label="%s" shape=box style=filled fillcolor="%s"];'
            % (op_id, label, fill)
        )
        for name in op.input_arg_names:
            lines.append("  %s -> %s;" % (var_node(name), op_id))
        for name in op.output_arg_names:
            lines.append("  %s -> %s;" % (op_id, var_node(name)))
    lines.append("}")
    dot = "\n".join(lines)
    with open(path, "w") as f:
        f.write(dot)
    return dot
