"""Parse Prometheus text exposition back into registry-shaped snapshots.

The fleet aggregator (observability/aggregate.py) scrapes every replica's
`GET /metrics` and needs the leaf data back in the exact shape
MetricRegistry.snapshot() produces, so counters can be merged by sum and
histograms bucket-wise. registry.render_prometheus emits two lossless
extras on top of the standard 0.0.4 exposition — a ``# NAME`` comment
mapping the sanitized sample name back to the registry name, and
``_min``/``_max`` samples per histogram — which makes the inversion exact:

    parse(registry.to_prometheus()) == registry.snapshot()

holds bit-for-bit (tested in tests/test_slo.py). Text from a foreign
exporter still parses: missing NAME comments fall back to the sample name,
untyped samples are treated as gauges, and histograms without min/max get
``None`` extremes (percentile clamping then degrades gracefully).

A copy of paddle_tpu/observability/promparse.py (pure Python, no device
code), kept in the port so that the port imports nothing of the JAX
package.
"""

import math
import re

__all__ = ["parse", "parse_labels"]

# name{labels} value [timestamp] — timestamp tolerated and dropped
_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(.*)\})?"
    r"\s+(\S+)"
    r"(?:\s+-?\d+)?$"
)
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

_HIST_SUFFIXES = ("_bucket", "_sum", "_count", "_min", "_max")


def _unescape(s):
    if "\\" not in s:
        return s
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            n = s[i + 1]
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(n, "\\" + n))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _num(tok):
    if tok in ("+Inf", "Inf"):
        return math.inf
    if tok == "-Inf":
        return -math.inf
    if tok == "NaN":
        return math.nan
    try:
        return int(tok)
    except ValueError:
        return float(tok)


def parse_labels(text):
    """Label body (the part between { and }) -> dict of unescaped values."""
    return {m.group(1): _unescape(m.group(2)) for m in _LABEL.finditer(text)}


def _label_key(labels):
    """Label dict -> the snapshot's rendered form ('' when unlabelled),
    matching registry._render_labels over sorted items."""
    return ",".join("%s=%s" % (k, v) for k, v in sorted(labels.items()))


def _family(pname, hist_names):
    """Histogram family for a sample name, or None. `step_ms_bucket` folds
    into `step_ms` only when step_ms is TYPEd as a histogram, so a real
    gauge that merely ends in _sum is left alone."""
    for suffix in _HIST_SUFFIXES:
        if pname.endswith(suffix):
            base = pname[: -len(suffix)]
            if base in hist_names:
                return base, suffix
    return None


def parse(text):
    """Exposition text -> {name: {kind, values | buckets/counts/sum/...}}.

    Unknown comment lines are skipped per spec; torn/garbage sample lines
    are skipped rather than raised (a replica dying mid-write must not take
    the whole fleet scrape down with it).
    """
    types = {}   # prom name -> kind
    names = {}   # prom name -> original registry name
    samples = []  # (prom name, label dict, value) in document order
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3].strip()
            elif len(parts) >= 4 and parts[1] == "NAME":
                names[parts[2]] = parts[3]
            continue  # HELP and arbitrary comments
        m = _SAMPLE.match(line)
        if not m:
            continue
        pname, labelstr, valtok = m.groups()
        try:
            value = _num(valtok)
        except ValueError:
            continue
        samples.append((pname, parse_labels(labelstr) if labelstr else {},
                        value))

    hist_names = {p for p, t in types.items() if t == "histogram"}
    out = {}
    hists = {}  # prom name -> accumulator
    for pname, labels, value in samples:
        fam = _family(pname, hist_names)
        if fam is not None:
            base, suffix = fam
            acc = hists.setdefault(
                base,
                {"le": [], "sum": 0.0, "count": 0, "min": None, "max": None},
            )
            if suffix == "_bucket":
                le = labels.get("le")
                if le is not None:
                    acc["le"].append((_num(le), value))
            elif suffix == "_sum":
                acc["sum"] = value
            elif suffix == "_count":
                acc["count"] = value
            elif suffix == "_min":
                acc["min"] = value
            else:
                acc["max"] = value
            continue
        kind = types.get(pname, "gauge")
        if kind not in ("counter", "gauge"):
            kind = "gauge"  # untyped / summary samples degrade to gauges
        name = names.get(pname, pname)
        rec = out.setdefault(name, {"kind": kind, "values": {}})
        if rec["kind"] == kind:
            rec["values"][_label_key(labels)] = value

    for pname, acc in hists.items():
        pairs = sorted(acc["le"], key=lambda p: p[0])
        bounds = [le for le, _ in pairs if not math.isinf(le)]
        cums = [c for le, c in pairs if not math.isinf(le)]
        counts = [
            c - (cums[i - 1] if i else 0) for i, c in enumerate(cums)
        ]
        inf_cum = next(
            (c for le, c in pairs if math.isinf(le) and le > 0), None
        )
        overflow = (inf_cum - cums[-1]) if (inf_cum is not None and cums) \
            else (inf_cum or 0)
        counts.append(overflow)
        out[names.get(pname, pname)] = {
            "kind": "histogram",
            "buckets": [float(b) for b in bounds],
            "counts": counts,
            "sum": acc["sum"],
            "count": acc["count"],
            "min": acc["min"],
            "max": acc["max"],
        }
    return dict(sorted(out.items()))
