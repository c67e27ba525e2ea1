"""The loop shared by the base-against-change tools (quant_gemm_ab,
wide_heads_ab): both sides' kernels built first, in parallel, each by its
own package, then rounds in processes of their own, base, change, change,
base, ..., so that a drift of the card over the run falls on both sides.
A round's process prints its readings as one JSON object on its last line.
"""

import json
import os
import subprocess
import sys


def _start(tool, root, mode, extra=()):
    return subprocess.Popen(
        [sys.executable, tool, "--child", root, "--mode", mode,
         "--smoke", os.path.join(os.getcwd(), "chip_smoke.py")] + list(extra),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def run(tool, base, rounds, out, first_round_args=()):
    """Build both sides, run 2 * rounds rounds of `tool`'s child (the side's
    first round with first_round_args), print each reading and write all of
    them to `out`. Returns the exit code."""
    name = os.path.basename(tool).rsplit(".", 1)[0]
    sides = {"base": os.path.abspath(base), "change": os.getcwd()}
    builds = {side: _start(tool, root, "build") for side, root in sides.items()}
    for side, proc in builds.items():
        text = proc.communicate()[0]
        if proc.returncode:
            print(text, file=sys.stderr)
            print("%s: the %s build failed" % (name, side), file=sys.stderr)
            return proc.returncode
    order = [("base", "change", "change", "base")[r % 4] for r in range(2 * rounds)]
    readings, seen = [], set()
    for side in order:
        proc = _start(tool, sides[side], "round", () if side in seen else first_round_args)
        seen.add(side)
        text = proc.communicate()[0]
        if proc.returncode:
            print(text, file=sys.stderr)
            print("%s: a %s round failed" % (name, side), file=sys.stderr)
            return proc.returncode
        readings.append({"side": side, **json.loads(text.strip().splitlines()[-1])})
        print(json.dumps(readings[-1]), flush=True)
    result = {"sides": sides, "order": order, "readings": readings}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0
