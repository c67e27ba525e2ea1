"""The int8 serving path of chip_smoke.py against two checkouts, on one CUDA card.

    python3 -m paddle_tpu_torch.tools.quant_gemm_ab --base DIR [--rounds 3] \
        [--out quant_gemm_ab.json]

Run from the root of a checkout that holds chip_smoke.py. DIR is the root of
another checkout (for example a `git archive` of the parent commit,
unpacked); this checkout is the other side. Each round runs, in a process
of its own that imports one side's paddle_tpu_torch, this checkout's
chip_smoke.serve_int8_gemm phase (an f32 and a calibrated-int8
ServingEngine over the fc head: rows/s, the single shot's walls, the int8
engine call's device busy ms and its quant GEMM part) and
chip_smoke.qgemm_host_us (the quant GEMM wrapper's host microseconds a
call at path B's bucket). The rounds go base, change, change, base, base,
change, ... so that a drift of the card over the run falls on both sides.
Both sides' kernels are built first, in parallel, each by its own
package. Prints every reading as one JSON object and writes it to --out.
Exits non-zero without a CUDA device or if a round fails.
"""

import argparse
import importlib.util
import json
import os
import sys

if __package__:
    from . import _ab
else:  # run as a file: a round's process
    import _ab


def _child(root, smoke, mode):
    """One side's process: build its kernels, or run one round."""
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("quant_gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import _build

    if mode == "build":
        _build.build_all()
        return 0
    spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.tools.profile_generation import card_line

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs its phases
    torch.backends.cudnn.allow_tf32 = False
    _, readings = cs.serve_int8_gemm(torch, card_line())
    readings["host_us_a_call"] = cs.qgemm_host_us(torch, torch.device("cuda", 0))
    print(json.dumps(readings), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=3, help="rounds of each side")
    ap.add_argument("--out", default="quant_gemm_ab.json")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--mode", help=argparse.SUPPRESS)
    ap.add_argument("--smoke", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        return _child(a.child, a.smoke, a.mode)
    if not a.base:
        ap.error("--base is required")
    return _ab.run(os.path.abspath(__file__), a.base, a.rounds, a.out)


if __name__ == "__main__":
    sys.exit(main())
