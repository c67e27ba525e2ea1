"""Heads past 128 on one CUDA card, against two checkouts.

    python3 -m paddle_tpu_torch.tools.wide_heads_ab --base DIR [--rounds 2] \
        [--out wide_heads_ab.json]

Run from the root of a checkout that holds chip_smoke.py. DIR is the root of
another checkout (for example a `git archive` of another commit,
unpacked); this checkout is the other side. Each round runs, in a process
of its own that imports one side's paddle_tpu_torch, this checkout's
chip_smoke functions:
- every wide paged edge case (chip_smoke.wide_paged_cases: decode and
  prefill forms, head widths 160-512, page sizes 16-128, f32 and int8
  pools) against the plain version, recorded as its max abs error or as
  the exception it raised;
- the wide paged kernel in both forms and pool types at Gemma 7B's
  attention widths (chip_smoke.time_paged_wide: device ms, plain ms, bound);
- the flash forward at (16, 8, 256, 256) and (16, 8, 256, 512) f32 with
  scaled_dot_product_attention beside it (chip_smoke.time_flash_fwd);
- in each side's first round, the wide-head serve phase
  (chip_smoke.serve_wide), recorded as passed or as what it raised.
The rounds go base, change, change, base, ... (tools/_ab.py). Prints
every reading as one JSON object and writes all of them to --out. Exits
non-zero without a CUDA device or if a round's process fails (a case that
raises is a reading, not a failure).
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


def _error(e):
    return "%s: %s" % (type(e).__name__, (str(e).strip().splitlines() or [""])[0][:300])


def _round(cs, torch, serve):
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_flash as pf
    from paddle_tpu_torch.tools.profile_generation import card_line

    device = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    flush.zero_()  # its module loads before the first gate
    cases = {}
    for i, case in enumerate(cs.wide_paged_cases()):
        try:
            cases[case[0]] = cs.run_wide_paged_case(torch, pf, device, case, cs.SEED + 200 + i)
        except Exception as e:  # a reading: which shapes this side cannot run
            cases[case[0]] = _error(e)
            torch.cuda.synchronize()
    readings = {"cases": cases}
    try:
        readings["paged"] = {
            name: {k: e[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
            for name, e in cs.time_paged_wide(torch, pf, device, flush, strict=False).items()}
    except Exception as e:
        readings["paged"] = _error(e)
    flash = {}
    for shape in (cs.FLASH_WIDE_TIMED, cs.FLASH_WIDE_TIMED_512):
        err, ms, plain, lib, tc, cc = cs.time_flash_fwd(torch, fa, device, flush, shape,
                                                        cs.SEED + 90)
        flash[str(shape)] = {"ms": ms, "plain_ms": plain, "sdpa_ms": lib, "max_abs_err": err,
                             "bound_ms": tc[0], "cuda_core_bound_ms": cc[0]}
    readings["flash_fwd"] = flash
    if serve:
        del flush
        torch.cuda.empty_cache()
        try:
            launches, fwd = cs.serve_wide(torch, pf, card_line())
            readings["serve_wide"] = {"passed": True, "launches": launches, "flash_fwd": fwd}
        except Exception as e:
            readings["serve_wide"] = {"passed": False, "raised": _error(e)}
    return readings


def _child(root, smoke, mode, serve):
    """One side's process: build its kernels, or run one round."""
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("wide_heads_ab: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import _build

    if mode == "build":
        _build.build_all()
        return 0
    spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs its phases
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(_round(cs, torch, serve)), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2, help="rounds of each side")
    ap.add_argument("--out", default="wide_heads_ab.json")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--mode", help=argparse.SUPPRESS)
    ap.add_argument("--smoke", help=argparse.SUPPRESS)
    ap.add_argument("--serve", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        return _child(a.child, a.smoke, a.mode, a.serve)
    if not a.base:
        ap.error("--base is required")
    return _ab.run(os.path.abspath(__file__), a.base, a.rounds, a.out, ["--serve"])


if __name__ == "__main__":
    sys.exit(main())
