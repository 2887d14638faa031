"""The readings a cell's limits are set from, many seeds in one process:
the program's first period and the comparison with the reference, with
no timed window, as a run of the cell makes them; with ``--fault`` the
program runs with those faults of faults.py planted; with ``--control``
the control (control.py) is read instead.

    python3 gpubench/readings.py --workload <name> --seeds <n> [<n> ...]
        [--fault <name> ...] [--control]

Prints one JSON line per seed: the compared numbers, every gap by window
and call (``harness.detail``) and the seconds it took.  Faults whose
numbers do not meet (``half_batch`` moves Dmain and Gmain, ``r1_weight``
and ``ppl_weight`` each regularizer call, which starts from the program's
own state) may be planted together.  Needs CUDA; the benchmark's runs
never run it.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", nargs="*", default=[])
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("readings: CUDA is not available", file=sys.stderr)
        return 2
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(
        os.path.dirname(BENCH), "build", "gpubench", "torch_extensions"))
    from gpubench import control, harness
    for seed in args.seeds:
        t0 = time.time()
        if args.control:
            out = control.readings(args.workload, seed)
            out = {"control": out["control"],
                   "detail": out["control_detail"]}
        else:
            import pytest
            from gpubench import faults
            mp = pytest.MonkeyPatch()
            planted = faults.of(harness.config_of(
                harness.workload(args.workload)["config"]))
            for name in args.fault:
                planted[name](mp)
            try:
                r = harness.run(args.workload, seed, 0.0, False, timed=0,
                                log=lambda s: print(s, file=sys.stderr))
            finally:
                mp.undo()
                torch.set_grad_enabled(True)
            out = {"numbers": {k: c["value"] for k, c in r["checks"].items()},
                   "correct": r["correct"], "detail": r["detail"]}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, "seconds": time.time() - t0,
                          **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
