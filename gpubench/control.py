"""The control of a cell's comparison: the plain reference (its family's
``follow``) put in the program's place one precision step down
(reference/precision.py), compared
with the reference at the stated precision by the same numbers as a run.
As in a run, each window after the first, and each regularizer call,
starts from the state the side in the program's place had there: here the
reference's own.  ``readings.py --control`` runs it on the card; the
benchmark's runs never run it.
"""

import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH))

from gpubench import harness  # noqa: E402


def readings(workload: str, seed: int, device: str = "cuda",
             config=None, traffic=None) -> dict:
    w = harness.workload(workload)
    config = config or harness.config_of(w["config"])
    traffic = traffic or harness.traffic_of(w["traffic"])
    fam = harness.family(config)
    prog_seed, data_seed = harness.seeds(seed)
    out = {}
    n = harness.FOLLOWED_WINDOWS
    states = {}
    t0 = time.time()
    ref = fam.follow(config, traffic, prog_seed, data_seed, n, device,
                     keep=states)
    out["reference_s"] = time.time() - t0
    t0 = time.time()
    ctl = fam.follow(config, traffic, prog_seed, data_seed, n, device,
                     states=states, lower=True)
    out["control_s"] = time.time() - t0
    out["control"] = harness.compare(ctl, ref, fam.REGS)
    out["control_detail"] = harness.detail(ctl, ref)
    return out
