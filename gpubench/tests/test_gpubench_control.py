"""What the comparison must catch, at micro size on the CPU: the control
(the reference one precision step down in the program's place) and the
program broken underneath a run by each fault of faults.py that the
cell's configuration can have (``faults.of``: the trainer's, then its
family's own).  Each has to come out as not correct under the cell's
limits."""

import pytest
import torch

from gpubench import control, faults, harness
from gpubench.tests.micro import micro

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def _fails(numbers: dict, cell: str) -> bool:
    limits = harness.limits_of(cell)
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    config, traffic, _ = micro(cell)
    r = control.readings(cell, 2 ** 31 + 99, "cpu", config, traffic)
    assert _fails(r["control"], cell), r


def _config(cell: str) -> dict:
    return harness.config_of(harness.workload(cell)["config"])


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in faults.of(_config(c))])
def test_a_broken_program_is_not_correct(cell, fault, monkeypatch):
    faults.of(_config(cell))[fault](monkeypatch)
    config, traffic, overrides = micro(cell)
    out = harness.run(cell, 12345, 0.1, False, device="cpu", config=config,
                      traffic=traffic, extra_overrides=overrides,
                      log=lambda s: None)
    assert not out["correct"], out["checks"]
    torch.set_grad_enabled(True)
