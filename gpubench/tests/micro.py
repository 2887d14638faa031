"""Micro sizes of the benchmark's cells for the CPU tests: the cell's own
configuration and traffic, cut by its family's ``micro``
(families/<family>.py) so a run and its reference take seconds on the
CPU."""

from __future__ import annotations

import copy

from gpubench import harness


def micro(workload: str):
    """(config, traffic, program overrides) of ``workload`` at micro size."""
    w = harness.workload(workload)
    config = copy.deepcopy(harness.config_of(w["config"]))
    traffic = copy.deepcopy(harness.traffic_of(w["traffic"]))
    return harness.family(config).micro(config, traffic)
