"""Model FLOPs of a configuration, from its layer shapes alone: one module
per family (its ``period_flops``), and the time they take at the card's
peaks."""

from typing import Dict


def seconds_at_peak(flops: Dict[str, float], peaks: Dict[str, float]) -> float:
    """The least time the chip could take: each precision's FLOPs over its
    peak rate."""
    return sum(v / peaks[p] for p, v in flops.items())
