"""device.idle_pct: the share of the profiled period's host-clock wall time
in which no device activity ran (1 - busy / wall), busy being the union of
the device's own activities (trace.py)."""


def read(record):
    p = record.profile
    if p is None or p.wall_s <= 0 or not p.device:
        return None
    return 100.0 * (1.0 - p.busy_s / p.wall_s)
