"""regs.r1_ms: the mean time of one R1 call (the trainer's Dreg phase,
synced once) over the timed periods, from ``phase_seconds`` and
``phase_counts``."""


def read(record):
    n = record.delta("phase_counts", "Dreg")
    return 1e3 * record.delta("phase_seconds", "Dreg") / n if n else None
