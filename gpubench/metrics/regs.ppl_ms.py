"""regs.ppl_ms: the mean time of one PPL call (the trainer's Greg phase,
synced once) over the timed periods; nothing where the recipe has no
PPL."""


def read(record):
    n = record.delta("phase_counts", "Greg")
    return 1e3 * record.delta("phase_seconds", "Greg") / n if n else None
