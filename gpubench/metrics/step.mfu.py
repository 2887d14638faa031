"""step.mfu: the whole training step's share of the card's peak: the time
the chip would need for the timed periods' model FLOPs, each precision at
its data-sheet peak (the configuration's family's ``period_flops``,
peaks.json), over their host-clock seconds; nothing on a card without a
peaks entry."""

from gpubench import harness
from gpubench.flops import seconds_at_peak


def read(record):
    if not record.peaks or record.seconds <= 0 or not record.batches:
        return None
    flops, _ = harness.family(record.config).period_flops(record.config,
                                                          record.batches)
    return 100.0 * seconds_at_peak(flops, record.peaks) / record.seconds
