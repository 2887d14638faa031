"""data.wait_ms: the mean time the training loop waited for the prefetch
thread's next window of batches (``Timing/data_fetch``, kept in the
trainer's ``data_wait_log``) over the timed periods."""


def read(record):
    w = record.data_waits
    return 1e3 * sum(w) / len(w) if w else None
