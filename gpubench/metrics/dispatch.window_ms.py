"""dispatch.window_ms: the mean host-clock time of one dispatch window (k
batches of Dmain + Gmain, one CUDA-graph replay, synced once) over the
timed periods, from the trainer's ``window_seconds``."""


def read(record):
    w = record.window_seconds
    return 1e3 * sum(w) / len(w) if w else None
