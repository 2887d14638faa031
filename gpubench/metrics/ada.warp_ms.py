"""ada.warp_ms: device time of the ADA pipe's warp kernels (every kernel
of csrc/warp_pass.cu is named warp_pass_*) per batch, over the profiled
period; nothing without a profile or without those kernels."""


def read(record):
    p = record.profile
    if p is None or not p.batches:
        return None
    us = sum(end - start for name, start, end in p.device
             if "warp_pass_" in name)
    return us / 1e3 / p.batches if us > 0 else None
