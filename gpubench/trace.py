"""What the benchmark reads from a ``torch.profiler`` trace of one period.

The busy time is the length of the union of the device's own activities
(kernels, copies, memsets), leaving out the profiler's annotation ranges on
the device timeline, which repeat the time of the kernels inside them (a
copy of the arithmetic of style_big_gan_tpu_torch/tools/profile_phases.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

Interval = Tuple[str, float, float]          # (name, start us, end us)


@dataclass
class Profile:
    """One profiled period: host wall seconds, the device's activities and
    the host's operations, each (name, start us, end us)."""
    wall_s: float
    batches: int
    device: List[Interval] = field(default_factory=list)
    host: List[Interval] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return busy_us(self.device) / 1e6


def from_profiler(prof, wall_s: float, batches: int) -> Profile:
    """The device activities and host operations of a stopped profiler."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.events():
        start, end = float(e.time_range.start), float(e.time_range.end)
        if end <= start:
            continue
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or \
                    "annotation" in str(getattr(e, "activity_type", "")):
                continue
            device.append((e.name, start, end))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, start, end))
    return Profile(wall_s=wall_s, batches=batches, device=device, host=host)


def busy_us(intervals: List[Interval]) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((s, e) for _, s, e in intervals):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def gaps(intervals: List[Interval]) -> List[Tuple[float, float]]:
    """The idle stretches between the union's pieces, (start, end) us."""
    out, end = [], None
    for start, stop in sorted((s, e) for _, s, e in intervals):
        if end is not None and start > end:
            out.append((end, start))
        end = stop if end is None else max(end, stop)
    return out


def top_ops(p: Profile, n: int = 10) -> List[List]:
    """The device operations that took most time, [name, seconds]."""
    by_name = {}
    for name, start, end in p.device:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], secs] for name, secs in top]


def top_gaps(p: Profile, n: int = 10) -> List[List]:
    """The longest idle gaps, [what the host was doing, seconds]: the
    innermost host operation that covers the gap's middle."""
    out = []
    for start, end in sorted(gaps(p.device), key=lambda g: g[0] - g[1])[:n]:
        mid = (start + end) / 2
        inner = [h for h in p.host if h[1] <= mid <= h[2]]
        label = min(inner, key=lambda h: h[2] - h[1])[0] if inner \
            else "no host operation traced"
        out.append([f"host: {label[:150]}", (end - start) / 1e6])
    return out
