"""Per-phase device-time breakdown of the port's training step on one GPU.

    python -m style_big_gan_tpu_torch.tools.profile_phases [--batch 32]
        [--out build/profile]

Builds SG2Trainer on configs/ffhq256_sg2ada.yaml at the recipe's full widths
with the seeded in-memory ``seeded_random`` dataset, warms every phase up
twice, then runs each phase (Dmain, Dreg, Gmain, Greg) once under
torch.profiler.  Per phase it prints its wall time; the device's busy time,
the union of the intervals of the device's own activities (kernels, copies,
memsets; the profiler's annotation ranges on the device timeline are left
out, since they repeat the time of the kernels inside them); the sum of
those activities' times (above the busy time where streams overlap); the
idle share of the wall time (1 - busy / wall); the warp-pass kernels' time
(every kernel of csrc/warp_pass.cu is named warp_pass_*);
and the top kernels by device time.  It raises if the busy time exceeds
the wall time.  Writes each phase's top table to --out.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def device_activities(prof) -> list:
    """The profiled run's device activities (kernels, copies, memsets):
    events on the CUDA timeline that are not annotation ranges."""
    from torch.autograd import DeviceType
    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and "annotation" not in str(getattr(e, "activity_type", ""))
            and e.time_range.elapsed_us() > 0]


def busy_us(events) -> float:
    """Length of the union of the events' time intervals."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_phases: CUDA is not available", file=sys.stderr)
        return 2
    from style_big_gan_tpu_torch import registries
    from style_big_gan_tpu_torch.arguments import load_config
    from style_big_gan_tpu_torch.utils.misc import gpu_name_and_power_limit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    cfg = load_config(argv=[
        "exp.name=profile", "data.dataset=seeded_random",
        "data.dataset_path=in_memory", "perf.device=cuda",
        f"gen.batch={args.batch}", "gen.kimg=1",
        f"log.output={os.path.join(ROOT, 'build', 'profile_runs')}"],
        yaml_path=os.path.join(ROOT, "configs", "ffhq256_sg2ada.yaml"))
    tr = registries.trainers[str(cfg.exp.trainer)]()
    tr.setup_arguments(cfg)
    tr.setup_logs()
    try:
        for stage in ("dataset", "networks", "augmentations",
                      "training_phases"):
            getattr(tr, f"setup_{stage}")()
        real, real_c, gen_c = tr._device_batch(0)
        steps = tr.steps
        phases = {
            "Dmain": lambda: steps.d_step(real, real_c, gen_c),
            "Dreg": lambda: steps.d_reg_step(real, real_c, gen_c),
            "Gmain": lambda: steps.g_step(gen_c, 0.999),
            "Greg": lambda: steps.g_reg_step(gen_c),
        }
        for fn in phases.values():
            for _ in range(2):
                fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        smi = gpu_name_and_power_limit()
        print(f"[profile] {torch.cuda.get_device_name(0)} ({smi}), batch "
              f"{args.batch}, 256 px full width")
        for name, fn in phases.items():
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.time()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.time() - t0) * 1e3
            acts_dev = device_activities(prof)
            busy_ms = busy_us(acts_dev) / 1e3
            sum_ms = sum(e.time_range.elapsed_us() for e in acts_dev) / 1e3
            if busy_ms > wall_ms:
                raise RuntimeError(f"{name}: device busy {busy_ms:.3f} ms "
                                   f"exceeds the wall time {wall_ms:.3f} ms")
            by_name = {}
            for e in acts_dev:
                ms, cnt = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                                   cnt + 1)
            warp_ms = sum(ms for k, (ms, _) in by_name.items()
                          if "warp_pass_" in k)
            print(f"[profile] {name}: wall {wall_ms:.3f} ms, device busy "
                  f"{busy_ms:.3f} ms, activity sum {sum_ms:.3f} ms, idle "
                  f"{1 - busy_ms / wall_ms:.2%}, warp kernels "
                  f"{warp_ms:.3f} ms, {len(acts_dev)} activities")
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
            lines = [f"    {ms:9.3f} ms  x{cnt:<5d} {k[:90]}"
                     for k, (ms, cnt) in top]
            print("\n".join(lines[:args.top]))
            with open(os.path.join(args.out, f"{name}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    finally:
        tr.data_iter.close()
        tr.stats_jsonl.close()
        tr.logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
