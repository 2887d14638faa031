"""Run one cell of the port's benchmark once.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, the profiled period's busy and window seconds and the
breakdown (BENCHMARK.json names both).  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown``), then ``checks``, each compared number
beside its limit; the same numbers end standard error.  Needs as many
CUDA devices as the cell asks for: without them it exits with 2 and prints
no result.  It exits with 3, and no result, if JAX, flax or the JAX package
is loaded once the window has closed.  See harness.py for what one run
does.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def _caches() -> None:
    """Every build and kernel cache at a fixed directory of the checkout,
    for any extension or Triton kernel the program builds (it builds its
    CUDA kernels into build/torch_kernels/ by itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "gpubench", sub)


def _host_threads() -> None:
    """One intra-op thread for the host's tensor and array work, set
    before torch is imported.  A pool of one thread a core spins on the
    cores that the dispatching thread and the batch-building thread need,
    and the machine's cores may be shared: sg2ada read 848-1045 imgs/s so,
    996-1037 with one thread, in turns on the same seeds (PERF.md,
    section 2)."""
    os.environ["OMP_NUM_THREADS"] = "1"


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    _caches()
    _host_threads()
    try:
        from gpubench import harness
        import style_big_gan_tpu_torch as program
    except ImportError as e:
        print(f"gpubench: cannot import the program: {e}", file=sys.stderr)
        return 2
    if not os.path.abspath(program.__file__).startswith(ROOT + os.sep):
        print(f"gpubench: cannot import the program: this checkout has "
              f"none (found {program.__file__})", file=sys.stderr)
        return 2
    import torch
    w = harness.workload(args.workload)
    try:
        harness.family(harness.config_of(w["config"]))
    except FileNotFoundError as e:
        print(f"gpubench: {e}", file=sys.stderr)
        return 2
    chips = int(w["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"gpubench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    print(f"[gpubench] {args.workload} seed {args.seed} on "
          f"{power_limit()}, torch {torch.__version__}", file=sys.stderr)
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace),
                      log=lambda s: print(s, file=sys.stderr))
    found = harness.forbidden_modules()
    if found:
        print(f"gpubench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    rec = out["record"]
    bench = harness.manifest()
    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            if args.workload not in m.get("workloads", [args.workload]):
                continue
            value = harness.metric_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"imgs_per_s": out["images"] / rec.seconds,
               "peak_mem_gib": out["peak"] / 2 ** 30,
               "setup_s": rec.span()[0].t - T_START}
        for m in bench["end_to_end"]:
            if args.workload in m.get("workloads", [args.workload]):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu", "kind": out["kind"], "count": 1,
              "memory_peak_bytes": out["peak"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace and rec.profile is not None:
        from gpubench import trace
        device["busy_s"] = rec.profile.busy_s
        device["window_s"] = rec.profile.wall_s
        result["breakdown"] = {"device_ops": trace.top_ops(rec.profile),
                               "idle_gaps": trace.top_gaps(rec.profile)}
    result["checks"] = out["checks"]
    first = rec.ticks[0].t - out["loop_start"]
    print(f"[gpubench] first period {first:.3f} s, set-up periods "
          f"{rec.start + 1}; timed {rec.timed} "
          f"period(s), {rec.batches} batches in {rec.seconds:.3f} s",
          file=sys.stderr)
    print(f"[gpubench] gaps by window: {json.dumps(out['detail'])}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
