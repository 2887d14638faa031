"""The readers of the program's spans (spans.py and the five metrics that
use it) on hand-made profiles and totals: the idle intersection, the
device time per call, nothing from a program without the tracer, and a
micro traced run on the CPU, whose totals are the profiled period's."""

import sys
import types

import pytest

from gpubench import harness, spans, trace
from gpubench.tests.micro import micro

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
NEW = ("loop.idle_pct", "phase.idle_pct", "dispatch.window_device_ms",
       "regs.r1_grad_ms", "regs.r1_backward_ms")


def _record(device=(), host=(), wall_s=1.0):
    p = trace.Profile(wall_s=wall_s, batches=4, device=list(device),
                      host=list(host))
    return harness.Record(config={}, traffic={}, device_kind="test",
                          profile=p)


def _read(name, rec):
    return harness.metric_reader(name)(rec)


@pytest.fixture
def tracer(monkeypatch):
    """A stand-in for the program's tracer with the given totals."""
    mod = types.ModuleType(spans.TRACER)
    mod.now = {}
    mod.totals = lambda: mod.now
    monkeypatch.setitem(sys.modules, spans.TRACER, mod)
    return mod


def test_the_new_metrics_are_in_the_manifest_and_resolve():
    """Each per-layer metric lists some of the cells and each cell is in
    some metric's list; a new cell need not join an existing list; and a
    regularizer's reader (``regs.<reg>_*``) lists only cells whose
    configuration has that regularizer."""
    m = harness.manifest()
    regs = {w["name"]: harness.config_of(w["config"])["regularizers"]
            for w in m["workloads"]}
    by_name = {metric["name"]: metric for metric in m["per_layer"]}
    assert set(CELLS) <= {c for metric in m["per_layer"]
                          for c in metric["workloads"]}
    for metric in m["per_layer"]:
        cells = metric["workloads"]
        assert cells and set(cells) <= set(CELLS)
        if metric["name"].startswith("regs."):
            reg = metric["name"][len("regs."):].split("_")[0]
            assert all(reg in regs[c] for c in cells)
    for name in NEW:
        assert by_name[name]["moves"] == "imgs_per_s"
        assert callable(harness.metric_reader(name))


def test_idle_under_spans_counts_each_gap_once():
    """Device busy 0-100, 200-300, 400-500 and 600-700 us: gaps 100-200,
    300-400 and 500-600.  ``loop/a`` covers half of the first gap,
    ``loop/b`` and its nested ``loop/b/c`` all of the second (counted
    once); the third lies under a phase alone."""
    device = [("k", 0, 100), ("k", 200, 300), ("k", 400, 500),
              ("k", 600, 700)]
    host = [("loop/a", 150, 250), ("loop/b", 280, 420),
            ("loop/b/c", 300, 400), ("phase/Dmain", 450, 650),
            ("phase/Dmain/sync", 500, 600), ("aten::copy_", 100, 200)]
    rec = _record(device, host, wall_s=1e-3)
    assert _read("loop.idle_pct", rec) == pytest.approx(15.0)   # 150 us
    assert _read("phase.idle_pct", rec) == pytest.approx(10.0)  # 100 us
    assert spans.union([(3, 4), (0, 2), (1, 3), (6, 7)]) == [(0, 4), (6, 7)]
    assert spans.overlap([(0, 4), (6, 7)], [(3, 6.5)]) == 1.5


def test_the_period_s_two_ends_are_idle_too():
    """Before the device's first activity and after its last, up to the
    host's first and last operation, the device idles as well."""
    device = [("k", 100, 200), ("k", 300, 400)]
    host = [("loop/tick_stats", 0, 50), ("loop/data_wait", 50, 150),
            ("phase/cycle", 150, 420), ("loop/tick", 420, 500)]
    p = trace.Profile(wall_s=5e-4, batches=1, device=device, host=host)
    assert spans.idle(p) == [(0, 100), (200, 300), (400, 500)]
    rec = _record(device, host, wall_s=5e-4)
    assert _read("loop.idle_pct", rec) == pytest.approx(36.0)   # 180 us
    assert _read("phase.idle_pct", rec) == pytest.approx(24.0)  # 120 us


def test_no_spans_or_no_device_reads_nothing():
    host = [("aten::copy_", 0, 10)]
    assert _read("loop.idle_pct", _record([("k", 0, 1)], host)) is None
    assert _read("phase.idle_pct", _record((), [("phase/x", 0, 9)])) is None
    rec = _record([("k", 0, 1)], host)
    rec.profile = None
    assert _read("loop.idle_pct", rec) is None


def test_without_the_tracer_the_span_totals_read_nothing(monkeypatch):
    """The parent's program has no tracer: no module, no totals."""
    monkeypatch.delitem(sys.modules, spans.TRACER, raising=False)
    rec = _record([("k", 0, 1)], [("phase/cycle", 0, 1)])
    for name in NEW[2:]:
        assert _read(name, rec) is None


def test_device_ms_per_call(tracer):
    """Device ms of a span over the count of its phase's spans (two
    rounds of R1 a Dreg call); nothing while a pair is unresolved, on the
    CPU, or without a profile."""
    def t(count, device_ms, timed=None):
        return {"count": count, "host_ms": 1.0, "device_ms": device_ms,
                "device_count": count if timed is None else timed}
    tracer.now = {"window/replay": t(3, 600.0), "phase/Dreg": t(2, 90.0),
                  "r1/grad": t(4, 30.0), "Dreg/backward": t(4, 50.0)}
    rec = _record()
    assert _read("dispatch.window_device_ms", rec) == 200.0
    assert _read("regs.r1_grad_ms", rec) == 15.0
    assert _read("regs.r1_backward_ms", rec) == 25.0
    tracer.now["r1/grad"] = t(4, 20.0, timed=3)
    tracer.now["Dreg/backward"] = t(4, None, timed=0)
    assert _read("regs.r1_grad_ms", rec) is None
    assert _read("regs.r1_backward_ms", rec) is None
    rec.profile = None
    assert _read("dispatch.window_device_ms", rec) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_micro_run_holds_the_profiled_period(cell):
    """On the CPU the profiled period's spans are counted (its one tick's
    windows, and its R1s where the configuration has R1) but carry no
    device time, so the three readers of device time and the two of
    device gaps give nothing."""
    config, traffic, overrides = micro(cell)
    out = harness.run(cell, 2 ** 33 + 5, 0.1, True, device="cpu",
                      config=config, traffic=traffic,
                      extra_overrides=overrides, log=lambda s: None)
    rec = out["record"]
    t = spans.totals(rec)
    period = int(traffic["period_batches"])
    r1 = config["regularizers"].get("r1")
    dregs = period // r1["interval"] if r1 else 0
    assert t["phase/cycle"]["count"] == period // config["steps_per_dispatch"]
    assert t.get("phase/Dreg", {}).get("count", 0) == dregs
    assert t.get("r1/grad", {}).get("count", 0) == \
        dregs * config["batch"] // config["batch_device"]
    assert all(v["device_ms"] is None for v in t.values())
    names = {n for n, _, _ in rec.profile.host}
    assert {"loop/data_wait", "loop/tick", "phase/cycle"} <= names
    r1_names = {"phase/Dreg", "r1/grad"}
    assert r1_names <= names if r1 else not r1_names & names
    for name in NEW:
        assert _read(name, rec) is None


def test_the_report_lists_the_idle_under_no_span():
    """span_report's untraced stretches: the device's gaps less the
    loop's and the phases' spans, the longest first, each named by the
    innermost host operation at its middle (ties in time order)."""
    from gpubench import span_report
    device = [("k", 0, 100), ("k", 200, 300), ("k", 400, 500)]
    host = [("loop/a", 150, 250), ("aten::copy_", 100, 150),
            ("cudaStreamSynchronize", 300, 400), ("phase/x", 350, 380)]
    p = trace.Profile(wall_s=1e-3, batches=1, device=device, host=host)
    gaps, total = span_report.untraced(p)
    assert gaps == [["aten::copy_", 50.0, "", "loop/a"],
                    ["cudaStreamSynchronize", 50.0, "loop/a", "phase/x"],
                    ["cudaStreamSynchronize", 20.0, "phase/x", ""]]
    assert total == 120.0
