"""The harness on the CPU: the manifest resolves by name, the window and
busy-time arithmetic, the seeded data, the refusal without a card, and a
whole run of each cell at micro size, where the plain reference follows
the program bitwise."""

import json
import os
import zipfile

import pytest

from gpubench import datagen, harness, run, trace
from gpubench.tests.micro import micro

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def test_every_name_resolves_to_its_file():
    m = harness.manifest()
    for c in m["configs"]:
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert harness.config_of(c["name"])["name"] == c["name"]
        assert c["file"] == f"gpubench/configs/{c['name']}.json"
    for w in m["workloads"]:
        regs = harness.config_of(w["config"])["regularizers"]
        assert harness.traffic_of(w["traffic"])["name"] == w["traffic"]
        limits = set(harness.limits_of(w["name"]))
        assert limits <= {
            "loss", "grad1", "change",
            *(f"{r}_{n}" for r in regs for n in ("penalty", "grad"))}
        assert {"loss", "grad1", "change",
                *(f"{r}_grad" for r in regs)} <= limits
    for metric in m["per_layer"]:
        assert callable(harness.metric_reader(metric["name"]))
        assert set(metric["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("seconds,first,want", [
    (40, 18.0, 2), (40, 15.0, 3), (5, 20.0, 1), (30, 20.0, 2),
    (30, 9.0, 3), (0.1, 1.0, 1)])
def test_whole_periods_nearest_the_seconds(seconds, first, want):
    assert harness.periods(seconds, first) == want


@pytest.mark.parametrize("seconds,first,want", [
    (10, 55.0, False), (10, 20.0, False), (10, 14.8, True), (10, 8.7, True),
    (0.1, 2.5, False)])
def test_a_second_set_up_period_only_where_the_first_is_short(seconds, first,
                                                              want):
    assert harness.second_period(seconds, first) == want


def test_busy_time_is_the_union_of_the_activities():
    acts = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 25.0),
            ("d", 21.0, 22.0), ("e", 30.0, 31.0)]
    assert trace.busy_us(acts) == pytest.approx(18.0)
    assert trace.gaps(acts) == [(12.0, 20.0), (25.0, 30.0)]
    p = trace.Profile(wall_s=40e-6, batches=1, device=acts,
                      host=[("outer", 0.0, 40.0), ("inner", 11.0, 21.0)])
    assert p.busy_s == pytest.approx(18e-6)
    assert trace.top_gaps(p)[0] == ["host: inner", pytest.approx(8e-6)]
    assert trace.top_ops(p, 1) == [["a", pytest.approx(10e-6)]]


def test_the_same_seed_writes_the_same_zip(tmp_path):
    paths = []
    for i in range(2):
        p = str(tmp_path / f"{i}.zip")
        datagen.write_zip(p, datagen.images(2 ** 33 + 5, 12, 32),
                          datagen.labels(2 ** 33 + 5, 12, 10))
        paths.append(p)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    other = datagen.images(2 ** 33 + 6, 12, 32)
    assert (other != datagen.images(2 ** 33 + 5, 12, 32)).any()


def test_labels_are_in_the_zip_where_the_config_has_them(tmp_path):
    for name in ("sg2ada", "ffhq256_sg2ada"):
        c = harness.config_of(name)
        p = str(tmp_path / f"{name}.zip")
        n = 30
        datagen.write_zip(p, datagen.images(7, n, 8),
                          datagen.labels(7, n, int(c["label_dim"])))
        with zipfile.ZipFile(p) as z:
            meta = json.loads(z.read("dataset.json"))
            assert len([f for f in z.namelist() if f.endswith(".png")]) == n
        if c["label_dim"]:
            classes = [lab for _, lab in meta["labels"]]
            assert sorted(set(classes)) == list(range(10))
            assert max(classes.count(k) for k in range(10)) == 3
        else:
            assert meta["labels"] is None


def test_the_measurement_path_refuses_to_run_without_a_card(
        monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
    assert "CUDA" in out.err


def test_without_the_program_it_exits_with_no_result(tmp_path):
    import shutil
    import subprocess
    import sys
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "cannot import the program" in p.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_a_micro_run_is_correct_and_the_reference_follows_it_bitwise(cell):
    config, traffic, overrides = micro(cell)
    out = harness.run(cell, 2 ** 32 + 17, 0.1, True, device="cpu",
                      config=config, traffic=traffic,
                      extra_overrides=overrides, log=lambda s: None)
    assert out["correct"]
    assert all(c["value"] == 0.0 for c in out["checks"].values())
    rec = out["record"]
    assert rec.timed == 1 and rec.batches == traffic["period_batches"]
    assert out["attempted"] == rec.batches and out["failed"] == 0
    assert rec.profile is not None and rec.profile.host
    window = harness.metric_reader("dispatch.window_ms")(rec)
    assert window > 0
    assert harness.metric_reader("regs.r1_ms")(rec) > 0
    ppl = harness.metric_reader("regs.ppl_ms")(rec)
    assert (ppl is None) == ("ppl" not in config["regularizers"])
    assert harness.metric_reader("device.idle_pct")(rec) is None
    assert harness.metric_reader("step.mfu")(rec) is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_one_short_run_on_the_card(cell, cuda_device):
    import subprocess
    import sys
    p = subprocess.run([sys.executable, os.path.join(harness.BENCH,
                                                     "run.py"),
                        "--workload", cell, "--seed", "5", "--seconds",
                        "1", "--trace", "0"], capture_output=True,
                       text=True, cwd=harness.ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
