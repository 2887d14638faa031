"""The harness on the CPU: the manifest and each configuration's family
resolve by name, the window and busy-time arithmetic, the pairing of loss
rows, the seeded data, the refusal without a card, and a whole run of each
cell at micro size, where the plain reference follows the program
bitwise, PPL's numbers aside (reference/conv.py)."""

import copy
import json
import os
import shutil
import subprocess
import sys
import zipfile

import pytest
import torch

from gpubench import datagen, harness, run, trace
from gpubench.reference import training
from gpubench.reference.state import Readings
from gpubench.tests.micro import micro

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def test_every_name_resolves_to_its_file():
    m = harness.manifest()
    for c in m["configs"]:
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert harness.config_of(c["name"])["name"] == c["name"]
        assert c["file"] == f"gpubench/configs/{c['name']}.json"
        fam = harness.family(harness.config_of(c["name"]))
        assert callable(fam.follow) and callable(fam.period_flops) and \
            callable(fam.micro)
        assert set(fam.REGS) <= set(harness.REG_STEPS)
        assert all(callable(f) for f in fam.FAULTS.values())
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


@pytest.mark.parametrize("family", [None, "no_such_family"])
def test_a_config_without_its_family_fails_before_the_trainer_is_built(
        family, monkeypatch):
    config = copy.deepcopy(harness.config_of("ffhq256_sg2ada"))
    config.pop("family")
    if family:
        config["family"] = family

    def built(*a, **k):
        raise AssertionError("the run went past the family's lookup")
    monkeypatch.setattr(datagen, "write_zip", built)
    with pytest.raises(FileNotFoundError,
                       match=f"gpubench/families/{family or '<family>'}.py"):
        harness.run(CELLS[0], 1, 0.1, False, device="cpu", config=config)


def _probe_losses(stats) -> Readings:
    probe = harness.Probe(None, 0.0, False, lambda: None)
    probe.keep_losses(stats)
    return probe.program


def test_loss_rows_pair_by_statistic_window_and_index():
    """A window of k = 4 batches under n_dis = 2 has four D rows and two G
    rows, the G rows on batches 0 and 2 (StepRunner.window); the reference
    lists them in another order and the gaps still pair row with row."""
    d, g = [1.0, 2.0, 3.0, 4.0], [10.0, 20.0]
    prog = _probe_losses([{"Loss/D/loss": torch.tensor(d),
                           "Loss/G/loss": torch.tensor(g)}])
    assert prog.losses == [
        ("Loss/D/loss", 0, 0, 1.0), ("Loss/G/loss", 0, 0, 10.0),
        ("Loss/D/loss", 0, 1, 2.0), ("Loss/D/loss", 0, 2, 3.0),
        ("Loss/G/loss", 0, 2, 20.0), ("Loss/D/loss", 0, 3, 4.0)]
    ref = Readings(losses=[("Loss/G/loss", 0, 2, 16.0),
                           ("Loss/G/loss", 0, 0, 8.0)] + [
        ("Loss/D/loss", 0, i, 2.0 * v) for i, v in enumerate(d)])
    assert harness._loss_gaps(prog, ref) == [0.25, 0.25, 0.5, 0.5, 0.5, 0.5]
    ref.losses[0] = ("Loss/G/loss", 0, 2, 20.0)
    ref.losses[1] = ("Loss/G/loss", 0, 0, 10.0)
    # the first batch's D and G loss of the window: indices 0
    assert harness.compare(prog, ref, {})["loss"] == 0.5
    # a row the other side lacks makes every gap infinite
    ref.losses.append(("Loss/G/loss", 0, 1, 5.0))
    assert harness._loss_gaps(prog, ref) == [float("inf")] * 7
    # the first window's G loss, after D's first Adam step, is left out; a
    # later window's is compared
    ref.losses[1:] = ref.losses[1:-1]
    ref.losses[1] = ("Loss/G/loss", 0, 0, 100.0)
    assert harness.compare(prog, ref, {})["loss"] == 0.5
    later = [(k, 1, i, v) for k, _, i, v in prog.losses]
    prog.losses += later
    ref.losses += [(k, w, i, 10 * v if k == "Loss/G/loss" else v)
                   for k, w, i, v in later]
    assert harness.compare(prog, ref, {})["loss"] == 0.9


def test_under_n_dis_1_the_rows_alternate_as_before():
    prog = _probe_losses([{"Loss/D/loss": torch.tensor([1.0, 2.0]),
                           "Loss/G/loss": torch.tensor([3.0, 4.0])}])
    assert [k[:3] for k in prog.losses] == [
        ("Loss/D/loss", 0, 0), ("Loss/G/loss", 0, 0),
        ("Loss/D/loss", 0, 1), ("Loss/G/loss", 0, 1)]


@pytest.mark.parametrize("traffic", ["noaug", "ada_p50"])
def test_a_traffic_without_a_pipe_draws_nothing_for_one(traffic):
    """With ``"augpipe": null`` the reference runs D on its input and
    leaves the training generator as it found it; with a pipe it draws."""
    config, _, _ = micro("ffhq256_sg2ada.ada_p50")
    follower = training.Follower(config, harness.traffic_of(traffic), 7, 7,
                                 torch.device("cpu"))
    img = torch.randn(4, 3, config["resolution"], config["resolution"])
    c = torch.zeros(4, 0)
    before = follower.gen.get_state()
    logits = follower.run_D(img, c)
    unchanged = torch.equal(before, follower.gen.get_state())
    assert unchanged == (traffic == "noaug")
    if traffic == "noaug":
        assert torch.equal(logits, follower.D(img, c))


def test_a_family_copied_under_another_name_runs_as_new_files_only(
        tmp_path):
    """A copy of gpubench/ in which families/stylegan2.py is copied to
    another family's name, a configuration names it, and the cell is a new
    limits file and new BENCHMARK.json entries: it resolves to the copy
    and its micro run is correct, with no file of the copy edited."""
    shutil.copytree(harness.BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("configs", "style_big_gan_tpu_torch"):
        os.symlink(os.path.join(harness.ROOT, name), tmp_path / name)
    bench = tmp_path / "gpubench"
    shutil.copy(bench / "families" / "stylegan2.py",
                bench / "families" / "twin.py")
    config = harness.config_of("sg2ada")
    config.update(name="twin_cifar", family="twin")
    (bench / "configs" / "twin_cifar.json").write_text(json.dumps(config))
    shutil.copy(bench / "limits" / "sg2ada.ada_p50.json",
                bench / "limits" / "twin_cifar.ada_p50.json")
    m = harness.manifest()
    m["configs"].append(dict(m["configs"][1], name="twin_cifar",
                             file="gpubench/configs/twin_cifar.json"))
    m["workloads"].append(dict(m["workloads"][1], name="twin_cifar.ada_p50",
                               config="twin_cifar"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    originals = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from gpubench import harness\n"
        "from gpubench.tests.micro import micro\n"
        "c, t, o = micro('twin_cifar.ada_p50')\n"
        "out = harness.run('twin_cifar.ada_p50', 2 ** 32 + 3, 0.1, False, "
        "device='cpu', config=c, traffic=t, extra_overrides=o, "
        "log=lambda s: None)\n"
        "print(json.dumps([harness.family(c).__file__, out['correct'], "
        "{k: v['value'] for k, v in out['checks'].items()}]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, p.stderr[-3000:]
    path, correct, checks = json.loads(p.stdout.strip().splitlines()[-1])
    assert path == str(bench / "families" / "twin.py")
    assert correct and set(checks) == {"loss", "grad1", "change", "r1_grad"}
    assert all(v == 0.0 for v in checks.values())
    assert {p: p.read_bytes() for p in originals} == originals


@pytest.mark.parametrize("seconds,first,want", [
    (40, 18.0, 2), (40, 15.0, 3), (5, 20.0, 1), (30, 20.0, 2),
    (30, 9.0, 3), (0.1, 1.0, 1)])
def test_whole_periods_nearest_the_seconds(seconds, first, want):
    assert harness.periods(seconds, first) == want


@pytest.mark.parametrize("seconds,first,want", [
    (10, 65.0, False), (10, 60.0, False), (10, 59.0, True), (10, 20.9, True),
    (10, 8.7, True), (0.1, 2.5, False)])
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
    # PPL's bfloat16 convolutions the reference differentiates twice in
    # float32 (reference/conv.py), the program in bfloat16: no bitwise
    # match is due there, only the limits that `correct` holds
    assert all(c["value"] == 0.0 for k, c in out["checks"].items()
               if not k.startswith("ppl_"))
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
