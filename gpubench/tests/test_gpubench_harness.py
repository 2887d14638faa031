"""The harness on the CPU: the manifest and each configuration's family
resolve by name, the window and busy-time arithmetic, the pairing of loss
rows, the seeded data, the refusal without a card, and a whole run of each
cell at micro size, where the plain reference follows the program
bitwise but for the numbers its family declares (``NOT_BITWISE``), and
two twins of a cell that join a copy of gpubench/ as new files only."""

import copy
import json
import os
import re
import shutil
import subprocess
import sys
import zipfile

import pytest
import torch

from gpubench import datagen, faults, harness, run, trace
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
        # every regularizer of the configuration is one the family follows
        assert set(harness.config_of(c["name"])["regularizers"]) <= {
            name for name, *_ in fam.REGS.values()}
        assert all(isinstance(why, str) and why
                   for why in fam.NOT_BITWISE.values())
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


# The twins of sg2ada.ada_p50 that a copy of gpubench/ adds as new files
# and new BENCHMARK.json entries only, each a family of its name: "r1",
# families/stylegan2.py under another name on sg2ada's configuration and limits; "noreg", the same
# family with no lazy regularizer (``REGS = {}``), a configuration with
# ``regularizers: {}`` and R1 off in the recipe, and limits of its own.
TWINS = ("r1", "noreg")
# noreg's limits, from its own micro readings on the CPU (seeds 12345,
# 2**31 + 99, 2**32 + 17, 2**33 + 5), least of the four:
#            sound  control  unchanged  half_batch  altered
#   loss       0    1.74e-2  3.16e-2    5.30e-2     1.88e-3
#   grad1      0    0.354    inf        0.720       5.63e-2
#   change     0    2.31e-2  0.998      4.24e-2     8.74e-3
# so the control and each fault fail all three on every seed.
# sg2ada's limits (6e-3, 0.3, 0.09) pass ``altered`` at seed 12345 (5.45e-3,
# 0.140, 8.74e-3): there, only R1's numbers catch an altered G.
NOREG_LIMITS = {"loss": 1e-3, "grad1": 1e-2, "change": 1e-3}
# the copy's own per-cell tests, in groups that run apart; "faults" is
# every fault of ``faults.of`` the twin's configuration can have
GROUPS = {
    "names": ["test_gpubench_harness.py::test_every_name_resolves_to_its_file",
              "test_gpubench_spans.py::"
              "test_the_new_metrics_are_in_the_manifest_and_resolve",
              "test_gpubench_isolation.py::"
              "test_the_reference_loads_neither_jax_nor_the_program",
              "test_gpubench_control.py::"
              "test_the_control_is_not_correct[{cell}]"],
    "runs": ["test_gpubench_harness.py::"
             "test_a_micro_run_is_correct_and_the_reference_follows_it_bitwise"
             "[{cell}]",
             "test_gpubench_spans.py::"
             "test_a_traced_micro_run_holds_the_profiled_period[{cell}]"],
    "faults": ["test_gpubench_control.py::"
               "test_a_broken_program_is_not_correct", "-k", "{cell}"],
}


def _files(root) -> dict:
    return {p: p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def add_twin(root, kind: str, src: str = harness.ROOT):
    """Copies ``src``'s gpubench/ to ``root`` (with links to the program,
    the recipes and pytest.ini) and adds the ``kind`` twin of
    sg2ada.ada_p50 (``TWINS``) as new files: its family, configuration,
    limits and a reader of its own per-layer metric, and new entries of
    BENCHMARK.json.  Returns (the cell, its configuration, every file of
    the copy as it was before the twin came)."""
    bench = root / "gpubench"
    shutil.copytree(os.path.join(src, "gpubench"), bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("configs", "style_big_gan_tpu_torch", "pytest.ini"):
        os.symlink(os.path.join(src, name), root / name)
    before = _files(bench)
    name = f"{kind}_cifar"
    cell = f"{name}.ada_p50"
    module = (bench / "families" / "stylegan2.py").read_text()
    config = json.loads((bench / "configs" / "sg2ada.json").read_text())
    config.update(name=name, family=kind)
    limits = (bench / "limits" / "sg2ada.ada_p50.json").read_text()
    if kind == "noreg":
        module, n = re.subn(r"^REGS = \{.*?\}$", "REGS = {}", module,
                            flags=re.M | re.S)
        assert n == 1
        config["regularizers"] = {}
        config["overrides"] = config["overrides"] + ["gen.disc_regs=[]"]
        limits = json.dumps(NOREG_LIMITS)
    (bench / "families" / f"{kind}.py").write_text(module)
    (bench / "configs" / f"{name}.json").write_text(json.dumps(config))
    (bench / "limits" / f"{cell}.json").write_text(limits)
    metric = f"dispatch.window_ms.{name}"
    shutil.copy(bench / "metrics" / "dispatch.window_ms.py",
                bench / "metrics" / f"{metric}.py")
    m = harness.load_json(os.path.join(src, "BENCHMARK.json"))
    by_name = {e["name"]: e for k in ("configs", "workloads", "per_layer")
               for e in m[k]}
    m["configs"].append(dict(by_name["sg2ada"], name=name,
                             file=f"gpubench/configs/{name}.json"))
    m["workloads"].append(dict(by_name["sg2ada.ada_p50"], name=cell,
                               config=name))
    m["per_layer"].append(dict(by_name["dispatch.window_ms"], name=metric,
                               workloads=[cell]))
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return cell, config, before


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("kind", TWINS)
def test_a_family_copied_under_another_name_runs_as_new_files_only(
        kind, group, tmp_path):
    """A twin cell of another family (``TWINS``) passes the copy's own
    per-cell tests (``GROUPS``), with no file of the copy edited; its
    BENCHMARK.json is the checkout's with entries appended.  Those tests
    exist for the twin only in the copy, whose manifest alone has its
    cell."""
    cell, config, before = add_twin(tmp_path, kind)
    args = [a.format(cell=cell) for a in GROUPS[group]]
    want = sum("::" in a for a in args)
    if group == "faults":
        want = len([f for f in faults.FAULTS if faults.applies(f, config)]
                   + list(harness.family(harness.config_of("sg2ada"))
                          .FAULTS))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         *(f"gpubench/tests/{a}" if "::" in a else a for a in args)],
        cwd=tmp_path, capture_output=True, text=True, timeout=900,
        env={**env, "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, p.stdout[-4000:]
    counts = {k: int(n) for n, k in re.findall(
        r"(\d+) (passed|failed|skipped|errors?|xfailed|xpassed)",
        p.stdout.strip().splitlines()[-1])}
    assert counts == {"passed": want}, p.stdout[-2000:]
    assert _files(tmp_path / "gpubench").items() >= before.items()


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
    # a number the family declares not bitwise (with its reason) is held
    # only to the limits that `correct` holds
    not_bitwise = harness.family(config).NOT_BITWISE
    assert all(c["value"] == 0.0 for k, c in out["checks"].items()
               if k not in not_bitwise)
    rec = out["record"]
    assert rec.timed == 1 and rec.batches == traffic["period_batches"]
    assert out["attempted"] == rec.batches and out["failed"] == 0
    assert rec.profile is not None and rec.profile.host
    window = harness.metric_reader("dispatch.window_ms")(rec)
    assert window > 0
    regs = config["regularizers"]
    r1 = harness.metric_reader("regs.r1_ms")(rec)
    assert (r1 is None) == ("r1" not in regs)
    assert r1 is None or r1 > 0
    ppl = harness.metric_reader("regs.ppl_ms")(rec)
    assert (ppl is None) == ("ppl" not in regs)
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
