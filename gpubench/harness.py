"""One run of one cell: the port's trainer on the cell's recipe, a timed
window of whole lazy-regularization periods, and the comparison with the
plain reference that decides ``correct``.

Everything a cell needs is found by name from ``BENCHMARK.json``:
``configs/<config>.json`` (the model, its recipe and its sizes),
``families/<family>.py`` for the config's ``"family"`` (its plain
reference, FLOP count, regularizer phases, own faults and micro sizes),
``traffic/<traffic>.json`` (the ADA mix, the data and the period),
``limits/<workload>.json`` (the limit of each compared number) and
``metrics/<name>.py`` (a per-layer reader: ``read(record)`` returns a number
or None).

The run, in order:

1. The data zip is written from the seed into a fresh directory under
   ``TMPDIR`` (datagen.py), and the trainer is built as
   ``style_big_gan_tpu_torch/starter.py::train`` builds it from the recipe
   YAML and its dotted overrides: the config's and the traffic's, then the
   harness's own (metrics off, a tick of one period, the seed).  Image
   grids and snapshots are switched off on the trainer object, which has
   no option for it.
2. Set-up is everything up to the end of the first tick: the imports, the
   data, the trainer's set-up and the first period, which runs window 1
   eagerly, captures window 2 into the CUDA graph, and runs the first R1
   and PPL.  Where that period took less than six times ``--seconds``,
   set-up runs one more period, whose length is then the pace (the first
   holds the eager window and the capture, and the one after it still
   runs slower and less steadily than the later ones).  ``setup_s`` is the
   process's start to the end of set-up.
3. The timed window is the next ``n`` whole ticks, ``n`` the whole number
   of periods at that pace nearest ``--seconds`` (at least one): every
   image of those periods over their seconds, every phase at its
   interval.  The trainer syncs the device at each tick; ``progress_fn``
   reads the clock there and ``abort_fn`` ends the loop after the last.
4. With ``trace`` one more period runs under ``torch.profiler``, after the
   window, for the device's busy time, the warp kernels and the breakdown.
5. During the first period the harness keeps what the program produced in
   its first three windows (the eager one, the captured one, the first
   replay): the D and G loss of each batch with the batch's index in its
   window (under ``n_dis`` > 1 a window has fewer G rows than D rows; the
   comparison pairs rows by statistic, window and index), the first
   gradient each optimizer received (read from Adam's first moment), the
   change of every parameter of G, D and G_ema over each window's Dmain and
   Gmain phases, each R1 and PPL call's penalty and the gradient it gave
   its optimizer, and the program's whole state at the start of the second
   and the third window and just before each R1 and PPL call (weights,
   buffers, Adam's moments and counts, the generator's state, PPL's mean;
   on the host).
   After the trainer has ended and its memory is freed, the plain
   reference computes the first window from the seed, each later one and
   each regularizer call from the program's state at its start (the
   family's ``follow``), and the gaps are compared with the limits
   (``compare``).  Besides the public hooks this reaches into the
   trainer's ``_run_window``, ``_pending_stats``, ``steps`` and optimizer
   state (PERF.md, section 7).
"""

from __future__ import annotations

import functools
import gc
import importlib.util
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FOLLOWED_WINDOWS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "style_big_gan_tpu")
PEAKS_FILE = os.path.join(BENCH, "peaks.json")
# the trainer's step of each lazy regularizer phase a family may follow
REG_STEPS = {"Dreg": "d_reg_step", "Greg": "g_reg_step"}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(name: str) -> dict:
    for w in manifest()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(name: str) -> dict:
    return load_json(os.path.join(BENCH, "configs", f"{name}.json"))


def traffic_of(name: str) -> dict:
    return load_json(os.path.join(BENCH, "traffic", f"{name}.json"))


def limits_of(name: str) -> dict:
    return load_json(os.path.join(BENCH, "limits", f"{name}.json"))


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    return _load(os.path.join(BENCH, "metrics", f"{name}.py"),
                 "gpubench_metric_" + name.replace(".", "_")).read


def family(config: dict):
    """``families/<family>.py`` of a configuration, by its ``"family"``
    (families/stylegan2.py says what such a module gives), loaded once a
    process; raises FileNotFoundError, naming the file, where the
    configuration names no family or no such file exists."""
    name = config.get("family")
    path = os.path.join(BENCH, "families", f"{name or '<family>'}.py")
    if not name or not os.path.isfile(path):
        raise FileNotFoundError(
            f"configuration {config.get('name')!r} names "
            f"{'family ' + repr(name) if name else 'no family'}: no file "
            f"{os.path.relpath(path, ROOT)}")
    return _family_at(path, name)


@functools.lru_cache(maxsize=None)
def _family_at(path: str, name: str):
    return _load(path, "gpubench_family_" + name.replace(".", "_"))


def periods(seconds: float, first_period_s: float) -> int:
    """Whole periods nearest ``seconds`` at the first period's pace, at
    least one."""
    return max(1, int(math.floor(seconds / max(first_period_s, 1e-9) + 0.5)))


def second_period(seconds: float, first_period_s: float) -> bool:
    """Whether set-up runs a second period for the pace: where the first,
    which holds the eager window and the capture, took less than six times
    ``seconds``.  The period right after the first is not yet steady (at
    ffhq256 it read 113.1-118.7 imgs/s, the one after 118.9-119.5; PERF.md,
    section 2); a first period of six times ``seconds`` or more belongs to a
    recipe whose periods are too long for a run to afford one more."""
    return first_period_s < 6 * seconds


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: the port's name begins with the latter)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


# ------------------------------------------------------------------ record

@dataclass
class Tick:
    t: float
    phase_seconds: Dict[str, float]
    phase_counts: Dict[str, int]
    windows: int
    waits: int
    batches: int
    finite: bool


@dataclass
class Record:
    """What a run measured; the per-layer readers take it."""
    config: dict
    traffic: dict
    device_kind: str
    ticks: List[Tick] = field(default_factory=list)
    start: int = 0
    timed: int = 0
    window_seconds: List[float] = field(default_factory=list)
    data_waits: List[float] = field(default_factory=list)
    profile: Optional[object] = None
    peaks: Optional[Dict[str, float]] = None

    def span(self):
        """(first, last) tick of the timed window."""
        return self.ticks[self.start], self.ticks[self.start + self.timed]

    @property
    def seconds(self) -> float:
        a, b = self.span()
        return b.t - a.t

    @property
    def batches(self) -> int:
        a, b = self.span()
        return b.batches - a.batches

    def delta(self, what: str, phase: str) -> float:
        a, b = self.span()
        return getattr(b, what).get(phase, 0) - getattr(a, what).get(phase, 0)


# ----------------------------------------------------------------- probe

class Probe:
    """The harness's hooks on one trainer (module docstring, 2-5)."""

    def __init__(self, trainer, seconds: float, trace: bool, sync,
                 timed: Optional[int] = None, regs: Optional[dict] = None):
        from gpubench.reference.state import Readings
        self.tr, self.seconds, self.trace, self.sync = \
            trainer, seconds, trace, sync
        self.regs = regs or {}   # the family's REGS
        self.ticks: List[Tick] = []
        self.start = 0
        self.timed: Optional[int] = None
        self.fixed_timed = timed
        self.loop_t0 = 0.0
        self.calls = 0
        self.program = Readings()
        self._p0 = None
        self.states = {}
        self.prof = None
        self.prof_t0 = 0.0
        self.profile = None
        self.window_log: List[float] = []
        self.wait_log: List[float] = []

    def install(self) -> None:
        tr = self.tr
        tr.progress_fn = self.on_tick
        tr.abort_fn = self.done
        tr.export_sample_images = lambda *a, **k: None
        tr.save_snapshot = lambda *a, **k: None
        loop, window = tr.training_loop, tr._run_window

        def training_loop():
            self.on_loop_start()
            return loop()

        def run_window(*args):
            self.before_window()
            first = len(tr._pending_stats)
            out = window(*args)
            if self.calls < FOLLOWED_WINDOWS:
                self.keep_losses(tr._pending_stats[first:])
            self.calls += 1
            return out
        tr.training_loop = training_loop
        tr._run_window = run_window

    # -- what the program produced
    def on_loop_start(self) -> None:
        self.loop_t0 = time.time()
        for key, opt, module in (("D", self.tr.opt_d, self.tr.D),
                                 ("G", self.tr.opt_g, self.tr.G)):
            self._first_step_hook(key, opt, module)
        steps = self.tr.steps
        for phase in self.regs:
            name = REG_STEPS[phase]
            setattr(steps, name, self._reg_call(phase, getattr(steps, name)))

    def _reg_call(self, phase: str, step):
        """``step`` (the trainer's R1 or PPL call) that, in a followed
        window, keeps the program's state before it, its penalty and the
        gradient each parameter gave the optimizer (from Adam's first
        moment before and after: g = (m1 - beta1 m0) / (1 - beta1))."""
        import torch
        _, stat, opt_name, mod_name = self.regs[phase]
        calls: Dict[int, int] = {}

        def call(*args):
            w = self.calls
            if w >= FOLLOWED_WINDOWS:
                return step(*args)
            self.sync()
            self._close_change(w)
            i = calls[w] = calls.get(w, -1) + 1
            before = self.states[(phase, w, i)] = self.state()
            out = step(*args)
            opt = getattr(self.tr, opt_name)
            names = {id(p): n for n, p in
                     getattr(self.tr, mod_name).named_parameters()}
            norms = {}
            for g in opt.param_groups:
                b1 = float(g["betas"][0])
                for p in g["params"]:
                    n = names[id(p)]
                    m0 = before.adam[mod_name][n][0].to(p.device)
                    m1 = opt.state.get(p, {}).get("exp_avg")
                    norms[n] = torch.zeros((), device=p.device) \
                        if m1 is None else ((m1 - b1 * m0) / (1.0 - b1)).norm()
            norms = dict(zip(norms, torch.stack(list(norms.values()))
                             .cpu().tolist()))
            self.program.regs.append((phase, w, i, float(out[stat]), norms))
            return out
        return call

    def _first_step_hook(self, key, opt, module) -> None:
        import torch
        names = {id(p): n for n, p in module.named_parameters()}
        handle = None

        def hook(o, *_):
            handle.remove()
            params = [p for g in o.param_groups for p in g["params"]]
            norms = torch.stack([o.state[p]["exp_avg"].norm()
                                 for p in params]).cpu().tolist()
            self.program.grad1[key] = {names[id(p)]: v
                                       for p, v in zip(params, norms)}
        handle = opt.register_step_post_hook(hook)

    def _modules(self):
        return {"G": self.tr.G, "D": self.tr.D, "G_ema": self.tr.G_ema}

    def before_window(self) -> None:
        w = self.calls
        if w > FOLLOWED_WINDOWS:
            return
        self.sync()
        if w:
            self._close_change(w - 1)
        if w < FOLLOWED_WINDOWS:
            self._p0 = {k: {n: p.detach().to("cpu", copy=True)
                            for n, p in m.named_parameters()}
                        for k, m in self._modules().items()}
        if 0 < w < FOLLOWED_WINDOWS:
            self.states[("start", w)] = self.state()

    def _close_change(self, w: int) -> None:
        """The change of every parameter over window ``w``'s Dmain and
        Gmain phases: from its start to its first regularizer call, or to
        its end where none falls due."""
        if self._p0 is None:
            return
        self.program.change[w] = {
            k: {n: float((p.detach().cpu() - self._p0[k][n]).norm())
                for n, p in m.named_parameters()}
            for k, m in self._modules().items()}
        self._p0 = None

    def state(self):
        """The program's state at the start of a window, on the host."""
        import torch
        from gpubench.reference.state import State
        tr = self.tr
        adam = {}
        for key, opt, module in (("G", tr.opt_g, tr.G), ("D", tr.opt_d, tr.D)):
            names = {id(p): n for n, p in module.named_parameters()}
            adam[key] = {}
            for p in (p for g in opt.param_groups for p in g["params"]):
                st = opt.state.get(p, {})     # empty before a first step
                zero = torch.zeros(p.shape)
                adam[key][names[id(p)]] = (
                    st["exp_avg"].to("cpu", copy=True) if st else zero,
                    st["exp_avg_sq"].to("cpu", copy=True) if st else zero,
                    int(st["step"]) if st else 0)
        return State(
            modules={k: {n: t.detach().to("cpu", copy=True)
                         for n, t in m.state_dict().items()}
                     for k, m in self._modules().items()},
            adam=adam, generator=tr.torch_gen.get_state(),
            pl_mean=float(tr.state.reg_state.get("pl_mean", 0.0)))

    def keep_losses(self, stats_list) -> None:
        """Each D and G loss row of a window with its batch's index in the
        window: D's k rows are batches 0..k-1; G's k / n_dis rows are the
        first batch of each critic window of n_dis batches
        (``StepRunner.window``), n_dis read from the rows' counts."""
        w = self.calls
        for st in stats_list:
            if "Loss/D/loss" in st:        # a window: D and G interleaved
                d = st["Loss/D/loss"].float().cpu().tolist()
                g = st["Loss/G/loss"].float().cpu().tolist()
                n_dis = len(d) // max(len(g), 1)
                for i, dv in enumerate(d):
                    self.program.losses.append(("Loss/D/loss", w, i, dv))
                    if i % n_dis == 0 and i // n_dis < len(g):
                        self.program.losses.append(
                            ("Loss/G/loss", w, i, g[i // n_dis]))

    # -- ticks and the window
    def on_tick(self, *_):
        tr = self.tr
        t = time.time()
        col = tr.collector
        finite = all(math.isfinite(col.mean(k)) for k in
                     ("Loss/D/loss", "Loss/G/loss") if k in col.names())
        self.window_log = list(tr.window_seconds)
        self.wait_log = [w for w, _ in tr.data_wait_log]
        self.ticks.append(Tick(t, dict(tr.phase_seconds),
                               dict(tr.phase_counts), len(tr.window_seconds),
                               len(tr.data_wait_log), tr.batches_done,
                               finite))
        i = len(self.ticks) - 1
        if self.timed is None:
            pace = t - (self.ticks[-2].t if i else self.loop_t0)
            if self.fixed_timed is not None:
                self.timed = self.fixed_timed
            elif i or not second_period(self.seconds, pace):
                self.start, self.timed = i, periods(self.seconds, pace)
        end = self.start + (self.timed or 0)
        if self.trace and self.timed is not None and i == end:
            self._start_profile()
        if self.trace and self.timed is not None and i == end + 1:
            self._stop_profile()

    def done(self) -> bool:
        extra = 1 if self.trace else 0
        return self.timed is not None and \
            len(self.ticks) >= 1 + self.start + self.timed + extra

    def _start_profile(self) -> None:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.tr.args.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.prof_t0 = time.time()

    def _stop_profile(self) -> None:
        from gpubench import trace
        self.sync()
        wall = time.time() - self.prof_t0
        self.prof.stop()
        batches = self.ticks[-1].batches - self.ticks[-2].batches
        self.profile = trace.from_profiler(self.prof, wall, batches)
        self.prof = None


# ------------------------------------------------------------ comparison

def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """Worst leaf of |norm_prog - norm_ref| / max(norm_ref of the leaf,
    the median leaf's norm_ref)."""
    if set(prog) != set(ref) or not ref:
        return math.inf
    med = statistics.median(ref.values())
    worst = 0.0
    for n, r in ref.items():
        p = prog[n]
        if not (math.isfinite(p) and math.isfinite(r)):
            return math.inf
        worst = max(worst, abs(p - r) / max(r, med, 1e-30))
    return worst


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float]) -> list:
    """[name, gap, reference norm] of the leaf that sets ``_leaf_gap``."""
    if set(prog) != set(ref) or not ref:
        return []
    med = statistics.median(ref.values())
    return max(([n, abs(prog[n] - r) / max(r, med, 1e-30), r]
                for n, r in ref.items()), key=lambda x: x[1])


def _loss_gaps(prog, ref) -> List[float]:
    """Relative gap of each loss statistic of the reference, in its order,
    to the program's of the same statistic, window and batch index; inf
    where the two sides ran other phases."""
    mine = {k[:3]: k[3] for k in prog.losses}
    if len(mine) != len(prog.losses) or \
            set(mine) != {k[:3] for k in ref.losses}:
        return [math.inf] * max(1, len(ref.losses))
    gaps = []
    for *key, r in ref.losses:
        p = mine[tuple(key)]
        gaps.append(abs(p - r) / max(abs(r), 1e-30) if math.isfinite(p)
                    else math.inf)
    return gaps


def _change_gap(prog, ref, window: int, median: bool = False) -> float:
    """The worst (or median) leaf's gap of the parameters' change over
    ``window``, G's, D's and G_ema's leaves, against the larger of the
    leaf's and the median leaf's reference change, leaving out a leaf whose
    first gradient in the reference is under a thousandth of the median
    leaf's (nought to rounding, so Adam moves it by round-off alone)."""
    if window not in ref.change:
        return math.inf
    gaps = []
    for k, ref_change in ref.change[window].items():
        g = ref.grad1["D" if k == "D" else "G"]
        floor = 1e-3 * statistics.median(g.values())
        prog_change = prog.change.get(window, {}).get(k, {})
        if set(prog_change) != set(ref_change):
            return math.inf
        med = statistics.median(ref_change.values())
        for n, r in ref_change.items():
            if g[n] < floor:
                continue
            p = prog_change[n]
            gaps.append(abs(p - r) / max(r, med, 1e-30)
                        if math.isfinite(p) else math.inf)
    if not gaps:
        return math.inf
    return statistics.median(gaps) if median else max(gaps)


def _reg_gaps(prog, ref, regs: dict) -> Dict[str, float]:
    """Per regularizer of the family's ``regs`` (``r1``, ``ppl``): the
    largest relative gap of a call's penalty, ``<reg>_penalty``, and the
    worst leaf's gap of the gradient a call gave its optimizer,
    ``<reg>_grad`` (``_leaf_gap``), over its calls in the followed windows;
    inf where the two sides made other calls."""
    out: Dict[str, float] = {}
    for phase, (name, *_) in regs.items():
        r = [c for c in ref.regs if c[0] == phase]
        if not r:
            continue
        p = [c for c in prog.regs if c[0] == phase]
        if [c[:3] for c in p] != [c[:3] for c in r]:
            out[f"{name}_penalty"] = out[f"{name}_grad"] = math.inf
            continue
        out[f"{name}_penalty"] = max(
            abs(a[3] - b[3]) / max(abs(b[3]), 1e-30)
            if math.isfinite(a[3]) else math.inf for a, b in zip(p, r))
        out[f"{name}_grad"] = max(_leaf_gap(a[4], b[4])
                                  for a, b in zip(p, r))
    return out


def compare(prog, ref, regs: dict) -> Dict[str, float]:
    """The compared numbers (PERF.md, section 2), over the followed
    windows, each computed by the reference from the program's state at
    its start (the first from the seed):

    * ``loss``: the largest relative gap of the first batch's D and G loss
      in any window (later batches' losses carry the previous batches'
      round-off, which training multiplies about tenfold a batch), but the
      first window's G loss: it follows D's first Adam step, which moves
      each leaf by about the sign of its gradient, so round-off flips the
      step of a leaf whose gradient is near nought and the gap swings
      between seeds from 1e-5 to 1e-2 (PERF.md, section 2);
    * ``grad1``: the worst leaf's gap of the first gradient's norm, D's and
      G's leaves, against the larger of the leaf's and the median leaf's
      reference norm;
    * ``change``: the median leaf's gap, in the same measure, of the norm
      of the parameters' change over a window's Dmain and Gmain phases, in
      any window (``_change_gap``); the worst leaf's is one small leaf's
      noise (PERF.md, section 2);
    * ``r1_penalty``, ``r1_grad``, ``ppl_penalty``, ``ppl_grad``: each
      regularizer call's penalty and gradient, from the program's state
      just before it (``_reg_gaps``), where the configuration has it;
      ``regs`` is the family's ``REGS``.
    """
    gaps = _loss_gaps(prog, ref)
    firsts = [g for g, (k, w, i, _) in zip(gaps, ref.losses)
              if i == 0 and (w, k) != (0, "Loss/G/loss")] \
        if len(gaps) == len(ref.losses) else []
    return {
        "loss": max(firsts or gaps),
        "grad1": max((_leaf_gap(prog.grad1.get(k, {}), ref.grad1[k])
                      for k in ref.grad1), default=math.inf),
        "change": max((_change_gap(prog, ref, w, median=True)
                       for w in range(FOLLOWED_WINDOWS)), default=math.inf),
        **_reg_gaps(prog, ref, regs),
    }


def detail(prog, ref) -> Dict[str, object]:
    """Every gap by window, for choosing the compared numbers: the largest
    loss gap of each window, the loss gap of each phase, the worst and
    median leaf's change gap of each window, each regularizer call's gaps
    with the reference's penalty, and the leaf that sets ``grad1``."""
    gaps = _loss_gaps(prog, ref)
    out: Dict[str, object] = {}
    if len(gaps) == len(ref.losses):
        for w in sorted({w for _, w, _, _ in ref.losses}):
            out[f"loss_w{w}"] = max(g for g, (_, v, _, _) in
                                    zip(gaps, ref.losses) if v == w)
        out["losses_by_phase"] = [[k, w, g] for g, (k, w, _, _) in
                                  zip(gaps, ref.losses)]
    for w in sorted(ref.change):
        out[f"change_w{w}"] = _change_gap(prog, ref, w)
        out[f"change_median_w{w}"] = _change_gap(prog, ref, w, median=True)
    if [c[:3] for c in prog.regs] == [c[:3] for c in ref.regs]:
        out["regs_by_call"] = [
            [a[0], a[1], a[2], abs(a[3] - b[3]) / max(abs(b[3]), 1e-30),
             _leaf_gap(a[4], b[4]), b[3]]
            for a, b in zip(prog.regs, ref.regs)]
    out["grad1_worst"] = {
        k: _worst_leaf(prog.grad1.get(k, {}), g) for k, g in ref.grad1.items()}
    out["left_out"] = {
        k: sorted(n for n, v in g.items()
                  if v < 1e-3 * statistics.median(g.values()))
        for k, g in ref.grad1.items()}
    return out


# ------------------------------------------------------------------- run

def seeds(seed: int):
    """(the program's gen.seed, the data's seed)."""
    return int(seed) % (2 ** 31), int(seed)


def program_argv(config: dict, traffic: dict, zip_path: str, out_dir: str,
                 seed: int, device: str, extra=()) -> List[str]:
    period_kimg = int(traffic["period_batches"]) * int(config["batch"]) / 1000
    return [f"exp.config_dir={os.path.join(ROOT, 'configs')}",
            f"exp.config={os.path.basename(config['recipe'])}",
            "exp.name=gpubench", f"data.dataset_path={zip_path}",
            f"log.output={out_dir}", "log.metrics=[]",
            f"log.kimg_per_tick={period_kimg}", "gen.kimg=1000000",
            f"gen.seed={seed}", f"perf.device={device}",
            *config["overrides"], *traffic["overrides"], *extra]


def run(workload_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", config: Optional[dict] = None,
        traffic: Optional[dict] = None, limits: Optional[dict] = None,
        extra_overrides=(), log=print, timed: Optional[int] = None
        ) -> dict:
    """One run of a cell; returns the result's fields (and ``checks``).
    ``config``, ``traffic`` and ``limits`` replace the cell's files (the
    tests' micro sizes); ``device`` "cpu" runs it on the CPU (tests
    only); ``timed`` fixes the number of timed periods (0: the comparison
    alone, for readings.py).  The configuration's family is found before
    anything is built."""
    w = workload(workload_name)
    config = config or config_of(w["config"])
    traffic = traffic or traffic_of(w["traffic"])
    fam = family(config)
    import torch
    from gpubench import datagen

    prog_seed, data_seed = seeds(seed)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="gpubench-", dir=os.environ.get("TMPDIR"))
    try:
        zip_path = os.path.join(tmp, "data.zip")
        n = int(traffic["dataset_images"])
        datagen.write_zip(
            zip_path, datagen.images(data_seed, n, int(config["resolution"])),
            datagen.labels(data_seed, n, int(config["label_dim"])))
        from style_big_gan_tpu_torch import registries
        from style_big_gan_tpu_torch.arguments import load_config
        cfg = load_config(program_argv(config, traffic, zip_path,
                                       os.path.join(tmp, "runs"), prog_seed,
                                       device, extra_overrides))
        registries._import_all()
        trainer = registries.trainers[str(cfg.exp.trainer)]()
        probe = Probe(trainer, seconds, trace, sync, timed, fam.REGS)
        probe.install()
        trainer.run(cfg)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        rec = Record(config=config, traffic=traffic, device_kind=kind,
                     ticks=probe.ticks, start=probe.start,
                     timed=probe.timed,
                     profile=probe.profile, peaks=peaks_for(kind))
        first, last = rec.span()
        rec.window_seconds = probe.window_log[first.windows:last.windows]
        rec.data_waits = probe.wait_log[first.waits:last.waits]
        program, states = probe.program, probe.states
        loop_start = probe.loop_t0
        del trainer, probe
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.time()
        ref = fam.follow(config, traffic, prog_seed, data_seed,
                         FOLLOWED_WINDOWS, device, states=states)
        log(f"[gpubench] reference: {time.time() - t_ref:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers = compare(program, ref, fam.REGS)
    limits = limits if limits is not None else limits_of(workload_name)
    # a number its limits file leaves out has no upper reading in that
    # cell and is not compared there (PERF.md, section 2)
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in numbers.items() if k in limits}
    timed_ticks = rec.ticks[rec.start + 1:rec.start + rec.timed + 1]
    per_tick = int(traffic["period_batches"])
    return dict(record=rec, peak=peak, kind=kind, checks=checks,
                detail=detail(program, ref), loop_start=loop_start,
                correct=all(c["value"] <= c["limit"]
                            for c in checks.values()),
                attempted=rec.batches,
                failed=sum(per_tick for t in timed_ticks if not t.finite),
                images=rec.batches * int(config["batch"]))


def peaks_for(kind: str) -> Optional[Dict[str, float]]:
    """The card's data-sheet peaks by precision (peaks.json), by the first
    entry whose key is in the card's name."""
    for key, peaks in load_json(PEAKS_FILE)["cards"].items():
        if key in kind:
            return {k: float(v) for k, v in peaks.items()}
    return None
