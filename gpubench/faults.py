"""Faults planted in the program underneath a run: each comparison has to
come out as not correct with one of them in place.  Each fault is a
function of a ``pytest.MonkeyPatch``, which takes it out again on
``undo()``.  The faults here reach the trainer's shared code, so every
family can have them; a family's own (an answer altered inside its model)
are its module's ``FAULTS`` (families/<family>.py).  ``of(config)`` gives
both.  The CPU tests plant them at micro size
(tests/test_gpubench_control.py); ``readings.py --fault`` plants them at
the cell's own size on the card.  The exchange between chips has no fault
here: every cell runs on one card."""

from gpubench import harness
from style_big_gan_tpu_torch.train import loss_arch, regularizers, steps


def unchanged(monkeypatch):
    """A step that returns its state unchanged: no optimizer step."""
    def update(self, module, opt):
        for p in module.parameters():
            p.grad = None
    monkeypatch.setattr(steps.StepRunner, "_update", update)


def half_batch(monkeypatch):
    """Half of the batch left out of D's loss, the mean over the rest."""
    orig = loss_arch.LossArchBase._d_loss

    def d_loss(self, real_logits, gen_logits):
        h = real_logits.shape[0] // 2
        return orig(self, real_logits[:h], gen_logits[:h])
    monkeypatch.setattr(loss_arch.LossArchBase, "_d_loss", d_loss)


def r1_weight(monkeypatch):
    """R1 at half its weight (gamma / 2)."""
    orig = regularizers.R1Reg.__init__

    def init(self, r1_gamma: float = 10.0):
        orig(self, r1_gamma / 2)
    monkeypatch.setattr(regularizers.R1Reg, "__init__", init)


def ppl_weight(monkeypatch):
    """PPL at half its weight."""
    orig = regularizers.PPLReg.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        self.pl_weight /= 2
    monkeypatch.setattr(regularizers.PPLReg, "__init__", init)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "r1_weight": r1_weight, "ppl_weight": ppl_weight}
# the regularizer a fault needs in the configuration, where it needs one
NEEDS = {"r1_weight": "r1", "ppl_weight": "ppl"}


def applies(fault: str, config: dict) -> bool:
    need = NEEDS.get(fault)
    return need is None or need in config["regularizers"]


def of(config: dict) -> dict:
    """Every fault a cell of ``config`` can have, by name: those of this
    file that apply to it, then its family's own."""
    return {**{n: f for n, f in FAULTS.items() if applies(n, config)},
            **harness.family(config).FAULTS}
