"""The StyleGAN2(-ADA) family: what the harness needs of a configuration
whose ``"family"`` is ``"stylegan2"``.  The harness loads this file by that
name (``harness.family``); a new family is a new file here that gives the
same names:

* ``follow(config, traffic, seed, data_seed, windows, device, states=None,
  lower=False, keep=None)``: the plain reference's ``Readings`` of the first
  ``windows`` windows (reference/training.py);
* ``period_flops(config, batches)``: (FLOPs by precision of ``batches``
  batches with every phase at its interval, FLOPs by phase), which
  ``step.mfu`` reads (flops/stylegan2.py);
* ``REGS``: the lazy regularizer phases it follows, each with its name
  among the compared numbers, its penalty statistic, and the trainer's
  optimizer and module it steps (empty for a family with none);
* ``NOT_BITWISE``: the compared numbers its micro run does not match
  bitwise, each with its reason; the CPU tests hold every other compared
  number to 0.0 there;
* ``FAULTS``: the faults particular to its model, by name (faults.py has
  those of every family);
* ``micro(config, traffic)``: (config, traffic, program overrides) at the
  CPU tests' micro size, every width, the resolution, the batch and the data
  cut so a run and its reference take seconds on the CPU.
"""

from __future__ import annotations

from gpubench.flops.stylegan2 import period_flops  # noqa: F401
from gpubench.reference.training import follow  # noqa: F401

REGS = {"Dreg": ("r1", "Loss/r1_penalty", "opt_d", "D"),
        "Greg": ("ppl", "Loss/pl_penalty", "opt_g", "G")}

_PPL_ROUNDING = ("PPL's bfloat16 convolutions: the reference differentiates "
                 "them twice in float32 on their bfloat16 operands "
                 "(reference/conv.py), the program in bfloat16")
NOT_BITWISE = {"ppl_penalty": _PPL_ROUNDING, "ppl_grad": _PPL_ROUNDING}


def altered(monkeypatch):
    """An answer altered where it is produced: G's images off by 1 %."""
    from style_big_gan_tpu_torch.models import stylegan2 as port_sg2
    orig = port_sg2.SynthesisNetwork.forward

    def forward(self, *a, **k):
        return orig(self, *a, **k) * 1.01
    monkeypatch.setattr(port_sg2.SynthesisNetwork, "forward", forward)


FAULTS = {"altered": altered}

MICRO_WIDTHS = {"z_dim": 32, "w_dim": 32}


def micro(config: dict, traffic: dict):
    """(config, traffic, program overrides) at micro size; the recipe is
    driven with the dotted overrides that match the cut."""
    res, batch = 16, 8
    base = 128
    gs = 4
    config.update(resolution=res, batch=batch,
                  batch_device=batch // (config["batch"] //
                                         config["batch_device"]))
    config["generator"].update(channel_base=base, **MICRO_WIDTHS)
    config["discriminator"].update(channel_base=base)
    config["discriminator"]["epilogue_kwargs"]["mbstd_group_size"] = gs
    traffic["dataset_images"] = 16
    g = "gens_args.sg2_classic"
    d = "discs_args.sg2_classic"
    overrides = [f"gen.batch={batch}",
                 f"gen.batch_device={config['batch_device']}",
                 f"{g}.channel_base={base}", f"{d}.channel_base={base}",
                 f"{g}.z_dim={MICRO_WIDTHS['z_dim']}",
                 f"{g}.w_dim={MICRO_WIDTHS['w_dim']}",
                 f"{d}.epilogue_kwargs.mbstd_group_size={gs}",
                 "dataloaders_args.basic.num_workers=1"]
    return config, traffic, overrides
