"""Micro sizes of the benchmark's cells for the CPU tests: the cell's own
configuration and traffic with every width, the resolution, the batch and
the data cut so a run and its reference take seconds on the CPU.  The
recipe is driven with the matching dotted overrides."""

from __future__ import annotations

import copy

from gpubench import harness

WIDTHS = {"z_dim": 32, "w_dim": 32}


def micro(workload: str):
    """(config, traffic, program overrides) of ``workload`` at micro size."""
    w = harness.workload(workload)
    config = copy.deepcopy(harness.config_of(w["config"]))
    traffic = copy.deepcopy(harness.traffic_of(w["traffic"]))
    res, batch = 16, 8
    base = 128
    gs = 4
    config.update(resolution=res, batch=batch,
                  batch_device=batch // (config["batch"] //
                                         config["batch_device"]))
    config["generator"].update(channel_base=base, **WIDTHS)
    config["discriminator"].update(channel_base=base)
    config["discriminator"]["epilogue_kwargs"]["mbstd_group_size"] = gs
    traffic["dataset_images"] = 16
    g = "gens_args.sg2_classic"
    d = "discs_args.sg2_classic"
    overrides = [f"gen.batch={batch}",
                 f"gen.batch_device={config['batch_device']}",
                 f"{g}.channel_base={base}", f"{d}.channel_base={base}",
                 f"{g}.z_dim={WIDTHS['z_dim']}",
                 f"{g}.w_dim={WIDTHS['w_dim']}",
                 f"{d}.epilogue_kwargs.mbstd_group_size={gs}",
                 "dataloaders_args.basic.num_workers=1"]
    return config, traffic, overrides
