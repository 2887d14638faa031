"""What a family's reference and the harness's probe of the program
exchange: the readings each side produced (``Readings``), and a trainer's
state at a point of the run, from which the reference starts (``State``).
Neither knows a model: every family's reference fills and takes them."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch


@dataclass
class Readings:
    """What one side (the program or the reference) produced."""
    # (loss statistic, window, batch index in the window, value) of every
    # Dmain and Gmain phase
    losses: List[Tuple[str, int, int, float]] = field(default_factory=list)
    grad1: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # window -> module -> parameter -> norm of its change over the
    # window's Dmain and Gmain phases
    change: Dict[int, Dict[str, Dict[str, float]]] = field(
        default_factory=dict)
    # (phase, window, call in the window, penalty, parameter -> gradient
    # norm) of every Dreg and Greg call
    regs: List[Tuple[str, int, int, float, Dict[str, float]]] = field(
        default_factory=list)


@dataclass
class State:
    """A trainer's state at the start of a window or of a regularizer
    call (keyed ``("start", window)``, ``("Dreg", window, call)``,
    ``("Greg", window, call)``), on the host: each
    module's ``state_dict``, each optimizer's (first moment, second moment,
    step count) by parameter name, the training generator's state and
    PPL's running mean."""
    modules: Dict[str, Dict[str, torch.Tensor]]
    adam: Dict[str, Dict[str, Tuple[torch.Tensor, torch.Tensor, int]]]
    generator: torch.Tensor
    pl_mean: float
