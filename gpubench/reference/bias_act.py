"""A frozen plain copy of style_big_gan_tpu_torch/ops/bias_act.py,
the benchmark's reference: the program may change, this copy does not.

Fused bias + activation + gain + clamp, plain PyTorch.

Counterpart of style_big_gan_tpu/ops/bias_act.py with the same semantics
table (per-activation default gain and alpha, clamp; reference:
bias_act.py:23-33, 93-123).  Elementwise, so autograd gives gradients of
any order.  Layout is NCHW, so the default bias dimension is 1.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


class ActivationSpec(NamedTuple):
    fn: Callable
    def_alpha: float
    def_gain: float
    has_2nd_grad: bool


activation_funcs = {
    "linear": ActivationSpec(lambda x, a: x, 0.0, 1.0, False),
    "relu": ActivationSpec(lambda x, a: F.relu(x), 0.0, math.sqrt(2.0),
                           False),
    "lrelu": ActivationSpec(lambda x, a: F.leaky_relu(x, a), 0.2,
                            math.sqrt(2.0), False),
    "tanh": ActivationSpec(lambda x, a: torch.tanh(x), 0.0, 1.0, True),
    "sigmoid": ActivationSpec(lambda x, a: torch.sigmoid(x), 0.0, 1.0, True),
    "elu": ActivationSpec(lambda x, a: F.elu(x), 0.0, 1.0, True),
    "selu": ActivationSpec(lambda x, a: F.selu(x), 0.0, 1.0, True),
    "softplus": ActivationSpec(lambda x, a: F.softplus(x), 0.0, 1.0, True),
    "swish": ActivationSpec(lambda x, a: F.silu(x), 0.0, math.sqrt(2.0),
                            True),
}


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = 1,
             act: str = "linear", alpha: Optional[float] = None,
             gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    """y = clamp(gain * act(x + broadcast(b, dim)), +-clamp).  ``clamp``
    None or < 0 disables clamping."""
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    clamp = float(clamp) if clamp is not None else -1.0
    if b is not None:
        if b.ndim != 1:
            raise ValueError("bias must be 1-D")
        shape = [1] * x.ndim
        shape[dim] = b.shape[0]
        x = x + b.reshape(shape).to(x.dtype)
    x = spec.fn(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp >= 0.0:
        x = x.clamp(-clamp, clamp)
    return x
