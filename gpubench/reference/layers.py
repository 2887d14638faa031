"""A frozen plain copy of style_big_gan_tpu_torch/models/layers.py,
the benchmark's reference: the program may change, this copy does not.

Equalized-LR layers of the StyleGAN2 family as ``nn.Module``s (NCHW).

Counterparts of style_big_gan_tpu/models/layers.py.  Parameters are named
and shaped as in the original PyTorch reference (linear [out, in], conv
[O, I, kh, kw]), so weights.py converts the JAX variable trees with a plain
transpose-and-rename.  Parameters live in float32; a layer computes in the
dtype of the activation it is given (its block casts it first).  In the
control (precision.py) the linear's and the convolution's operands are
rounded one precision step down.  One process: no tensor or data
parallelism.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from gpubench.reference.bias_act import activation_funcs, bias_act
from gpubench.reference.conv2d_resample import conv2d_resample
from gpubench.reference.precision import rounded
from gpubench.reference.upfirdn2d import setup_filter


def normalize_2nd_moment(x: torch.Tensor, dim: int = 1,
                         eps: float = 1e-8) -> torch.Tensor:
    """x * rsqrt(E[x^2]) (reference: generators.py:36-39)."""
    return x * (x.square().mean(dim=dim, keepdim=True) + eps).rsqrt()


class FullyConnectedLayer(nn.Module):
    """Equalized-LR linear + bias_act (reference: generators.py:105-134)."""

    def __init__(self, in_features: int, out_features: int,
                 activation: str = "linear", use_bias: bool = True,
                 lr_multiplier: float = 1.0, bias_init: float = 0.0):
        super().__init__()
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight = nn.Parameter(
            torch.randn(out_features, in_features) / lr_multiplier)
        self.bias = nn.Parameter(torch.full((out_features,),
                                            float(bias_init))) \
            if use_bias else None
        self.weight_gain = lr_multiplier / np.sqrt(in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.weight * self.weight_gain).to(x.dtype)
        b = self.bias * self.lr_multiplier if self.bias is not None else None
        y = rounded(x) @ rounded(w).t()
        return bias_act(y, b, act=self.activation)


class Conv2dLayer(nn.Module):
    """Equalized-LR conv with up/down resampling and bias_act
    (reference: generators.py:139-185)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, activation: str = "linear",
                 up: int = 1, down: int = 1, use_bias: bool = True,
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None,
                 trainable: bool = True):
        super().__init__()
        self.activation = activation
        self.up, self.down = up, down
        self.conv_clamp = conv_clamp
        self.padding = kernel_size // 2
        self.weight_gain = 1.0 / np.sqrt(in_channels * kernel_size ** 2)
        self.register_buffer(
            "resample_filter",
            setup_filter(list(resample_filter)) if (up > 1 or down > 1)
            else None, persistent=False)
        self.weight = nn.Parameter(
            torch.randn(out_channels, in_channels, kernel_size, kernel_size),
            requires_grad=trainable)
        self.bias = nn.Parameter(torch.zeros(out_channels),
                                 requires_grad=trainable) \
            if use_bias else None

    def forward(self, x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        w = (self.weight * self.weight_gain).to(x.dtype)
        y = conv2d_resample(x, w, f=self.resample_filter, up=self.up,
                            down=self.down, padding=self.padding,
                            flip_weight=(self.up == 1))
        clamp = self.conv_clamp * gain if self.conv_clamp is not None \
            else None
        act_gain = activation_funcs[self.activation].def_gain * gain
        return bias_act(y, self.bias, act=self.activation, gain=act_gain,
                        clamp=clamp)


class MappingNetwork(nn.Module):
    """z -> w with class conditioning, w_avg tracking and truncation
    (reference: generators.py:190-269)."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int,
                 num_ws: Optional[int], num_layers: int = 8,
                 embed_features: Optional[int] = None,
                 layer_features: Optional[int] = None,
                 activation: str = "lrelu", lr_multiplier: float = 0.01,
                 w_avg_beta: float = 0.995):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim = z_dim, c_dim, w_dim
        self.num_ws = num_ws
        self.num_layers = num_layers
        self.w_avg_beta = w_avg_beta
        if embed_features is None:
            embed_features = w_dim
        if c_dim == 0:
            embed_features = 0
        layer_features = layer_features or w_dim
        if c_dim > 0:
            self.embed = FullyConnectedLayer(c_dim, embed_features)
        features = z_dim + embed_features
        for idx in range(num_layers):
            out = w_dim if idx == num_layers - 1 else layer_features
            setattr(self, f"fc{idx}", FullyConnectedLayer(
                features, out, activation=activation,
                lr_multiplier=lr_multiplier))
            features = out
        self.register_buffer("w_avg", torch.zeros(w_dim))

    def forward(self, z: Optional[torch.Tensor], c: Optional[torch.Tensor],
                truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None,
                update_emas: bool = False,
                skip_w_avg_update: bool = False) -> torch.Tensor:
        xs = []
        if self.z_dim > 0:
            xs.append(normalize_2nd_moment(z.float()))
        if self.c_dim > 0:
            xs.append(normalize_2nd_moment(self.embed(c.float())))
        x = torch.cat(xs, dim=1) if len(xs) > 1 else xs[0]
        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)
        if update_emas and not skip_w_avg_update:
            with torch.no_grad():   # the global batch's mean w
                self.w_avg.copy_(torch.lerp(x.detach().mean(dim=0),
                                            self.w_avg, self.w_avg_beta))
        if self.num_ws is not None:
            x = x[:, None, :].repeat(1, self.num_ws, 1)
        if truncation_psi != 1.0:
            if self.num_ws is None or truncation_cutoff is None:
                x = self.w_avg.lerp(x, truncation_psi)
            else:
                x = torch.cat([self.w_avg.lerp(x[:, :truncation_cutoff],
                                               truncation_psi),
                               x[:, truncation_cutoff:]], dim=1)
        return x


class MinibatchStdLayer(nn.Module):
    """Append per-group feature-std statistics as extra channels, with
    STRIDED groups: group column k holds images {a * (n // G) + k}
    (reference: discriminators.py:307-328).  Groups span the global batch,
    as in JAX's sharded program: under data parallelism the layer gathers
    every rank's rows (differentiably), computes the statistic as one
    process would, and keeps its own rows."""

    def __init__(self, group_size: Optional[int] = 4, num_channels: int = 1):
        super().__init__()
        self.group_size = group_size
        self.num_channels = num_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        g = n if self.group_size is None else min(self.group_size, n)
        if n % g != 0:
            g = n
        f = self.num_channels
        y = x.reshape(g, n // g, f, c // f, h, w).float()
        y = y - y.mean(dim=0)
        y = (y.square().mean(dim=0) + 1e-8).sqrt()
        y = y.mean(dim=(2, 3, 4))                       # [n//g, f]
        y = y.reshape(-1, f, 1, 1).repeat(g, 1, h, w)   # [n, f, h, w]
        return torch.cat([x, y.to(x.dtype)], dim=1)
