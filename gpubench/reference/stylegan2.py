"""A frozen plain copy of style_big_gan_tpu_torch/models/stylegan2.py,
the benchmark's reference: the program may change, this copy does not.

StyleGAN2 generator and discriminator as ``nn.Module``s (NCHW).

Counterparts of style_big_gan_tpu/models/stylegan2.py (reference
generators.py:273-563, discriminators.py:211-466): the modulated conv in its
input/output-scaling form, reduced precision (bfloat16, as in the JAX
package) on the top ``num_fp16_res`` resolutions with ToRGB accumulation in
float32, ``conv_clamp``, and Freeze-D through ``requires_grad``.  Per-layer
noise draws from an optional ``torch.Generator``.  Module and parameter
names follow the original reference (``synthesis.b8.conv0.affine.weight``,
``b4.fc.weight``, ...).  No attention, no rematerialisation, no tensor
parallelism: the benchmark's configurations use none.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gpubench.reference.layers import (Conv2dLayer,
                                                   FullyConnectedLayer,
                                                   MappingNetwork,
                                                   MinibatchStdLayer)
from gpubench.reference.bias_act import activation_funcs, bias_act
from gpubench.reference.modconv import modulated_conv2d
from gpubench.reference.upfirdn2d import (downsample2d, setup_filter,
                                                   upsample2d)


def _channels_dict(resolutions, channel_base, channel_max):
    return {res: min(channel_base // res, channel_max) for res in resolutions}


class SynthesisLayer(nn.Module):
    """Modulated conv + noise + bias_act (reference: generators.py:273-329).
    With a sharded float32 weight the modconv runs on this rank's output
    channels and the noise is added to the gathered output."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, kernel_size: int = 3, up: int = 1,
                 use_noise: bool = True, activation: str = "lrelu",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None):
        super().__init__()
        self.resolution = resolution
        self.up = up
        self.use_noise = use_noise
        self.activation = activation
        self.conv_clamp = conv_clamp
        self.padding = kernel_size // 2
        self.register_buffer(
            "resample_filter",
            setup_filter(list(resample_filter)) if up > 1 else None,
            persistent=False)
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels,
                                               kernel_size, kernel_size))
        if use_noise:
            self.register_buffer("noise_const",
                                 torch.randn(resolution, resolution))
            self.noise_strength = nn.Parameter(torch.zeros([]))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                noise_mode: str = "random", gain: float = 1.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        assert noise_mode in ("random", "const", "none")
        styles = self.affine(w)
        noise = None
        if self.use_noise and noise_mode == "random":
            noise = torch.randn(
                (x.shape[0], 1, self.resolution, self.resolution),
                device=x.device, generator=generator) * self.noise_strength
        elif self.use_noise and noise_mode == "const":
            noise = self.noise_const[None, None] * self.noise_strength
        x = modulated_conv2d(x, self.weight, styles, noise=noise,
                             up=self.up, padding=self.padding,
                             resample_filter=self.resample_filter,
                             flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        clamp = self.conv_clamp * gain if self.conv_clamp is not None \
            else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain,
                        clamp=clamp)


class ToRGBLayer(nn.Module):
    """1x1 modconv without demodulation (reference: generators.py:334-348)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 kernel_size: int = 1, conv_clamp: Optional[float] = None):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.padding = kernel_size // 2
        self.weight_gain = 1.0 / np.sqrt(in_channels * kernel_size ** 2)
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w) * self.weight_gain

        x = modulated_conv2d(x, self.weight, styles, demodulate=False,
                             padding=self.padding)
        return bias_act(x, self.bias, clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    """One resolution rung (reference: generators.py:354-458)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, img_channels: int, is_last: bool,
                 architecture: str = "skip",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, use_fp16: bool = False,
                 layer_kwargs: Optional[Dict[str, Any]] = None):
        super().__init__()
        assert architecture in ("orig", "skip", "resnet")
        self.in_channels = in_channels
        self.architecture = architecture
        self.is_last = is_last
        self.use_fp16 = use_fp16
        self.register_buffer("resample_filter",
                             setup_filter(list(resample_filter)),
                             persistent=False)
        common = dict(w_dim=w_dim, resolution=resolution,
                      conv_clamp=conv_clamp,
                      resample_filter=tuple(resample_filter),
                      **dict(layer_kwargs or {}))
        if in_channels == 0:
            self.const = nn.Parameter(torch.randn(out_channels, resolution,
                                                  resolution))
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, up=2,
                                        **common)
        self.conv1 = SynthesisLayer(out_channels, out_channels, **common)
        if is_last or architecture == "skip":
            self.torgb = ToRGBLayer(out_channels, img_channels, w_dim=w_dim,
                                    conv_clamp=conv_clamp)
        if in_channels != 0 and architecture == "resnet":
            self.skip = Conv2dLayer(in_channels, out_channels, kernel_size=1,
                                    use_bias=False, up=2,
                                    resample_filter=tuple(resample_filter))

    @property
    def num_conv(self) -> int:
        return 1 if self.in_channels == 0 else 2

    @property
    def num_torgb(self) -> int:
        return 1 if (self.is_last or self.architecture == "skip") else 0

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor],
                ws: torch.Tensor, force_fp32: bool = False,
                noise_mode: str = "random",
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        dtype = torch.bfloat16 if (self.use_fp16 and not force_fp32) \
            else torch.float32
        kw = dict(noise_mode=noise_mode, generator=generator)
        w_iter = iter(ws.unbind(dim=1))
        if self.in_channels == 0:
            x = self.const[None].to(dtype).repeat(ws.shape[0], 1, 1, 1)
            x = self.conv1(x, next(w_iter), **kw)
        elif self.architecture == "resnet":
            x = x.to(dtype)
            y = self.skip(x, gain=np.sqrt(0.5))
            x = self.conv0(x, next(w_iter), **kw)
            x = self.conv1(x, next(w_iter), gain=np.sqrt(0.5), **kw)
            x = y + x
        else:
            x = x.to(dtype)
            x = self.conv0(x, next(w_iter), **kw)
            x = self.conv1(x, next(w_iter), **kw)
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        if self.num_torgb:
            y = self.torgb(x, next(w_iter)).float()
            img = img + y if img is not None else y
        return x, img


class SynthesisNetwork(nn.Module):
    """Resolution ladder 4 -> img_resolution
    (reference: generators.py:464-519)."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512,
                 num_fp16_res: int = 0, conv_clamp: Optional[float] = None,
                 architecture: str = "skip",
                 layer_kwargs: Optional[Dict[str, Any]] = None):
        super().__init__()
        assert img_resolution >= 4 and \
            (img_resolution & (img_resolution - 1)) == 0
        self.block_resolutions = [2 ** i for i in
                                  range(2, int(np.log2(img_resolution)) + 1)]
        channels = _channels_dict(self.block_resolutions, channel_base,
                                  channel_max)
        fp16_res = max(2 ** (int(np.log2(img_resolution)) + 1 -
                             num_fp16_res), 8)
        for res in self.block_resolutions:
            setattr(self, f"b{res}", SynthesisBlock(
                in_channels=channels[res // 2] if res > 4 else 0,
                out_channels=channels[res], w_dim=w_dim, resolution=res,
                img_channels=img_channels, is_last=(res == img_resolution),
                architecture=architecture, conv_clamp=conv_clamp,
                use_fp16=(res >= fp16_res and num_fp16_res > 0),
                layer_kwargs=layer_kwargs))

    def forward(self, ws: torch.Tensor, force_fp32: bool = False,
                noise_mode: str = "random",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ws = ws.float()
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            n_ws = block.num_conv + block.num_torgb
            run = functools.partial(block, force_fp32=force_fp32,
                                    noise_mode=noise_mode,
                                    generator=generator)
            w = ws[:, w_idx:w_idx + n_ws]
            x, img = run(x, img, w)
            w_idx += block.num_conv
        return img


class Generator(nn.Module):
    """Mapping + synthesis (reference: generators.py:533-563).
    forward(z, c) -> NCHW image."""

    def __init__(self, z_dim: int = 512, w_dim: int = 512, c_dim: int = 0,
                 img_resolution: int = 256, img_channels: int = 3,
                 channel_base: int = 32768, channel_max: int = 512,
                 num_fp16_res: int = 0, conv_clamp: Optional[float] = None,
                 architecture: str = "skip",
                 mapping_kwargs: Optional[Dict[str, Any]] = None,
                 layer_kwargs: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.z_dim, self.w_dim, self.c_dim = z_dim, w_dim, c_dim
        self.img_resolution = img_resolution
        self.num_ws = 2 * (int(np.log2(img_resolution)) - 1)
        self.synthesis = SynthesisNetwork(
            w_dim=w_dim, img_resolution=img_resolution,
            img_channels=img_channels, channel_base=channel_base,
            channel_max=channel_max, num_fp16_res=num_fp16_res,
            conv_clamp=conv_clamp, architecture=architecture,
            layer_kwargs=layer_kwargs)
        self.mapping = MappingNetwork(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
                                      num_ws=self.num_ws,
                                      **dict(mapping_kwargs or {}))

    def forward(self, z, c=None, truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None,
                update_emas: bool = False, force_fp32: bool = False,
                noise_mode: str = "random",
                generator: Optional[torch.Generator] = None):
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff,
                          update_emas=update_emas)
        return self.synthesis(ws, force_fp32=force_fp32,
                              noise_mode=noise_mode, generator=generator)

    def map_ws(self, z, c=None, **kwargs):
        return self.mapping(z, c, **kwargs)

    def synthesize(self, ws, **kwargs):
        return self.synthesis(ws, **kwargs)


class DiscriminatorBlock(nn.Module):
    """fromRGB + conv rung with orig/skip/resnet wiring and Freeze-D
    (reference: discriminators.py:211-302)."""

    def __init__(self, in_channels: int, tmp_channels: int,
                 out_channels: int, resolution: int, img_channels: int,
                 first_layer_idx: int, architecture: str = "resnet",
                 activation: str = "lrelu",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, use_fp16: bool = False,
                 freeze_layers: int = 0):
        super().__init__()
        assert architecture in ("orig", "skip", "resnet")
        self.in_channels = in_channels
        self.architecture = architecture
        self.use_fp16 = use_fp16
        self.register_buffer("resample_filter",
                             setup_filter(list(resample_filter)),
                             persistent=False)
        layer_idx = [first_layer_idx]

        def trainable():
            t = layer_idx[0] >= freeze_layers
            layer_idx[0] += 1
            return t

        rf = tuple(resample_filter)
        if in_channels == 0 or architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels,
                                       kernel_size=1, activation=activation,
                                       conv_clamp=conv_clamp,
                                       trainable=trainable())
        if architecture == "resnet":
            self.skip = Conv2dLayer(tmp_channels, out_channels,
                                    kernel_size=1, use_bias=False, down=2,
                                    resample_filter=rf,
                                    trainable=trainable())
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, kernel_size=3,
                                 activation=activation,
                                 conv_clamp=conv_clamp, trainable=trainable())
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, kernel_size=3,
                                 activation=activation, down=2,
                                 resample_filter=rf, conv_clamp=conv_clamp,
                                 trainable=trainable())
        self.num_layers = layer_idx[0] - first_layer_idx

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor],
                force_fp32: bool = False):
        dtype = torch.bfloat16 if (self.use_fp16 and not force_fp32) \
            else torch.float32
        if x is not None:
            x = x.to(dtype)
        if self.in_channels == 0 or self.architecture == "skip":
            img = img.to(dtype)
            y = self.fromrgb(img)
            x = x + y if x is not None else y
            img = downsample2d(img, self.resample_filter) \
                if self.architecture == "skip" else None
        if self.architecture == "resnet":
            y = self.skip(x, gain=np.sqrt(0.5))
            x = self.conv0(x)
            x = self.conv1(x, gain=np.sqrt(0.5))
            x = y + x
        else:
            x = self.conv1(self.conv0(x))
        return x, img


class DiscriminatorEpilogue(nn.Module):
    """mbstd -> conv -> fc -> out, projection conditioning
    (reference: discriminators.py:332-389)."""

    def __init__(self, in_channels: int, cmap_dim: int, resolution: int,
                 img_channels: int, architecture: str = "resnet",
                 mbstd_group_size: Optional[int] = 4,
                 mbstd_num_channels: int = 1, activation: str = "lrelu",
                 conv_clamp: Optional[float] = None):
        super().__init__()
        self.architecture = architecture
        self.cmap_dim = cmap_dim
        if architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, in_channels,
                                       kernel_size=1, activation=activation)
        self.mbstd = MinibatchStdLayer(mbstd_group_size, mbstd_num_channels) \
            if mbstd_num_channels > 0 else None
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels,
                                kernel_size=3, activation=activation,
                                conv_clamp=conv_clamp)
        self.fc = FullyConnectedLayer(in_channels * resolution ** 2,
                                      in_channels, activation=activation)
        self.out = FullyConnectedLayer(in_channels,
                                       1 if cmap_dim == 0 else cmap_dim)

    def forward(self, x, img, cmap):
        x = x.float()
        if self.architecture == "skip":
            x = x + self.fromrgb(img.float())
        if self.mbstd is not None:
            x = self.mbstd(x)
        x = self.conv(x)
        x = self.out(self.fc(x.flatten(1)))
        if self.cmap_dim > 0:
            x = (x * cmap).sum(dim=1, keepdim=True) / np.sqrt(self.cmap_dim)
        return x


class Discriminator(nn.Module):
    """StyleGAN2 discriminator (reference: discriminators.py:402-466)."""

    def __init__(self, c_dim: int = 0, img_resolution: int = 256,
                 img_channels: int = 3,
                 architecture: str = "resnet", channel_base: int = 32768,
                 channel_max: int = 512, num_fp16_res: int = 0,
                 conv_clamp: Optional[float] = None,
                 cmap_dim: Optional[int] = None, freeze_layers: int = 0,
                 mapping_kwargs: Optional[Dict[str, Any]] = None,
                 epilogue_kwargs: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.c_dim = c_dim
        self.epilogue_kwargs = dict(epilogue_kwargs or {})
        res_log2 = int(np.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(res_log2, 2, -1)]
        channels = _channels_dict(self.block_resolutions + [4], channel_base,
                                  channel_max)
        fp16_res = max(2 ** (res_log2 + 1 - num_fp16_res), 8)
        if cmap_dim is None:
            cmap_dim = channels[4]
        if c_dim == 0:
            cmap_dim = 0
        cur_layer_idx = 0
        for res in self.block_resolutions:
            block = DiscriminatorBlock(
                in_channels=channels[res] if res < img_resolution else 0,
                tmp_channels=channels[res], out_channels=channels[res // 2],
                resolution=res, img_channels=img_channels,
                first_layer_idx=cur_layer_idx, architecture=architecture,
                conv_clamp=conv_clamp,
                use_fp16=(res >= fp16_res and num_fp16_res > 0),
                freeze_layers=freeze_layers)
            setattr(self, f"b{res}", block)
            cur_layer_idx += block.num_layers
        if c_dim > 0:
            self.mapping = MappingNetwork(z_dim=0, c_dim=c_dim,
                                          w_dim=cmap_dim, num_ws=None,
                                          w_avg_beta=1.0,
                                          **dict(mapping_kwargs or {}))
        self.b4 = DiscriminatorEpilogue(
            in_channels=channels[4], cmap_dim=cmap_dim, resolution=4,
            img_channels=img_channels, architecture=architecture,
            conv_clamp=conv_clamp, **self.epilogue_kwargs)

    def forward(self, img, c=None, force_fp32: bool = False,
                update_emas: bool = False):
        x = None
        for res in self.block_resolutions:
            x, img = getattr(self, f"b{res}")(x, img, force_fp32=force_fp32)
        cmap = self.mapping(None, c) if self.c_dim > 0 else None
        return self.b4(x, img, cmap)
