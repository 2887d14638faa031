"""A frozen plain copy of style_big_gan_tpu_torch/ops/upfirdn2d.py,
the benchmark's reference: the program may change, this copy does not.

upfirdn2d: zero-insert upsample -> pad (or crop) -> FIR filter ->
downsample, plain PyTorch over NCHW.

Counterpart of style_big_gan_tpu/ops/upfirdn2d.py with its exact semantics:
the filter is applied as a true convolution unless ``flip_filter``, and the
upsample's energy gain ``up_x * up_y`` is folded into ``gain`` inside this
function (as the JAX op does).  Separable (1-D) filters run as two passes,
2-D filters as one; each is a one-channel convolution over the channels
folded into the batch, so autograd differentiates to any order.  The
convolution is ``conv.py``'s: ``F.conv2d``, in float32 on bfloat16
operands inside its scope (PPL).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference.conv import conv2d


def _parse_scaling(scaling) -> tuple:
    if isinstance(scaling, int):
        return scaling, scaling
    sx, sy = scaling
    return int(sx), int(sy)


def _parse_padding(padding) -> tuple:
    if isinstance(padding, int):
        return padding, padding, padding, padding
    padding = list(padding)
    if len(padding) == 2:
        px, py = padding
        return px, px, py, py
    px0, px1, py0, py1 = padding
    return px0, px1, py0, py1


def setup_filter(f, normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1.0,
                 separable: Optional[bool] = None) -> torch.Tensor:
    """Canonical float32 filter: [fh, fw], or [taps] when separable
    (reference: upfirdn2d.py:72-116).  None -> identity filter."""
    if f is None:
        f = 1.0
    f = torch.as_tensor(np.asarray(f, np.float32))
    if f.ndim == 0:
        f = f[None]
    if f.ndim not in (1, 2):
        raise ValueError("filter must be 0/1/2-D")
    if f.numel() == 0:
        raise ValueError("empty filter")
    if separable is None:
        separable = (f.ndim == 1 and f.numel() >= 8)
    if f.ndim == 1 and not separable:
        f = torch.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f.flip(list(range(f.ndim)))
    return f * (gain ** (f.ndim / 2))


def _filter_taps(f) -> tuple:
    if f is None:
        return 1, 1
    if f.ndim == 1:
        return int(f.shape[0]), int(f.shape[0])
    return int(f.shape[0]), int(f.shape[1])


def upfirdn2d(x: torch.Tensor, f: Optional[torch.Tensor],
              up: Union[int, Sequence[int]] = 1,
              down: Union[int, Sequence[int]] = 1,
              padding: Union[int, Sequence[int]] = 0,
              flip_filter: bool = False, gain: float = 1.0) -> torch.Tensor:
    """out = downsample(filter(pad(upsample(x)))) on NCHW ``x``."""
    if x.ndim != 4:
        raise ValueError("x must be [N, C, H, W]")
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    n, c, h, w = x.shape
    if upx > 1 or upy > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(n, c, h * upy, w * upx)
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0):x.shape[2] - max(-py1, 0),
          max(-px0, 0):x.shape[3] - max(-px1, 0)]

    if f is None:
        f = torch.ones(1, 1)
    f = f.to(device=x.device, dtype=x.dtype)
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    total_gain = gain * upx * upy
    # The same filter for every channel: fold the channels into the batch
    # and run a one-channel conv.  The depthwise form (groups=C) computes
    # the same values, but PyTorch differentiates a grouped conv twice one
    # group at a time (thousands of small convs in R1's and PPL's double
    # backward).  The downsample is the conv's stride.
    hp, wp = x.shape[2], x.shape[3]
    x = x.reshape(n * c, 1, hp, wp)
    if f.ndim == 2:
        x = conv2d(x, (f * total_gain)[None, None], stride=(downy, downx))
    else:
        f = f * float(np.sqrt(total_gain))
        x = conv2d(x, f[None, None, :, None], stride=(downy, 1))
        x = conv2d(x, f[None, None, None, :], stride=(1, downx))
    return x.reshape(n, c, x.shape[2], x.shape[3])


def filter2d(x, f, padding=0, flip_filter: bool = False, gain: float = 1.0):
    """Filter without resampling (reference: upfirdn2d.py:272-304)."""
    fh, fw = _filter_taps(f)
    px0, px1, py0, py1 = _parse_padding(padding)
    return upfirdn2d(x, f, padding=(px0 + fw // 2, px1 + (fw - 1) // 2,
                                    py0 + fh // 2, py1 + (fh - 1) // 2),
                     flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter: bool = False,
               gain: float = 1.0):
    """Upsample with the given filter (reference: upfirdn2d.py:308-343)."""
    upx, upy = _parse_scaling(up)
    px0, px1, py0, py1 = _parse_padding(padding)
    fh, fw = _filter_taps(f)
    return upfirdn2d(x, f, up=up,
                     padding=(px0 + (fw + upx - 1) // 2,
                              px1 + (fw - upx) // 2,
                              py0 + (fh + upy - 1) // 2,
                              py1 + (fh - upy) // 2),
                     flip_filter=flip_filter, gain=gain)


def downsample2d(x, f, down=2, padding=0, flip_filter: bool = False,
                 gain: float = 1.0):
    """Downsample with the given filter (reference: upfirdn2d.py:347-382)."""
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    fh, fw = _filter_taps(f)
    return upfirdn2d(x, f, down=down,
                     padding=(px0 + (fw - downx + 1) // 2,
                              px1 + (fw - downx) // 2,
                              py0 + (fh - downy + 1) // 2,
                              py1 + (fh - downy) // 2),
                     flip_filter=flip_filter, gain=gain)
