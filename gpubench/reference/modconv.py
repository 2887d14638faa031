"""A frozen plain copy of style_big_gan_tpu_torch/ops/modconv.py,
the benchmark's reference: the program may change, this copy does not.

Modulated / demodulated convolution, the StyleGAN2 core op.

Counterpart of style_big_gan_tpu/ops/modconv.py in its input/output-scaling
form: per-sample weight modulation equals scaling the input channels before
one batched conv and, for demodulation, the output channels after it:

    y[n] = conv(x[n] * s[n], w) * d[n]
    d[n,o] = rsqrt( (s[n]^2) @ W2 + eps ),   W2[i,o] = sum_{kh,kw} w[o,i]^2

so no per-sample weights are built.  Layouts: x NCHW, w OIHW, styles
[N, Cin], noise broadcastable to [N, Cout, H, W].
"""

from __future__ import annotations

from typing import Optional

import torch

from gpubench.reference.conv2d_resample import conv2d_resample


def modulated_conv2d(x: torch.Tensor, w: torch.Tensor, styles: torch.Tensor,
                     noise: Optional[torch.Tensor] = None, up: int = 1,
                     down: int = 1, padding: int = 0,
                     resample_filter: Optional[torch.Tensor] = None,
                     demodulate: bool = True,
                     flip_weight: bool = True) -> torch.Tensor:
    n = x.shape[0]
    cout, cin, kh, kw = w.shape
    assert styles.shape == (n, cin), (styles.shape, (n, cin))

    # Pre-normalize to avoid overflow in reduced precision
    # (reference: generators.py:63-65).
    if demodulate and x.dtype in (torch.float16, torch.bfloat16):
        w = w * (1.0 / w.abs().amax(dim=(1, 2, 3), keepdim=True)
                 .clamp_min(1e-8))
        styles = styles / styles.abs().amax(dim=1, keepdim=True) \
            .clamp_min(1e-8)

    dcoefs = None
    if demodulate:
        w32 = w.float()
        s32 = styles.float()
        w2 = (w32 * w32).sum(dim=(2, 3)).t()              # [Cin, Cout]
        dcoefs = torch.rsqrt((s32 * s32) @ w2 + 1e-8)     # [N, Cout]

    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, w.to(x.dtype), f=resample_filter, up=up,
                        down=down, padding=padding, flip_weight=flip_weight)
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
