"""A frozen plain copy of style_big_gan_tpu_torch/ops/conv2d_resample.py,
the benchmark's reference: the program may change, this copy does not.

2-D convolution with integrated up/down FIR resampling, plain PyTorch.

Counterpart of style_big_gan_tpu/ops/conv2d_resample.py (reference
conv2d_resample.py:59-154) with the same padding arithmetic and cases:

  up path   : transposed conv (zero-insert by ``up``), then FIR ``f`` with
              gain up^2;
  down path : FIR ``f`` first, then a strided conv;
  plain     : one conv.

Layouts are torch's: x NCHW, w OIHW.  ``flip_weight=True`` means
cross-correlation (``F.conv2d``), False true convolution.  The convolutions
are ``conv.py``'s: ``F.conv2d`` / ``F.conv_transpose2d``, in float32 on
bfloat16 operands inside its scope (PPL).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from gpubench.reference import conv
from gpubench.reference.precision import rounded
from gpubench.reference.upfirdn2d import _filter_taps, upfirdn2d


def conv2d_resample(x: torch.Tensor, w: torch.Tensor,
                    f: Optional[torch.Tensor] = None, up: int = 1,
                    down: int = 1, padding: int = 0, groups: int = 1,
                    flip_weight: bool = True,
                    flip_filter: bool = False) -> torch.Tensor:
    """x: [N, Cin, H, W] -- w: [Cout, Cin//groups, kh, kw]."""
    assert up >= 1 and down >= 1
    kh, kw = int(w.shape[2]), int(w.shape[3])
    fh, fw = _filter_taps(f)
    px0 = px1 = py0 = py1 = int(padding)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
    w = rounded(w.to(x.dtype))

    if up > 1:
        assert groups == 1, "the up path takes groups=1"
        px0 -= kw - 1
        px1 -= kw - up
        py0 -= kh - 1
        py1 -= kh - up
        pxt = max(min(-px0, -px1), 0)
        pyt = max(min(-py0, -py1), 0)
        # conv_transpose2d correlates the zero-inserted input with the
        # spatially flipped, in/out-swapped kernel.
        wt = (w if not flip_weight else w.flip([2, 3])).transpose(0, 1)
        x = conv.conv_transpose2d(rounded(x), wt, stride=up,
                                 padding=(pyt, pxt))
        x = upfirdn2d(x, f, padding=(px0 + pxt, px1 + pxt, py0 + pyt,
                                     py1 + pyt),
                      gain=up ** 2, flip_filter=flip_filter)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    wq = w if flip_weight else w.flip([2, 3])
    if down > 1:
        if f is not None and (fh > 1 or fw > 1):
            x = upfirdn2d(x, f, padding=(px0, px1, py0, py1),
                          flip_filter=flip_filter)
            return conv.conv2d(rounded(x), wq, stride=down, groups=groups)
        x = F.pad(x, [px0, px1, py0, py1])
        return conv.conv2d(rounded(x), wq, stride=down, groups=groups)
    if px0 == px1 == py0 == py1:
        return conv.conv2d(rounded(x), wq, padding=px0, groups=groups)
    return conv.conv2d(rounded(F.pad(x, [px0, px1, py0, py1])), wq,
                       groups=groups)
