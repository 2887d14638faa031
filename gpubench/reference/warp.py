"""One scanline pass of the ADA two-pass warp, plain PyTorch.

Frozen copy of the plain versions in style_big_gan_tpu_torch/ops/warp.py:

    out[n,v,l] = sum_i T[n,v,i] * lerp(src[n, min(i + shift[n,l], A-1), l])

with T the tent of the positions ``pos`` [n, V] (at most two non-zeros a
row, at floor(p) and floor(p)+1 of p = clamp(pos, 0, A-1)) and the shift's
integer part masked to its low ``bits`` bits.  The dense tent in src's
dtype, the gather, lerp and product in float32, the result in src's dtype;
autograd differentiates it to any order in ``src``.  ``pos`` and ``shift``
take no gradient.
"""

from __future__ import annotations

import torch


def _tent_matrix(pos: torch.Tensor, size: int) -> torch.Tensor:
    """[n, V, size] linear-interpolation weights for clamped sampling at
    positions pos [n, V]."""
    pos = pos.clamp(0.0, float(size - 1))
    i = torch.arange(size, dtype=torch.float32, device=pos.device)
    return (1.0 - (pos[..., None] - i).abs()).clamp_min(0.0)


def _rows(shift: torch.Tensor, a: int, bits: int):
    """Clamped source rows r0 = min(i+idx, A-1), r1 = min(i+1+idx, A-1)
    ([n, A, L] int64) and the lerp weight frac ([n, 1, L] f32)."""
    fl = torch.floor(shift)
    idx = (fl.long() & ((1 << bits) - 1))[:, None, :]
    i = torch.arange(a, device=shift.device)[None, :, None]
    r0 = (i + idx).clamp(max=a - 1)
    r1 = (i + 1 + idx).clamp(max=a - 1)
    return r0, r1, (shift - fl)[:, None, :]


def warp_pass(src: torch.Tensor, pos: torch.Tensor, shift: torch.Tensor,
              bits: int) -> torch.Tensor:
    a = src.shape[1]
    pos, shift = pos.detach(), shift.detach()
    tent = _tent_matrix(pos, a).to(src.dtype)
    r0, r1, f = _rows(shift, a, bits)
    s = src.float()
    cur = (1.0 - f) * s.gather(1, r0) + f * s.gather(1, r1)
    return torch.bmm(tent.float(), cur).to(src.dtype)
