"""The control's lower precision, switched on for a block of code.

Inside ``lower_precision()`` every convolution and matrix product with a
weight in the reference (``conv2d_resample``'s convolution and
``FullyConnectedLayer``) takes its input and its weight rounded one step
below the precision the configuration states, and computes as before:
float32 operands to TF32 (10 mantissa bits, round to nearest even; the
tensor cores round the same way before they multiply), bfloat16 operands
to float8 e4m3 (3 mantissa bits, saturated at its largest finite value,
448).  The rounding passes the gradient through unchanged, so the
backward passes run at the stated precision on rounded forward values.
Outside the block ``rounded`` returns its argument.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_LOWER = contextvars.ContextVar("gpubench_lower_precision", default=False)
_FP8_MAX = 448.0


@contextlib.contextmanager
def lower_precision(on: bool = True):
    token = _LOWER.set(bool(on))
    try:
        yield
    finally:
        _LOWER.reset(token)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.detach().contiguous().view(torch.int32)
    keep = bits + 0x0FFF + ((bits >> 13) & 1)
    return (keep & ~0x1FFF).view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    q = x.detach().float().clamp(-_FP8_MAX, _FP8_MAX)
    return q.to(torch.float8_e4m3fn).to(x.dtype)


def rounded(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the control's precision inside ``lower_precision``, with a
    straight-through gradient; ``x`` itself outside."""
    if not _LOWER.get():
        return x
    if x.dtype == torch.float32:
        q = _tf32(x)
    elif x.dtype == torch.bfloat16:
        q = _fp8(x)
    else:
        return x
    return x + (q - x).detach()
