"""The reference's convolutions: ``F.conv2d`` and ``F.conv_transpose2d``,
differentiated to any order by aten's own autograd.

Inside ``float32_operands()`` (PPL's forward and its ``create_graph``
gradient) a bfloat16 convolution runs in float32 on its bfloat16 operands
and rounds its output to bfloat16, so that aten differentiates it twice in
float32.  aten's own double backward of a bfloat16 convolution is wrong on
the CPU, not merely rounded: the second-order weight gradient of a 3x3
layer of 16 channels at 16 px reads 612.9 against 5146.3 in float64
(gpubench/tests/test_gpubench_reference.py holds the scope against float64).
The values rounded to bfloat16 are those a bfloat16 kernel rounds: each
convolution's output, and, through the casts' own gradients, each gradient
that a convolution gives its input and its weight.  Outside the scope, and
for operands of any other type, these are ``F.conv2d`` and
``F.conv_transpose2d`` themselves.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

_FLOAT32 = contextvars.ContextVar("gpubench_float32_operands",
                                  default=False)


@contextlib.contextmanager
def float32_operands(on: bool = True):
    token = _FLOAT32.set(bool(on))
    try:
        yield
    finally:
        _FLOAT32.reset(token)


def _run(op, x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
    if _FLOAT32.get() and x.dtype == torch.bfloat16:
        return op(x.float(), w.float(), **kw).to(x.dtype)
    return op(x, w, **kw)


def conv2d(x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
    return _run(F.conv2d, x, w, **kw)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
    return _run(F.conv_transpose2d, x, w, **kw)
