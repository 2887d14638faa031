"""The reference's convolutions (reference/conv.py): inside the scope a
bfloat16 convolution's second-order weight and input gradients follow
float64 to bfloat16's rounding, through aten's autograd alone, at the
shapes the StyleGAN2 layers take (plain, padded, grouped, strided, the
transposed up path and the FIR's one-channel convolutions); outside it
they are aten's own convolutions."""

import pytest
import torch
import torch.nn.functional as F

from gpubench.reference import conv

# (transpose, batch, in, out, size, kernel, stride, padding, groups)
SHAPES = [
    (False, 4, 16, 16, 16, 3, 1, 1, 1),
    (False, 4, 16, 32, 16, 1, 1, 0, 1),
    (False, 2, 16, 16, 16, 3, 2, 0, 1),
    (False, 4, 8, 8, 16, 3, 1, 1, 4),
    (True, 4, 16, 16, 8, 3, 2, 0, 1),
    (False, 64, 1, 1, 19, 4, 1, 0, 1),
    (False, 64, 1, 1, 19, 4, 2, 0, 1),
]


def _second_order(dtype, shape, widened):
    """The gradient, with respect to the weight and the input, of the
    squared input gradient of a leaky-ReLU'd convolution."""
    transpose, n, cin, cout, size, k, stride, padding, groups = shape
    g = torch.Generator().manual_seed(7)
    x0 = torch.randn(n, cin, size, size, generator=g)
    w0 = torch.randn(*((cin, cout // groups) if transpose else
                       (cout, cin // groups)), k, k, generator=g) * 0.2
    # the same bfloat16 operands on both sides
    x = x0.bfloat16().to(dtype).requires_grad_(True)
    w = w0.bfloat16().to(dtype).requires_grad_(True)
    op = conv.conv_transpose2d if transpose else conv.conv2d
    with conv.float32_operands(widened):
        y = F.leaky_relu(op(x, w, stride=stride, padding=padding,
                            groups=groups), 0.2)
        nz = torch.randn(y.shape, generator=g)
        (gx,) = torch.autograd.grad((y.float() * nz).sum(), x,
                                    create_graph=True)
    gw, gxx = torch.autograd.grad(gx.float().square().sum() +
                                  (gx.float() * x.float()).sum(), [w, x])
    return gw.double(), gxx.double()


@pytest.mark.parametrize("shape", SHAPES)
def test_the_scope_follows_float64_in_bfloat16(shape):
    """Within a few of bfloat16's roundings (2 ** -8 each; 1.3e-3 to
    2.6e-3 read on the CPU), where aten's own bfloat16 route reads about
    1.0 on the padded and grouped 3x3 shapes."""
    ref = _second_order(torch.float64, shape, False)
    got = _second_order(torch.bfloat16, shape, True)
    for r, o in zip(ref, got):
        assert float((o - r).norm() / r.norm()) < 1e-2


def test_outside_the_scope_the_convolutions_are_aten_s():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 8, 8, generator=g).bfloat16()
    w = torch.randn(8, 8, 3, 3, generator=g).bfloat16()
    with conv.float32_operands(False):
        y = conv.conv2d(x, w, padding=1)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, F.conv2d(x, w, padding=1))
    with conv.float32_operands():
        with conv.float32_operands(False):
            assert torch.equal(conv.conv2d(x, w, padding=1), y)
        x32, w32 = x.float(), w.float()
        # float32 operands are left as they are
        assert torch.equal(conv.conv2d(x32, w32, padding=1),
                           F.conv2d(x32, w32, padding=1))
        assert torch.equal(conv.conv2d(x, w, padding=1),
                           F.conv2d(x32, w32, padding=1).bfloat16())
