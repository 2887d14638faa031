"""Warp-pass pair of the PyTorch port (style_big_gan_tpu_torch/ops/warp.py)
against the JAX package: the six cases of tests/test_warp_pallas.py held
against JAX's ``warp_pass_ref`` (and its interpret-mode Pallas
``warp_pass``) on the same numpy inputs, plus the shift's ``bits`` edge and
the tent positions' edge cases.  The port takes the positions ``pos``
[n, V]; JAX takes its own ``_tent_matrix(pos, A)`` built from them.
On the CPU the port's wrappers run their plain versions; the
kernel-against-plain cases need a GPU and skip here.  JAX is imported
through a fixture, so on a machine with a GPU and no JAX the GPU cases run
alone:  python -m pytest tests/test_torch_warp.py -m cuda --noconftest"""

import numpy as np
import pytest
import torch

from style_big_gan_tpu_torch.ops import warp as tw

BITS = 4   # shifts < 16


def _inputs(n=2, a=40, l=136, v=24, seed=0, shift_max=(1 << BITS) - 2):
    """l not a multiple of 128 (a partial lane tile on the TPU and of the
    CUDA kernel's 64-lane tile); a not a multiple of either tile.  Tent
    positions in random order over [0, a-1]."""
    rnd = np.random.RandomState(seed)
    src = rnd.randn(n, a, l).astype(np.float32)
    pos = (rnd.rand(n, v) * (a - 1)).astype(np.float32)
    shift = (rnd.rand(n, l) * shift_max).astype(np.float32)
    return src, pos, shift


def _edge_pos(case, n, a, v, seed):
    """Tent positions [n, v] of one edge case."""
    rnd = np.random.RandomState(seed)
    ramp = np.arange(v, dtype=np.float64)
    if case == "ends":             # exactly 0 and A-1 (no column A)
        pos = np.where(ramp % 2 == 0, 0.0, a - 1.0)
    elif case == "clamped":        # below 0 and above A-1
        pos = np.linspace(-3.0 * a, 4.0 * a, v)
    elif case == "nonmonotone":
        pos = rnd.permutation(np.linspace(0.5, a - 1.5, v))
    elif case == "many_per_row":   # |slope| << 1
        pos = a / 3 + 0.07 * ramp
    else:                          # "skips_rows": |slope| > 2
        pos = 0.3 + (a - 1.0) / (v - 1) * ramp
    return np.broadcast_to(pos, (n, v)).astype(np.float32).copy()


EDGE_CASES = ["ends", "clamped", "nonmonotone", "many_per_row", "skips_rows"]


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in arrays]


@pytest.fixture
def jx():
    """(jax, jnp, warp_pass_ref, Pallas warp_pass) of the JAX package."""
    jax = pytest.importorskip("jax")
    from style_big_gan_tpu.augment.ada import _tent_matrix
    from style_big_gan_tpu.ops.warp_pallas import warp_pass, warp_pass_ref
    return jax, jax.numpy, warp_pass_ref, warp_pass, _tent_matrix


def _jtent(jx, pos, a):
    """JAX's dense tent [n, V, a] of the positions, as numpy f32."""
    return np.asarray(jx[4](jx[1].asarray(pos), a), dtype=np.float32)


def test_forward_matches_jax(jx):
    jax, jnp, warp_pass_ref, jwarp, _ = jx
    src, pos, shift = _inputs()
    tent = _jtent(jx, pos, 40)
    out = tw.warp_pass(*_t(src, pos, shift), BITS).numpy()
    ref = np.asarray(warp_pass_ref(src, tent, shift, BITS))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(jwarp(jnp.asarray(src), jnp.asarray(tent),
                              jnp.asarray(shift), BITS))
    np.testing.assert_allclose(out, pallas, rtol=1e-5, atol=1e-5)


def test_adjoint_identity(jx):
    """<warp(x), y> == <x, warp^T(y)>, and the port's adjoint equals the
    JAX VJP of the reference."""
    jax, jnp, warp_pass_ref, jwarp, _ = jx
    src, pos, shift = _inputs(seed=1)
    tent = _jtent(jx, pos, 40)
    y = np.random.RandomState(2).randn(2, 24, 136).astype(np.float32)
    s, t, sh, yt = _t(src, pos, shift, y)
    s.requires_grad_(True)
    out = tw.warp_pass(s, t, sh, BITS)
    (xt,) = torch.autograd.grad(out, s, grad_outputs=yt)
    lhs = float((out.detach().double() * yt.double()).sum())
    rhs = float((s.detach().double() * xt.double()).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4)
    (jxt,) = jax.vjp(lambda v: warp_pass_ref(v, tent, shift, BITS),
                     jnp.asarray(src))[1](jnp.asarray(y))
    np.testing.assert_allclose(xt.numpy(), np.asarray(jxt), rtol=1e-5,
                               atol=1e-5)


def test_grad_matches_jax(jx):
    jax, jnp, warp_pass_ref, jwarp, _ = jx
    src, pos, shift = _inputs(seed=3)
    tent = _jtent(jx, pos, 40)
    s, t, sh = _t(src, pos, shift)
    s.requires_grad_(True)
    torch.sin(tw.warp_pass(s, t, sh, BITS)).sum().backward()
    gr = jax.grad(lambda v: jnp.sum(jnp.sin(warp_pass_ref(
        v, tent, shift, BITS))))(jnp.asarray(src))
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gr), rtol=1e-4,
                               atol=1e-5)


def test_grad_of_grad_matches_jax(jx):
    """R1 runs the warp inside a double backward: WarpPass and
    WarpPassAdjoint differentiate through each other."""
    jax, jnp, warp_pass_ref, jwarp, _ = jx
    src, pos, shift = _inputs(n=1, a=24, l=130, v=12, seed=4)
    tent = _jtent(jx, pos, 24)
    s, t, sh = _t(src, pos, shift)
    s.requires_grad_(True)
    (g1,) = torch.autograd.grad((tw.warp_pass(s, t, sh, BITS) ** 2).sum(),
                                s, create_graph=True)
    (gg,) = torch.autograd.grad((g1 ** 2).sum(), s)

    def f(v):
        return jnp.sum(warp_pass_ref(v, tent, shift, BITS) ** 2)

    ref = jax.grad(lambda v: jnp.sum(jax.grad(f)(v) ** 2))(jnp.asarray(src))
    np.testing.assert_allclose(gg.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_bf16_path(jx):
    jax, jnp, warp_pass_ref, jwarp, _ = jx
    src, pos, shift = _inputs(seed=5)
    tent = _jtent(jx, pos, 40)
    (s,) = _t(src, dtype=torch.bfloat16)
    out16 = tw.warp_pass(s, *_t(pos, shift), BITS)
    assert out16.dtype == torch.bfloat16
    ref = np.asarray(warp_pass_ref(src, tent, shift, BITS))
    np.testing.assert_allclose(out16.float().numpy(), ref, rtol=0.03,
                               atol=0.05)


def test_partial_tile_and_tall_shift(jx):
    """l=136, a=40 with shifts reaching past a (clamped to the last row)."""
    jax, jnp, warp_pass_ref, jwarp, _ = jx
    src, pos, shift = _inputs(a=40, l=136, seed=6, shift_max=60.0)
    tent = _jtent(jx, pos, 40)
    out = tw.warp_pass(*_t(src, pos, shift), 6).numpy()
    ref = np.asarray(warp_pass_ref(src, tent, shift, 6))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("base", [0.0, 14.75, 15.5, 16.25, 31.9, 47.0])
def test_shift_at_bits_edge(jx, base):
    """The cascade applies only the shift's low ``bits`` bits; the port
    masks the integer part the same way (idx & (2**bits - 1))."""
    jax, jnp, warp_pass_ref, jwarp, _ = jx
    src, pos, _ = _inputs(seed=7)
    tent = _jtent(jx, pos, 40)
    shift = np.full((2, 136), base, np.float32)
    shift[:, ::3] += 0.5
    out = tw.warp_pass(*_t(src, pos, shift), BITS).numpy()
    ref = np.asarray(warp_pass_ref(src, tent, shift, BITS))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    (jxt,) = jax.vjp(lambda v: warp_pass_ref(v, tent, shift, BITS),
                     jnp.asarray(src))[1](jnp.ones((2, 24, 136)))
    adj = tw.warp_pass_adjoint(torch.ones(2, 24, 136),
                               *_t(pos, shift), BITS, 40).numpy()
    np.testing.assert_allclose(adj, np.asarray(jxt), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_positions_match_jax(jx, case):
    """Tent positions at and past the ends, out of order, many on one
    source row and skipping rows: forward and adjoint against JAX."""
    jax, jnp, warp_pass_ref, jwarp, _ = jx
    src, _, shift = _inputs(a=40, l=136, v=24, seed=10)
    pos = _edge_pos(case, 2, 40, 24, seed=11)
    tent = _jtent(jx, pos, 40)
    out = tw.warp_pass(*_t(src, pos, shift), BITS).numpy()
    ref = np.asarray(warp_pass_ref(src, tent, shift, BITS))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    y = np.random.RandomState(12).randn(2, 24, 136).astype(np.float32)
    (jxt,) = jax.vjp(lambda v: warp_pass_ref(v, tent, shift, BITS),
                     jnp.asarray(src))[1](jnp.asarray(y))
    adj = tw.warp_pass_adjoint(*_t(y, pos, shift), BITS, 40).numpy()
    np.testing.assert_allclose(adj, np.asarray(jxt), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["random"] + EDGE_CASES)
def test_bf16_weights_equal_jax_tent(jx, case):
    """With shift 0 and src the identity on rows x lanes, the bf16 pass
    returns its tent weights: they equal JAX's tent rounded to bf16, bit
    for bit."""
    a = 40
    pos = _inputs(seed=13)[1] if case == "random" else \
        _edge_pos(case, 2, a, 24, seed=13)
    eye = torch.eye(a, dtype=torch.bfloat16).expand(2, a, a).contiguous()
    out = tw.warp_pass(eye, *_t(pos, np.zeros((2, a), np.float32)), BITS)
    want = _jtent(jx, pos, a).astype(np.float32)
    want16 = torch.from_numpy(want).to(torch.bfloat16)
    assert torch.equal(out, want16)


@pytest.mark.parametrize("bad", ["noncontig", "dtype", "pos_dtype",
                                 "pos_shape", "shape", "shift_dtype",
                                 "device"])
def test_wrappers_reject_bad_inputs(bad):
    src, pos, shift = _t(*_inputs())
    if bad == "noncontig":
        src = src.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "dtype":
        src = src.double()
    elif bad == "pos_dtype":
        pos = pos.double()
    elif bad == "pos_shape":
        pos = pos[:, :, None].contiguous()
    elif bad == "shape":
        pos = pos[:1].contiguous()
    elif bad == "shift_dtype":
        shift = shift.double()
    else:
        src, pos, shift = (x.to("meta") for x in (src, pos, shift))
    with pytest.raises((ValueError, TypeError)):
        tw.warp_pass_fwd(src, pos, shift, BITS)


def test_cpu_launches_no_kernel():
    tw.reset_launch_counts()
    tw.warp_pass(*_t(*_inputs()), BITS)
    assert tw.LAUNCHES == {"warp_pass_fwd": 0, "warp_pass_adjoint": 0}


# ------------------------------------------------- kernel vs plain (GPU)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have "
                    "no CPU mode")
    return torch.device("cuda")


TOLS = {torch.float32: dict(rtol=1e-5, atol=1e-5),
        torch.bfloat16: dict(rtol=0.03, atol=0.05)}


def _check_pair(src, pos, shift, g, bits):
    a = src.shape[1]
    before = dict(tw.LAUNCHES)
    for got, want in (
            (tw.warp_pass_fwd(src, pos, shift, bits),
             tw.warp_pass_plain(src, pos, shift, bits)),
            (tw.warp_pass_adjoint(g, pos, shift, bits, a),
             tw.warp_pass_adjoint_plain(g, pos, shift, bits, a))):
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   **TOLS[src.dtype])
    assert tw.LAUNCHES["warp_pass_fwd"] == before["warp_pass_fwd"] + 1
    assert tw.LAUNCHES["warp_pass_adjoint"] == \
        before["warp_pass_adjoint"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shift_max", [180.0, 9.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_gpu(cuda, dtype, shift_max):
    """l = 333: lanes not a multiple of 16 bytes (element-wise copies).
    Shifts up to 180 and positions in random order spread a tile's rows
    past the shared-memory budget, so both kernels read through L2; shifts
    up to 9 and sorted positions keep the tiles in shared memory."""
    src, pos, shift = _inputs(n=3, a=200, l=333, v=70, seed=8,
                              shift_max=shift_max)
    if shift_max < 10:
        pos = np.sort(pos, axis=1)
    src, pos, shift = (x.to(cuda) for x in _t(src, pos, shift))
    g = torch.randn(3, 70, 333, device=cuda).to(dtype)
    _check_pair(src.to(dtype), pos, shift, g, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_positions_match_plain_on_gpu(cuda, case, dtype):
    """l = 384 (16-byte rows, cp.async staging) and small shifts, so the
    windows fit in shared memory except where the positions spread."""
    n, a, l, v = 2, 300, 384, 150
    src, _, shift = _inputs(n=n, a=a, l=l, v=v, seed=14, shift_max=9.0)
    pos = _edge_pos(case, n, a, v, seed=15)
    g = np.random.RandomState(16).randn(n, v, l).astype(np.float32)
    src, pos, shift, g = (x.to(cuda) for x in _t(src, pos, shift, g))
    _check_pair(src.to(dtype), pos, shift, g.to(dtype), 5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random"] + EDGE_CASES)
def test_bf16_weights_on_gpu(cuda, case):
    a = 40
    pos = _inputs(seed=13)[1] if case == "random" else \
        _edge_pos(case, 2, a, 24, seed=13)
    pos = torch.from_numpy(pos).to(cuda)
    eye = torch.eye(a, dtype=torch.bfloat16, device=cuda).expand(
        2, a, a).contiguous()
    out = tw.warp_pass_fwd(eye, pos, torch.zeros(2, a, device=cuda), BITS)
    want = tw._tent_matrix(pos, a).to(torch.bfloat16)
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adjoint_bitwise_repeatable_on_gpu(cuda, dtype):
    """The CSR transpose fixes every sum's order: two runs agree bit for
    bit, clamped positions piling onto rows 0 and A-1 included."""
    n, a, l, v = 3, 500, 768, 400
    _, _, shift = _inputs(n=n, a=a, l=l, v=v, seed=17, shift_max=250.0)
    pos = _edge_pos("clamped", n, a, v, seed=18)
    g = np.random.RandomState(19).randn(n, v, l).astype(np.float32)
    g, pos, shift = (x.to(cuda) for x in _t(g, pos, shift))
    g = g.to(dtype)
    first = tw.warp_pass_adjoint(g, pos, shift, 9, a)
    second = tw.warp_pass_adjoint(g, pos, shift, 9, a)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_grad_of_grad_on_gpu(cuda):
    src, pos, shift = (x.to(cuda) for x in _t(*_inputs(seed=9)))

    def gg(fn):
        s = src.clone().requires_grad_(True)
        (g1,) = torch.autograd.grad((fn(s, pos, shift, BITS) ** 2).sum(),
                                    s, create_graph=True)
        (g2,) = torch.autograd.grad((g1 ** 2).sum(), s)
        return g2.cpu().numpy()

    np.testing.assert_allclose(gg(tw.warp_pass), gg(tw.warp_pass_plain),
                               rtol=1e-4, atol=1e-5)
