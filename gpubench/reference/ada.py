"""A frozen plain copy of style_big_gan_tpu_torch/augment/ada.py,
the benchmark's reference: the program may change, this copy does not.

ADA augmentation pipeline in PyTorch.

Counterpart of style_big_gan_tpu/augment/ada.py (reference
augmentations.py:24-433).  ``pipe(images, generator, p)`` takes NCHW float32
images in [-1, 1], a ``torch.Generator`` on the images' device for its
random draws and ``p`` as a Python float or a 0-d tensor, so the ADA
controller can move p without a host round-trip.  Per-op gating is a
per-image ``where``; ``debug_percentile`` replaces every draw with a fixed
percentile of its distribution exactly as the JAX pipe does (the parity
tests pin it).  One process: every draw is the whole batch's.

The geometric stage is the JAX package's two-pass form (``warp_impl``
``twopass``): reflect-pad + 2x sym6 upsample and the final 2x downsample
as band-matrix products, and the affine warp as two scanline passes whose
shift + tent resample run in the plain form of warp.py (the program runs
hand-written CUDA kernels there).
It runs in NHWC internally so each pass's lanes are ordered as in JAX.
Non-square images, or ``warp_impl="gather"``, take the gather warp: the
sym6 up/down passes as ``upfirdn2d`` and a bilinear read of each output
sample (``bilinear_sample``), plain PyTorch that R1 differentiates twice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.signal
import scipy.special
import torch
import torch.nn.functional as F

from gpubench.reference.upfirdn2d import setup_filter, upfirdn2d
from gpubench.reference.warp import warp_pass

# Wavelet table (reference: augmentations.py:24-41).
WAVELETS = {
    "haar": [0.7071067811865476, 0.7071067811865476],
    "db1": [0.7071067811865476, 0.7071067811865476],
    "db2": [-0.12940952255092145, 0.22414386804185735, 0.836516303737469,
            0.48296291314469025],
    "db3": [0.035226291882100656, -0.08544127388224149, -0.13501102001039084,
            0.4598775021193313, 0.8068915093133388, 0.3326705529509569],
    "sym2": [-0.12940952255092145, 0.22414386804185735, 0.836516303737469,
             0.48296291314469025],
    "sym3": [0.035226291882100656, -0.08544127388224149, -0.13501102001039084,
             0.4598775021193313, 0.8068915093133388, 0.3326705529509569],
    "sym6": [0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
             -0.048311742585633, 0.4910559419267466, 0.787641141030194,
             0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
             0.04472490177066578, 0.0017677118642428036,
             -0.007800708325034148],
}

# ------------------------------------------- batched homogeneous matrices
# Each takes [n] tensors and returns [n, 3, 3] or [n, 4, 4].


def _mat(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def translate2d_inv(tx, ty):
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return _mat([[o, z, -tx], [z, o, -ty], [z, z, o]])


def scale2d_inv(sx, sy):
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return _mat([[1.0 / sx, z, z], [z, 1.0 / sy, z], [z, z, o]])


def rotate2d_inv(theta):
    c, s = torch.cos(-theta), torch.sin(-theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _mat([[c, -s, z], [s, c, z], [z, z, o]])


def translate3d(tx, ty, tz):
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return _mat([[o, z, z, tx], [z, o, z, ty], [z, z, o, tz], [z, z, z, o]])


def scale3d(sx, sy, sz):
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return _mat([[sx, z, z, z], [z, sy, z, z], [z, z, sz, z], [z, z, z, o]])


def rotate3d(v, theta):
    """Rotation about the fixed axis v (reference: augmentations.py:88-99)."""
    vx, vy, vz = (float(e) for e in v[:3])
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1.0 - c
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _mat([
        [vx * vx * cc + c, vx * vy * cc - vz * s, vx * vz * cc + vy * s, z],
        [vy * vx * cc + vz * s, vy * vy * cc + c, vy * vz * cc - vx * s, z],
        [vz * vx * cc - vy * s, vz * vy * cc + vx * s, vz * vz * cc + c, z],
        [z, z, z, o]])


def _filter_bank() -> np.ndarray:
    """4-band a-trous filter bank from sym2 (reference:
    augmentations.py:168-174)."""
    hz_lo = np.asarray(WAVELETS["sym2"])
    hz_hi = hz_lo * ((-1) ** np.arange(hz_lo.size))
    hz_lo2 = np.convolve(hz_lo, hz_lo[::-1]) / 2
    hz_hi2 = np.convolve(hz_hi, hz_hi[::-1]) / 2
    fbank = np.eye(4, 1)
    for i in range(1, 4):
        fbank = np.dstack([fbank, np.zeros_like(fbank)]).reshape(4, -1)[:, :-1]
        fbank = scipy.signal.convolve(fbank, [hz_lo2], mode="full")
        fbank[i, (fbank.shape[1] - hz_hi2.size) // 2:
              (fbank.shape[1] + hz_hi2.size) // 2] += hz_hi2
    return fbank


def _reflect_pad(x: torch.Tensor, dim: int, lo: int, hi: int):
    """numpy 'reflect' padding along ``dim``, also for pads longer than the
    axis (the reflection repeats), as jnp.pad does."""
    size = x.shape[dim]
    pos = torch.arange(-lo, size + hi, device=x.device)
    period = max(2 * (size - 1), 1)
    m = pos.remainder(period)
    return x.index_select(dim, torch.where(m < size, m, period - m))


def _pick(gate: torch.Tensor, x: torch.Tensor, fallback) -> torch.Tensor:
    """x where gate holds, else the constant fallback."""
    return torch.where(gate, x, torch.full_like(x, fallback))


# ------------------------------------------------------- two-pass warp

def _edge_pad_front(x: torch.Tensor, t: int, dim: int) -> torch.Tensor:
    """Prepend t edge-replicated slices along ``dim``."""
    edge = x.narrow(dim, 0, 1)
    reps = list(x.shape)
    reps[dim] = t
    return torch.cat([edge.expand(reps), x], dim=dim)


def _scanline_pass(padded: torch.Tensor, pos: torch.Tensor,
                   shift: torch.Tensor, smax: int) -> torch.Tensor:
    """One pass over padded [n, A, B, c]: per-column fractional clamp-shift
    along dim 1 by shift [n, B], then the tent resample at positions
    pos [n, V] -> [n, V, B, c], through the warp-pass kernel (lanes =
    B * c)."""
    n, a, bcols, c = padded.shape
    bits = max(1, int(np.ceil(np.log2(2 * smax + 2))))
    flat = padded.contiguous().reshape(n, a, bcols * c)
    shift_l = shift.repeat_interleave(c, dim=1).contiguous()
    out = warp_pass(flat, pos.contiguous(), shift_l, bits)
    return out.reshape(n, pos.shape[1], bcols, c)


def warp_positions(coef: torch.Tensor, size: int, out_h: int, out_w: int):
    """The two passes' sampling geometry of ``affine_warp_2pass``:
    (swap [n] bool, q1 [n, out_h] tent positions and sigma [n, size] column
    shifts of pass 1, q2 [n, out_w] and tau [n, out_h] of pass 2), all f32;
    smax = size // 2."""
    smax = size // 2
    a, b, c0, d, e, f0 = coef.float().unbind(dim=1)
    swap = d.abs() > a.abs()
    ax = torch.where(swap, d, a)
    bx = torch.where(swap, e, b)
    cx0 = torch.where(swap, f0, c0)
    ay = torch.where(swap, a, d)
    by = torch.where(swap, b, e)
    cy0 = torch.where(swap, c0, f0)
    ax_safe = torch.where(ax.abs() < 1e-8, torch.full_like(ax, 1e-8), ax)
    al = ay / ax_safe
    be = by - al * bx
    ga = cy0 - al * cx0

    dev = coef.device
    xs = torch.arange(size, dtype=torch.float32, device=dev)
    xc = (size - 1) / 2.0
    sigma = (al[:, None] * (xs[None, :] - xc)).clamp(-smax, smax) + smax
    v = torch.arange(out_h, dtype=torch.float32, device=dev)
    q1 = be[:, None] * v[None, :] + (ga + al * xc)[:, None]
    yc = (out_h - 1) / 2.0
    tau = (bx[:, None] * (v[None, :] - yc)).clamp(-smax, smax) + smax
    u = torch.arange(out_w, dtype=torch.float32, device=dev)
    q2 = ax[:, None] * u[None, :] + (cx0 + bx * yc)[:, None]
    return swap, q1, sigma, q2, tau


def affine_warp_2pass(src: torch.Tensor, coef: torch.Tensor, out_h: int,
                      out_w: int) -> torch.Tensor:
    """Per-image affine warp out[yo,xo] = src[py, px] of NHWC ``src`` as a
    2-pass scanline decomposition; coef [n, 6] = (a, b, c, d, e, f) with
    px = a*xo + b*yo + c, py = d*xo + e*yo + f (see the JAX function of the
    same name for the derivation)."""
    n, size, size2, _ = src.shape
    assert size == size2, "2-pass warp requires square input"
    smax = size // 2
    swap, q1, sigma, q2, tau = warp_positions(coef, size, out_h, out_w)
    src2 = torch.where(swap[:, None, None, None], src.transpose(1, 2), src)
    tmp = _scanline_pass(_edge_pad_front(src2, smax, 1), q1, sigma, smax)
    out = _scanline_pass(_edge_pad_front(tmp.transpose(1, 2), smax, 1), q2,
                         tau, smax)
    return out.transpose(1, 2)


# ---------------------------------------------------------- gather warp

def bilinear_sample(images: torch.Tensor, gx: torch.Tensor,
                    gy: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of NHWC ``images`` at pixel coordinates gx, gy
    [n, OH, OW]; out-of-range samples clamp to the border (callers
    reflect-pad first).  Four flat 1-D corner reads and a bilinear blend
    (style_big_gan_tpu/augment/ada.py:385-420): plain indexing that
    autograd differentiates twice, as R1's double backward needs
    (``grid_sample``'s backward has no derivative)."""
    n, h, w, c = images.shape
    oh, ow = gx.shape[-2], gx.shape[-1]
    x0 = gx.floor().long().clamp(0, w - 2)
    y0 = gy.floor().long().clamp(0, h - 2)
    # Weights from the clipped corners, so boundary samples stay exact.
    wx = (gx - x0.to(gx.dtype)).clamp(0.0, 1.0)[..., None]
    wy = (gy - y0.to(gy.dtype)).clamp(0.0, 1.0)[..., None]
    flat = images.reshape(n, h * w, c)

    def corner(dy: int, dx: int) -> torch.Tensor:
        idx = ((y0 + dy) * w + (x0 + dx)).reshape(n, oh * ow, 1)
        return flat.gather(1, idx.expand(-1, -1, c)).reshape(n, oh, ow, c)

    top = corner(0, 0) * (1 - wx) + corner(0, 1) * wx
    bot = corner(1, 0) * (1 - wx) + corner(1, 1) * wx
    return top * (1 - wy) + bot * wy


def _upfirdn1d_matrix(l_in: int, f: np.ndarray, up: int, down: int,
                      p0: int, p1: int, gain: float) -> np.ndarray:
    """Dense [out, l_in] matrix of one 1-D upfirdn pass."""
    taps = int(f.shape[0])
    fy = f[::-1] * gain
    stuffed = l_in * up
    out_len = (stuffed + p0 + p1 - taps) // down + 1
    m = np.zeros((out_len, l_in), np.float32)
    for k in range(taps):
        for j in range(out_len):
            idx = j * down + k - p0
            if 0 <= idx < stuffed and idx % up == 0:
                m[j, idx // up] += fy[k]
    return m


_RESAMPLE_MATS: dict = {}


def _geom_resample_mats(size: int, margin: int, hz: np.ndarray) -> tuple:
    """(B_up [2(size+2*margin), size], B_dn [size, 2*size]): reflect-pad +
    2x sym6 upsample, and 2x sym6 downsample, each along one axis."""
    key = (size, margin, hz.tobytes())
    hit = _RESAMPLE_MATS.get(key)
    if hit is None:
        taps = int(hz.shape[0])
        lp = size + 2 * margin
        idx = np.pad(np.arange(size), margin, mode="reflect")
        pmat = np.zeros((lp, size), np.float32)
        pmat[np.arange(lp), idx] = 1.0
        b_up = _upfirdn1d_matrix(lp, hz, up=2, down=1, p0=taps // 2,
                                 p1=(taps - 1) // 2, gain=2.0) @ pmat
        b_dn = _upfirdn1d_matrix(2 * size, hz, up=1, down=2,
                                 p0=(taps - 1) // 2, p1=(taps - 2) // 2,
                                 gain=1.0)
        hit = _RESAMPLE_MATS[key] = (b_up, b_dn)
    return hit


class AugmentPipe:
    """The full ADA pipe (reference: augmentations.py:120-433)."""

    def __init__(self, xflip=0.0, rotate90=0.0, xint=0.0, xint_max=0.125,
                 scale=0.0, rotate=0.0, aniso=0.0, xfrac=0.0,
                 scale_std=0.2, rotate_max=1.0, aniso_std=0.2,
                 xfrac_std=0.125, brightness=0.0, contrast=0.0, lumaflip=0.0,
                 hue=0.0, saturation=0.0, brightness_std=0.2,
                 contrast_std=0.5, hue_max=1.0, saturation_std=1.0,
                 imgfilter=0.0, imgfilter_bands=(1.0, 1.0, 1.0, 1.0),
                 imgfilter_std=1.0, noise=0.0, cutout=0.0, noise_std=0.1,
                 cutout_size=0.5, debug_percentile: Optional[float] = None,
                 warp_impl: str = "twopass", warp_dtype: str = "bfloat16"):
        self.xflip, self.rotate90 = float(xflip), float(rotate90)
        self.xint, self.xint_max = float(xint), float(xint_max)
        self.scale, self.rotate = float(scale), float(rotate)
        self.aniso, self.xfrac = float(aniso), float(xfrac)
        self.scale_std, self.rotate_max = float(scale_std), float(rotate_max)
        self.aniso_std, self.xfrac_std = float(aniso_std), float(xfrac_std)
        self.brightness, self.contrast = float(brightness), float(contrast)
        self.lumaflip, self.hue = float(lumaflip), float(hue)
        self.saturation = float(saturation)
        self.brightness_std = float(brightness_std)
        self.contrast_std = float(contrast_std)
        self.hue_max = float(hue_max)
        self.saturation_std = float(saturation_std)
        self.imgfilter = float(imgfilter)
        self.imgfilter_bands = tuple(float(b) for b in imgfilter_bands)
        self.imgfilter_std = float(imgfilter_std)
        self.noise, self.cutout = float(noise), float(cutout)
        self.noise_std, self.cutout_size = float(noise_std), float(cutout_size)
        self.debug_percentile = debug_percentile
        if warp_impl not in ("twopass", "gather"):
            raise ValueError(f"warp_impl must be twopass|gather: {warp_impl}")
        self.warp_impl = warp_impl
        if warp_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"warp_dtype must be bfloat16|float32: "
                             f"{warp_dtype}")
        self.warp_dtype = torch.bfloat16 if warp_dtype == "bfloat16" \
            else torch.float32
        self.hz_geom = setup_filter(WAVELETS["sym6"]).numpy()
        self.hz_fbank = torch.as_tensor(_filter_bank(), dtype=torch.float32)
        self._mats: dict = {}

    # ----------------------------------------------------- random primitives

    def _full(self, shape, value, dev):
        return torch.full(shape, float(value), dtype=torch.float32,
                          device=dev)

    def _uniform(self, gen, shape, lo, hi, dev):
        if self.debug_percentile is not None:
            return self._full(shape, lo + (hi - lo) * self.debug_percentile,
                              dev)
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def _randint(self, gen, shape, n, dev):
        if self.debug_percentile is not None:
            return self._full(shape, int(self.debug_percentile * n), dev)
        return torch.randint(0, n, shape, generator=gen, device=dev).float()

    def _lognormal(self, gen, shape, std, dev):
        if self.debug_percentile is not None:
            # Reference debug convention: exp2(erfinv(2q-1) * std), without
            # the sqrt(2) of a true normal percentile.
            return self._full(shape, 2 ** (scipy.special.erfinv(
                2 * self.debug_percentile - 1) * std), dev)
        return torch.exp2(torch.randn(shape, generator=gen, device=dev) * std)

    def _normal(self, gen, shape, std, dev):
        if self.debug_percentile is not None:
            return self._full(shape, scipy.special.erfinv(
                2 * self.debug_percentile - 1) * std, dev)
        return torch.randn(shape, generator=gen, device=dev) * std

    def _gate(self, gen, shape, prob, dev):
        """Bernoulli(prob) mask; prob a tensor of p times a strength."""
        if self.debug_percentile is not None:
            return self._full(shape, self.debug_percentile, dev) < prob
        return torch.rand(shape, generator=gen, device=dev) < prob

    # ------------------------------------------------------------------ main

    def __call__(self, images: torch.Tensor,
                 generator: Optional[torch.Generator], p) -> torch.Tensor:
        n, c, h, w = images.shape
        dev = images.device
        p = torch.as_tensor(p, dtype=torch.float32, device=dev)
        images = images.float()
        gen = generator

        if any(v > 0 for v in (self.xflip, self.rotate90, self.xint,
                               self.scale, self.rotate, self.aniso,
                               self.xfrac)):
            images = self._execute_geom(
                images, self._draw_geom(gen, p, n, h, w, dev))

        if any(v > 0 for v in (self.brightness, self.contrast, self.lumaflip,
                               self.hue, self.saturation)):
            eye4 = torch.eye(4, device=dev)
            C = eye4.repeat(n, 1, 1)
            v = np.asarray([1, 1, 1, 0], np.float32) / np.sqrt(3)
            # Made once per device: a host copy inside the pipe would stop
            # a CUDA graph from capturing it (train/graphs.py).
            key = ("luma", str(dev))
            if key not in self._mats:
                self._mats[key] = torch.as_tensor(
                    np.outer(v, v), dtype=torch.float32, device=dev)
            vv = self._mats[key]
            if self.brightness > 0:
                b = self._normal(gen, (n,), self.brightness_std, dev)
                b = _pick(self._gate(gen, (n,), self.brightness * p, dev), b,
                          0.0)
                C = translate3d(b, b, b) @ C
            if self.contrast > 0:
                s = self._lognormal(gen, (n,), self.contrast_std, dev)
                s = _pick(self._gate(gen, (n,), self.contrast * p, dev), s,
                          1.0)
                C = scale3d(s, s, s) @ C
            if self.lumaflip > 0:
                i = self._randint(gen, (n,), 2, dev)
                i = _pick(self._gate(gen, (n,), self.lumaflip * p, dev), i,
                          0.0)
                house = eye4 - 2.0 * vv
                C = torch.where(i[:, None, None] > 0.5, house, eye4) @ C
            if self.hue > 0 and c > 1:
                theta = self._uniform(gen, (n,), -np.pi * self.hue_max,
                                      np.pi * self.hue_max, dev)
                theta = _pick(self._gate(gen, (n,), self.hue * p, dev), theta,
                              0.0)
                C = rotate3d(v, theta) @ C
            if self.saturation > 0 and c > 1:
                s = self._lognormal(gen, (n,), self.saturation_std, dev)
                s = _pick(self._gate(gen, (n,), self.saturation * p, dev), s,
                          1.0)
                C = (vv + (eye4 - vv) * s[:, None, None]) @ C
            images = self._execute_color(images, C)

        if self.imgfilter > 0:
            images = self._execute_imgfilter(images, gen, p)

        if self.noise > 0:
            if self.debug_percentile is not None:
                # Reference debug: sigma = erfinv(q) * std
                # (augmentations.py:408-409).
                sigma = self._full((n,), scipy.special.erfinv(
                    self.debug_percentile) * self.noise_std, dev)
            else:
                sigma = self._normal(gen, (n,), self.noise_std, dev).abs()
            sigma = _pick(self._gate(gen, (n,), self.noise * p, dev), sigma,
                          0.0)
            nz = torch.randn(images.shape, generator=gen, device=dev)
            images = images + nz * sigma[:, None, None, None]
        if self.cutout > 0:
            size = self.cutout_size
            center = self._uniform(gen, (n, 2), 0.0, 1.0, dev)
            use = self._gate(gen, (n, 1, 1, 1), self.cutout * p, dev)
            cx = center[:, 0][:, None, None, None]
            cy = center[:, 1][:, None, None, None]
            coord_x = (torch.arange(w, device=dev) + 0.5) / w
            coord_y = (torch.arange(h, device=dev) + 0.5) / h
            mask_x = (coord_x[None, None, None, :] - cx).abs() >= size / 2
            mask_y = (coord_y[None, None, :, None] - cy).abs() >= size / 2
            mask = torch.where(use, mask_x | mask_y, True)
            images = images * mask.to(images.dtype)
        return images

    # ------------------------------------------------------------ executors

    def _draw_geom(self, gen, p: torch.Tensor, n: int, h: int, w: int,
                   dev) -> torch.Tensor:
        """The geometric stage's random inverse transforms G_inv [n, 3, 3],
        drawn in the order of the JAX pipe."""
        one = torch.ones(n, device=dev)

        G_inv = torch.eye(3, device=dev).repeat(n, 1, 1)
        if self.xflip > 0:
            i = self._randint(gen, (n,), 2, dev)
            i = _pick(self._gate(gen, (n,), self.xflip * p, dev), i, 0.0)
            G_inv = G_inv @ scale2d_inv(1.0 - 2.0 * i, one)
        if self.rotate90 > 0:
            i = self._randint(gen, (n,), 4, dev)
            i = _pick(self._gate(gen, (n,), self.rotate90 * p, dev), i,
                      0.0)
            G_inv = G_inv @ rotate2d_inv(-np.pi / 2 * i)
        if self.xint > 0:
            t = self._uniform(gen, (n, 2), -self.xint_max, self.xint_max,
                              dev)
            t = _pick(self._gate(gen, (n, 1), self.xint * p, dev), t, 0.0)
            G_inv = G_inv @ translate2d_inv(torch.round(t[:, 0] * w),
                                            torch.round(t[:, 1] * h))
        if self.scale > 0:
            s = self._lognormal(gen, (n,), self.scale_std, dev)
            s = _pick(self._gate(gen, (n,), self.scale * p, dev), s, 1.0)
            G_inv = G_inv @ scale2d_inv(s, s)
        p_rot = 1.0 - torch.sqrt((1.0 - self.rotate * p).clamp(0.0, 1.0))
        if self.rotate > 0:
            theta = self._uniform(gen, (n,), -np.pi * self.rotate_max,
                                  np.pi * self.rotate_max, dev)
            theta = _pick(self._gate(gen, (n,), p_rot, dev), theta, 0.0)
            G_inv = G_inv @ rotate2d_inv(-theta)
        if self.aniso > 0:
            s = self._lognormal(gen, (n,), self.aniso_std, dev)
            s = _pick(self._gate(gen, (n,), self.aniso * p, dev), s, 1.0)
            G_inv = G_inv @ scale2d_inv(s, 1.0 / s)
        if self.rotate > 0:
            theta = self._uniform(gen, (n,), -np.pi * self.rotate_max,
                                  np.pi * self.rotate_max, dev)
            theta = _pick(self._gate(gen, (n,), p_rot, dev), theta, 0.0)
            if self.debug_percentile is not None:
                # The reference zeroes the post-rotation in debug mode
                # (augmentations.py:257-258).
                theta = torch.zeros_like(theta)
            G_inv = G_inv @ rotate2d_inv(-theta)
        if self.xfrac > 0:
            t = self._normal(gen, (n, 2), self.xfrac_std, dev)
            t = _pick(self._gate(gen, (n, 1), self.xfrac * p, dev), t, 0.0)
            G_inv = G_inv @ translate2d_inv(t[:, 0] * w, t[:, 1] * h)
        return G_inv

    def _resample_mats(self, h, margin, dev):
        key = (h, margin, str(dev))
        if key not in self._mats:
            b_up, b_dn = _geom_resample_mats(h, margin, self.hz_geom)
            self._mats[key] = tuple(
                torch.as_tensor(m, device=dev).to(self.warp_dtype)
                for m in (b_up, b_dn))
        return self._mats[key]

    def _geom_frame(self, h: int, w: int):
        """(taps, margin, d_u, d_d) of the geometric stage: the fixed
        reflect margin and the exact group delays (centre of mass) of the
        sym6 up and down passes, which align the warp."""
        hz = self.hz_geom
        taps = int(hz.shape[0])
        margin = min(max(h, w) // 4, 64) + taps
        f_conv = hz[::-1]
        com = float((np.arange(taps) * f_conv).sum() / f_conv.sum())
        return taps, margin, com - taps // 2, com - (taps - 1) // 2

    def _warp_coef(self, G_inv: torch.Tensor, h: int, w: int):
        """(coef [n, 6] of ``affine_warp_2pass`` in the 2x upsampled,
        margin-padded frame, margin): G_inv with the exact group delay of
        the sym6 low-pass for alignment."""
        _, margin, d_u, d_d = self._geom_frame(h, w)
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        g00, g01, g02 = G_inv[:, 0, 0], G_inv[:, 0, 1], G_inv[:, 0, 2]
        g10, g11, g12 = G_inv[:, 1, 0], G_inv[:, 1, 1], G_inv[:, 1, 2]
        c0 = (-g00 * (d_d + 2 * cx) - g01 * (d_d + 2 * cy)
              + 2 * g02 + 2 * cx + 2 * margin - d_u)
        f0 = (-g10 * (d_d + 2 * cx) - g11 * (d_d + 2 * cy)
              + 2 * g12 + 2 * cy + 2 * margin - d_u)
        return torch.stack([g00, g01, c0, g10, g11, f0], dim=1), margin

    def _execute_geom(self, images: torch.Tensor,
                      G_inv: torch.Tensor) -> torch.Tensor:
        """reflect-pad -> 2x upsample -> affine warp -> 2x downsample
        (reference: augmentations.py:274-305): the two-pass warp for
        square images when asked for, else the gather warp (the dispatch
        of style_big_gan_tpu/augment/ada.py:696)."""
        n, c, h, w = images.shape
        if not (self.warp_impl == "twopass" and h == w):
            return self._execute_geom_gather(images, G_inv)
        coef, margin = self._warp_coef(G_inv, h, w)
        b_up, b_dn = self._resample_mats(h, margin, images.device)
        x = images.permute(0, 2, 3, 1).to(self.warp_dtype)        # NHWC
        up = torch.einsum("ri,nixc->nrxc", b_up, x)
        up = torch.einsum("xj,nrjc->nrxc", b_up, up)
        warped = affine_warp_2pass(up, coef, 2 * h, 2 * w)
        out = torch.einsum("ri,nixc->nrxc", b_dn, warped)
        out = torch.einsum("xj,nrjc->nrxc", b_dn, out)
        return out.to(images.dtype).permute(0, 3, 1, 2)

    def _execute_geom_gather(self, images: torch.Tensor,
                             G_inv: torch.Tensor) -> torch.Tensor:
        """The gather form in float32 (style_big_gan_tpu/augment/ada.py:
        722-757): reflect-pad, the 2x sym6 upsample, a bilinear read of
        every output sample through G_inv, the 2x sym6 downsample."""
        n, c, h, w = images.shape
        dev = images.device
        taps, margin, d_u, d_d = self._geom_frame(h, w)
        hz = torch.as_tensor(self.hz_geom, device=dev)
        pad = _reflect_pad(_reflect_pad(images, 2, margin, margin), 3,
                           margin, margin)
        up = upfirdn2d(pad, hz, up=2, padding=(taps // 2, (taps - 1) // 2,
                                               taps // 2, (taps - 1) // 2))
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        ox = (torch.arange(2 * w, dtype=torch.float32, device=dev) - d_d) \
            / 2.0 - cx
        oy = (torch.arange(2 * h, dtype=torch.float32, device=dev) - d_d) \
            / 2.0 - cy
        gyy, gxx = torch.meshgrid(oy, ox, indexing="ij")        # [2h, 2w]
        coords = torch.stack([gxx, gyy, torch.ones_like(gxx)], dim=-1)
        src = torch.einsum("nij,hwj->nhwi", G_inv, coords)      # [n,2h,2w,3]
        z = src[..., 2]
        zs = z.abs().clamp_min(1e-8)
        sx = src[..., 0] / zs * z.sign()
        sy = src[..., 1] / zs * z.sign()
        px = 2.0 * (sx + cx + margin) - d_u
        py = 2.0 * (sy + cy + margin) - d_u
        warped = bilinear_sample(up.permute(0, 2, 3, 1), px, py)
        return upfirdn2d(warped.permute(0, 3, 1, 2), hz, down=2,
                         padding=((taps - 1) // 2, (taps - 2) // 2,
                                  (taps - 1) // 2, (taps - 2) // 2))

    def _execute_color(self, images: torch.Tensor,
                       C: torch.Tensor) -> torch.Tensor:
        c = images.shape[1]
        if c == 3:
            return (torch.einsum("nij,njhw->nihw", C[:, :3, :3], images)
                    + C[:, :3, 3][:, :, None, None])
        if c == 1:
            # Grayscale: project onto luma (reference:
            # augmentations.py:366-368).
            M = C[:, :3, :3].mean(dim=(1, 2))[:, None, None, None]
            t = C[:, :3, 3].mean(dim=1)[:, None, None, None]
            return images * M + t
        return images

    def _execute_imgfilter(self, images, gen, p):
        """Per-image amplified band filtering (reference:
        augmentations.py:376-404)."""
        n, c, h, w = images.shape
        dev = images.device
        fbank = self.hz_fbank.to(dev)
        num_bands = fbank.shape[0]
        assert len(self.imgfilter_bands) == num_bands
        expected = torch.tensor([10, 1, 1, 1], dtype=torch.float32,
                                device=dev) / 13.0
        g = torch.ones(n, num_bands, device=dev)
        for i, strength in enumerate(self.imgfilter_bands):
            ti = self._lognormal(gen, (n,), self.imgfilter_std, dev)
            ti = torch.where(self._gate(gen, (n,),
                                        self.imgfilter * p * strength, dev),
                             ti, torch.ones_like(ti))
            if self.debug_percentile is not None and strength <= 0:
                ti = torch.ones_like(ti)   # reference: augmentations.py:387
            t = torch.ones(n, num_bands, device=dev)
            t[:, i] = ti
            t = t / (expected[None] * t.square()).sum(dim=1,
                                                      keepdim=True).sqrt()
            g = g * t
        hz_prime = g @ fbank                                 # [n, taps]
        taps = hz_prime.shape[1]
        pad = taps // 2
        lo, hi = pad, pad - (1 - taps % 2)
        fy = hz_prime[:, None, :].repeat(1, c, 1).reshape(n * c, taps)
        x = images.reshape(1, n * c, h, w)
        x = F.conv2d(_reflect_pad(x, 2, lo, hi), fy[:, None, :, None],
                     groups=n * c)
        x = F.conv2d(_reflect_pad(x, 3, lo, hi), fy[:, None, None, :],
                     groups=n * c)
        return x.reshape(n, c, h, w)


# Named augpipe presets (reference: stylegan2ada/train.py:271-283).
AUGPIPE_SPECS = {
    "blit": dict(xflip=1, rotate90=1, xint=1),
    "geom": dict(scale=1, rotate=1, aniso=1, xfrac=1),
    "color": dict(brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1),
    "filter": dict(imgfilter=1),
    "noise": dict(noise=1),
    "cutout": dict(cutout=1),
    "bg": dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
               xfrac=1),
    "bgc": dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
                xfrac=1, brightness=1, contrast=1, lumaflip=1, hue=1,
                saturation=1),
    "bgcf": dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
                 xfrac=1, brightness=1, contrast=1, lumaflip=1, hue=1,
                 saturation=1, imgfilter=1),
    "bgcfn": dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
                  xfrac=1, brightness=1, contrast=1, lumaflip=1, hue=1,
                  saturation=1, imgfilter=1, noise=1),
    "bgcfnc": dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
                   xfrac=1, brightness=1, contrast=1, lumaflip=1, hue=1,
                   saturation=1, imgfilter=1, noise=1, cutout=1),
}
