"""One scanline pass of the ADA two-pass warp: hand-written CUDA kernels for
Hopper, their plain PyTorch versions, and the autograd pair.

    out[n,v,l] = sum_i T[n,v,i] * lerp(src[n, min(i + shift[n,l], A-1), l])

with T the tent of the positions ``pos`` [n, V] (``_tent_matrix``: at most
two non-zeros a row, at floor(p) and floor(p)+1 of p = clamp(pos, 0, A-1))
and the shift's integer part masked to its low ``bits`` bits (the range the
JAX package's shift cascade covers).  The kernels in ``csrc/warp_pass.cu``
replace the Pallas kernels of style_big_gan_tpu/ops/warp_pallas.py
(``_fwd_kernel`` :67-81, ``_bwd_kernel`` :84-99).  They take ``pos`` and
never build T: each output is a two-tap gather of at most three source
values, so the work is bound by bytes (about 0.16 ms for the 256 px main
path's pass 1 at n = 64 in bf16 on an H100).  The forward stages the source
rows a tile reads in shared memory; the adjoint builds T's transpose as CSR
per image, so its sums have a fixed order and it is bitwise repeatable.
See the note at the top of that source.

``warp_pass_fwd`` / ``warp_pass_adjoint`` launch the kernel for CUDA tensors
and run the plain version only for CPU tensors; any other device raises.
Each keeps a launch count in ``LAUNCHES``.  ``warp_pass`` wires the pair as
two ``torch.autograd.Function``s, each the other's backward, so gradients of
any order work (R1 runs the warp inside a double backward).  ``pos`` and
``shift`` get no gradient, as ``tent`` and ``shift`` in the JAX
``warp_pass``.

The kernels are built from the package sources at first use with ``nvcc``
(plain C interface, loaded with ``ctypes``) into ``build/torch_kernels/``
beside the package, keyed by the source's hash.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "warp_pass.cu")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {"warp_pass_fwd": 0, "warp_pass_adjoint": 0}

_LIB: Optional[ctypes.CDLL] = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the warp kernels need the CUDA "
                       "toolkit (set NVCC or put nvcc on PATH)")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, digest.hexdigest()[:16],
                        "libwarp_pass.so")


def build(verbose: bool = False) -> str:
    """Compile ``csrc/warp_pass.cu`` unless its build is present; returns
    the library path.  ``verbose`` adds ``-Xptxas -v`` and prints what the
    compiler says (registers, shared memory, spills)."""
    path = library_path()
    if os.path.exists(path) and not verbose:
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, end="")
    os.replace(tmp, path)      # atomic: concurrent builders never see half
    return path


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.warp_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        lib.warp_fwd.restype = i
        lib.warp_adj.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.warp_adj.restype = i
        lib.warp_adj_scratch_bytes.argtypes = [i, i, i]
        lib.warp_adj_scratch_bytes.restype = ctypes.c_size_t
        _LIB = lib
    return _LIB


# ------------------------------------------------------------ plain versions

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


def warp_pass_plain(src: torch.Tensor, pos: torch.Tensor,
                    shift: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain version of the forward kernel: the dense tent in src's dtype,
    then gather, lerp and product in f32, result in src's dtype."""
    a = src.shape[1]
    tent = _tent_matrix(pos, a).to(src.dtype)
    r0, r1, f = _rows(shift, a, bits)
    s = src.float()
    cur = (1.0 - f) * s.gather(1, r0) + f * s.gather(1, r1)
    return torch.bmm(tent.float(), cur).to(src.dtype)


def warp_pass_adjoint_plain(g: torch.Tensor, pos: torch.Tensor,
                            shift: torch.Tensor, bits: int,
                            a: int) -> torch.Tensor:
    """Plain version of the adjoint kernel: u = tent^T g with the dense tent
    in g's dtype, then the exact transpose of the lerp-gather as two
    scatter-adds, in f32; ``a`` is the source's row count A."""
    tent = _tent_matrix(pos, a).to(g.dtype)
    u = torch.bmm(tent.float().transpose(1, 2), g.float())
    r0, r1, f = _rows(shift, a, bits)
    out = torch.zeros_like(u)
    out.scatter_add_(1, r0, (1.0 - f) * u)
    out.scatter_add_(1, r1, f * u)
    return out.to(g.dtype)


# ------------------------------------------------------------------ wrappers

def _check(x: torch.Tensor, pos: torch.Tensor, shift: torch.Tensor,
           bits: int, a: Optional[int] = None) -> None:
    """``a``: the source's row count A, x's own rows when None."""
    if x.ndim != 3 or pos.ndim != 2 or shift.ndim != 2:
        raise ValueError("expected x [n,R,L], pos [n,V], shift [n,L]; got "
                         f"{tuple(x.shape)}, {tuple(pos.shape)}, "
                         f"{tuple(shift.shape)}")
    n, r, l = x.shape
    a = r if a is None else a
    if pos.shape[0] != n or tuple(shift.shape) != (n, l) or a < 1:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, pos "
                         f"{tuple(pos.shape)}, shift {tuple(shift.shape)}, "
                         f"A {a}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if pos.dtype != torch.float32 or shift.dtype != torch.float32:
        raise TypeError(f"pos and shift must be float32; got {pos.dtype}, "
                        f"{shift.dtype}")
    if not (x.device == pos.device == shift.device):
        raise ValueError("x, pos and shift must be on one device")
    if not (x.is_contiguous() and pos.is_contiguous()
            and shift.is_contiguous()):
        raise ValueError("x, pos and shift must be contiguous")
    if not 1 <= int(bits) <= 30:
        raise ValueError(f"bits must be in [1, 30], got {bits}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _vecio(x: torch.Tensor) -> int:
    """1 when x's rows can be staged 16 bytes at a time: L a multiple of 16
    bytes of elements and x 16-byte aligned."""
    return int(x.shape[2] * x.element_size() % 16 == 0
               and x.data_ptr() % 16 == 0)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def warp_pass_fwd(src: torch.Tensor, pos: torch.Tensor, shift: torch.Tensor,
                  bits: int) -> torch.Tensor:
    """src [n,A,L], pos [n,V] f32, shift [n,L] f32 -> out [n,V,L]."""
    _check(src, pos, shift, bits)
    if src.device.type == "cpu":
        return warp_pass_plain(src, pos, shift, bits)
    n, a, l = src.shape
    v = pos.shape[1]
    out = torch.empty((n, v, l), dtype=src.dtype, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = _lib().warp_fwd(src.data_ptr(), pos.data_ptr(),
                             shift.data_ptr(), out.data_ptr(), n, a, v, l,
                             int(bits), _DTYPES[src.dtype],
                             _vecio(src), stream)
    _raise_on(rc, "warp_fwd")
    LAUNCHES["warp_pass_fwd"] += 1
    return out


def warp_pass_adjoint(g: torch.Tensor, pos: torch.Tensor,
                      shift: torch.Tensor, bits: int, a: int) -> torch.Tensor:
    """g [n,V,L], pos [n,V] f32, shift [n,L] f32 -> out [n,A,L]."""
    _check(g, pos, shift, bits, a)
    if g.shape[1] != pos.shape[1]:
        raise ValueError(f"g {tuple(g.shape)} and pos {tuple(pos.shape)} "
                         "differ in V")
    if g.device.type == "cpu":
        return warp_pass_adjoint_plain(g, pos, shift, bits, a)
    n, v, l = g.shape
    lib = _lib()
    # The CSR of the tent's transpose.
    scratch = torch.empty(lib.warp_adj_scratch_bytes(n, a, v),
                          dtype=torch.uint8, device=g.device)
    out = torch.empty((n, a, l), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = lib.warp_adj(g.data_ptr(), pos.data_ptr(), shift.data_ptr(),
                          scratch.data_ptr(), out.data_ptr(), n, a, v, l,
                          int(bits), _DTYPES[g.dtype], _vecio(g),
                          stream)
    _raise_on(rc, "warp_adj")
    LAUNCHES["warp_pass_adjoint"] += 1
    return out


class WarpPass(torch.autograd.Function):
    """Forward pass; its backward is ``WarpPassAdjoint``."""

    @staticmethod
    def forward(ctx, src, pos, shift, bits):
        ctx.save_for_backward(pos, shift)
        ctx.bits, ctx.a = bits, src.shape[1]
        return warp_pass_fwd(src, pos, shift, bits)

    @staticmethod
    def backward(ctx, g):
        pos, shift = ctx.saved_tensors
        return (WarpPassAdjoint.apply(g.contiguous(), pos, shift, ctx.bits,
                                      ctx.a),
                None, None, None)


class WarpPassAdjoint(torch.autograd.Function):
    """Adjoint pass; its backward (the adjoint's transpose) is
    ``WarpPass``."""

    @staticmethod
    def forward(ctx, g, pos, shift, bits, a):
        ctx.save_for_backward(pos, shift)
        ctx.bits = bits
        return warp_pass_adjoint(g, pos, shift, bits, a)

    @staticmethod
    def backward(ctx, x):
        pos, shift = ctx.saved_tensors
        return (WarpPass.apply(x.contiguous(), pos, shift, ctx.bits),
                None, None, None, None)


def warp_pass(src: torch.Tensor, pos: torch.Tensor, shift: torch.Tensor,
              bits: int) -> torch.Tensor:
    """Differentiable (any order, in ``src``) scanline pass."""
    return WarpPass.apply(src, pos, shift, bits)
