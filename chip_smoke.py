#!/usr/bin/env python3
"""Smoke run of the PyTorch port (style_big_gan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero:
  1. environment: torch/CUDA versions, the card's name and power limit,
     the TF32 switches (set explicitly);
  2. kernels: builds csrc/warp_pass.cu, holds both warp-pass kernels against
     their plain PyTorch versions at the 256 px main path's shapes (n = 64,
     the fused Dmain batch) in bf16 and f32, with random tent positions and
     with the positions and shifts of the port's own ADA draws (bgc at
     p = 0.5), on the positions' edge cases and at the 512 px recipe's
     pass-1 shape; checks the adjoint identity, that two adjoint runs are
     bitwise equal, and a grad-of-grad through WarpPass on the card; and
     times kernel and plain version at the ADA draws beside the bound of
     the bytes those draws touch and of a full read; and times the copies
     around the kernels (swap select, edge pads, shift repeat);
  3. main path: the port's SG2Trainer on configs/ffhq256_sg2ada.yaml at the
     recipe's full widths (batch 32, seeded in-memory data) through Dmain,
     Dreg (R1), Gmain and Greg (PPL) with ADA adjusting p; then a short run
     with aug=fixed, p=0.5.  Launch counters are zeroed right before the
     main run and read right after it.
The line before the last is one JSON object with a row per kernel; the last
line is {"ok": true, "device": {...}}.  Needs CUDA; imports nothing of JAX.
"""

import json
import math
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 32
MAIN_BATCHES = 12          # ticks of 4 batches: Dreg at 0, Greg at 0/4/8,
TICK_BATCHES = 4           # ADA adjusts at 4 and 8
FIXED_BATCHES = 2
# Main-path warp shapes at 256 px (augment/ada.py: margin 76, upsampled
# side 816, smax 408, bits 10).
PASSES = {"pass1": dict(a=1224, v=512, l=2448),
          "pass2": dict(a=1224, v=512, l=1536)}
BITS = 10
SMAX = 408
# The 512 px recipe's pass-1 warp (margin 76, side 1328, smax 664, bits 11)
# at n = 16: the kernels take it too (no size gate).
SHAPE_512 = dict(n=16, a=1992, v=1024, l=3984, bits=11, smax=664)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # f32 outside the tensor cores: the kernels'
                               # arithmetic
# tests/test_warp_pallas.py's tolerances, on every entry.
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=0.03, atol=0.05)}
# The adjoint's last row (A-1) sums every clamped row of the tail, up to
# 2 * SMAX + 1 terms; two float32 summation orders differ there by a few
# roundings of the terms' magnitude.  That row alone gets an absolute floor
# of TAIL_RTOL times the sum of its terms' absolute values.
TAIL_RTOL = 1e-5


def log(msg):
    print(msg, flush=True)


def time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def warp_inputs(torch, n, a, v, l, dtype, seed, smax=SMAX):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    src = torch.randn(n, a, l, device="cuda", generator=g).to(dtype)
    # Tent positions in random order over the part of A past the pad.
    pos = smax + torch.rand(n, v, device="cuda", generator=g) * \
        (a - 1 - smax)
    shift = torch.rand(n, l, device="cuda", generator=g) * (2 * smax)
    return src, pos, shift


def ada_positions(torch, n, seed):
    """Both passes' (pos, shift) of the 256 px main path, from the port's
    own ADA draws (the recipe's bgc pipe at p = 0.5) through its
    affine_warp_2pass position math."""
    from style_big_gan_tpu_torch.augment.ada import (AUGPIPE_SPECS,
                                                      AugmentPipe,
                                                      warp_positions)
    pipe = AugmentPipe(**AUGPIPE_SPECS["bgc"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    p = torch.tensor(0.5, device="cuda")
    g_inv = pipe._draw_geom(gen, p, n, 256, 256, "cuda")
    coef, margin = pipe._warp_coef(g_inv, 256, 256)
    size = 2 * (256 + 2 * margin)
    _, q1, sigma, q2, tau = warp_positions(coef, size, 512, 512)
    c = 3
    return {"pass1": (q1.contiguous(),
                      sigma.repeat_interleave(c, dim=1).contiguous()),
            "pass2": (q2.contiguous(),
                      tau.repeat_interleave(c, dim=1).contiguous())}


def warp_bytes(torch, pos, shift, a, esz, bits):
    """(forward bytes, adjoint bytes) that these inputs need, each input
    element read once and each output written once: the source rows
    min(i0 + k + idx, A-1), k = 0..2, that carry a non-zero weight, per
    (image, lane), or the rows of g whose tent row is non-zero; the
    output; pos and shift (f32)."""
    n, v = pos.shape
    l = shift.shape[1]
    p = pos.clamp(0.0, float(a - 1))
    fl = torch.floor(p)
    i0 = fl.long()
    w0 = (1.0 - (p - fl).abs()).clamp_min(0.0)
    w1 = torch.where(i0 + 1 <= a - 1,
                     (1.0 - (p - fl - 1.0).abs()).clamp_min(0.0),
                     torch.zeros_like(p))
    sfl = torch.floor(shift)
    idx = sfl.long() & ((1 << bits) - 1)
    frac = shift - sfl
    touched = 0
    for b in range(n):          # per image: [V, L] index planes
        used = torch.zeros(a + 1, l, dtype=torch.bool, device=pos.device)
        nz_f = (frac[b] != 0)[None, :]
        for k, nz in ((0, (w0[b] != 0)[:, None].expand(v, l)),
                      (1, ((w0[b] != 0)[:, None] & nz_f)
                       | (w1[b] != 0)[:, None]),
                      (2, (w1[b] != 0)[:, None] & nz_f)):
            rows = (i0[b][:, None] + k + idx[b][None, :]).clamp(max=a - 1)
            used.scatter_(0, torch.where(nz, rows, a), True)
        touched += int(used[:a].sum())
    g_rows = int(((w0 != 0) | (w1 != 0)).sum())
    small = (pos.numel() + shift.numel()) * 4
    fwd = (touched + n * v * l) * esz + small
    adj = (g_rows * l + n * a * l) * esz + small
    return fwd, adj


def check_close(torch, name, got, want, dtype_name, tail_abs_sum=None):
    """Every entry within atol + rtol * |want|.  ``tail_abs_sum`` [n, L]
    (the adjoint in float32) raises row A-1's atol to TAIL_RTOL times the
    sum of that row's absolute terms."""
    tol = TOL[dtype_name]
    got32, want32 = got.float(), want.float()
    if not float(want32.abs().max()) > 0:
        raise AssertionError(f"{name}: the plain version is all zeros, so "
                             "the check would prove nothing")
    err = (got32 - want32).abs()
    max_abs = float(err.max())
    max_rel = max_abs / max(float(want32.abs().max()), 1e-30)
    limit = tol["atol"] + tol["rtol"] * want32.abs()
    note = ""
    if tail_abs_sum is not None:
        floor = TAIL_RTOL * tail_abs_sum.float()
        limit[:, -1, :] = torch.maximum(limit[:, -1, :], floor)
        note = (f"; row A-1 floor {TAIL_RTOL} x sum|terms|, at most "
                f"{float(floor.max()):.3g}, its max_abs_err "
                f"{float(err[:, -1, :].max()):.3e}, other rows' "
                f"{float(err[:, :-1, :].max()):.3e}")
    ok = bool((err <= limit).all())
    log(f"  {name}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
        f"(rtol {tol['rtol']}, atol {tol['atol']}{note}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_abs


def edge_positions(torch, case, n, a, v):
    """Tent positions [n, v] of one edge case of tests/test_torch_warp.py."""
    ramp = torch.arange(v, dtype=torch.float32, device="cuda")
    if case == "ends":                 # exactly 0 and A-1 (no column A)
        pos = torch.where(ramp % 2 == 0, 0.0, a - 1.0)
    elif case == "clamped":            # below 0 and above A-1
        pos = torch.linspace(-3.0 * a, 4.0 * a, v, device="cuda")
    elif case == "nonmonotone":
        g = torch.Generator(device="cuda")
        g.manual_seed(5)
        pos = torch.linspace(0.5, a - 1.5, v, device="cuda")[
            torch.randperm(v, device="cuda", generator=g)]
    elif case == "many_per_row":       # |slope| << 1
        pos = a / 3 + 0.07 * ramp
    else:                              # skips_rows: |slope| > 2
        pos = 0.3 + (a - 1.0) / (v - 1) * ramp
    return pos.expand(n, v).contiguous()


def check_pair(torch, warp, label, src, g, pos, shift, bits, dtype_name):
    """Both kernels against their plain versions; returns their errors."""
    a = src.shape[1]
    errs = {}
    for kname, kfn, pfn, x, extra in (
            ("warp_pass_fwd", warp.warp_pass_fwd, warp.warp_pass_plain, src,
             ()),
            ("warp_pass_adjoint", warp.warp_pass_adjoint,
             warp.warp_pass_adjoint_plain, g, (a,))):
        got = kfn(x, pos, shift, bits, *extra)
        torch.cuda.synchronize()
        want = pfn(x, pos, shift, bits, *extra)
        tail = None
        if kname == "warp_pass_adjoint" and dtype_name == "float32":
            tail = warp.warp_pass_adjoint_plain(
                x.abs(), pos, shift, bits, a)[:, -1, :]
        errs[kname] = check_close(torch, f"{kname} {label} {dtype_name}",
                                  got, want, dtype_name, tail)
        del got, want, tail
    return errs


def phase_kernels(torch, warp):
    log("[kernels] building csrc/warp_pass.cu (nvcc, sm_90a)")
    t0 = time.time()
    warp.build(verbose=True)
    log(f"[kernels] build {time.time() - t0:.1f} s")
    n = 2 * BATCH
    ada = ada_positions(torch, n, 3)
    rows = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        for pname, s in PASSES.items():
            a, v, l = s["a"], s["v"], s["l"]
            src, rpos, rshift = warp_inputs(torch, n, a, v, l, dtype, 1)
            g = torch.randn(n, v, l, device="cuda").to(dtype)
            apos, ashift = ada[pname]
            check_pair(torch, warp, f"{pname} n={n} random positions", src,
                       g, rpos, rshift, BITS, dtype_name)
            errs = check_pair(torch, warp, f"{pname} n={n} ADA p=0.5", src,
                              g, apos, ashift, BITS, dtype_name)
            # Adjoint identity <fwd(x), g> == <x, adj(g)> on the card.
            if dtype_name == "float32":
                lhs = float((warp.warp_pass_fwd(src, rpos, rshift, BITS)
                             .double() * g.double()).sum())
                rhs = float((src.double() * warp.warp_pass_adjoint(
                    g, rpos, rshift, BITS, a).double()).sum())
                rel = abs(lhs - rhs) / max(abs(lhs), 1e-30)
                log(f"  adjoint identity {pname}: rel diff {rel:.3e} "
                    f"(tol 1e-4)")
                if not rel < 1e-4:
                    raise AssertionError("adjoint identity fails")
            for label, pos, shift in (("random", rpos, rshift),
                                      ("ADA", apos, ashift)):
                once = warp.warp_pass_adjoint(g, pos, shift, BITS, a)
                again = warp.warp_pass_adjoint(g, pos, shift, BITS, a)
                if not torch.equal(once, again):
                    raise AssertionError(f"adjoint {pname} {label} "
                                         f"{dtype_name}: two runs differ")
                del once, again
            log(f"  adjoint {pname} {dtype_name}: two runs bitwise equal "
                "(random and ADA positions)")

            esz = src.element_size()
            small = (apos.numel() + ashift.numel()) * 4
            full = (n * a * l + n * v * l) * esz + small
            touched = dict(zip(("warp_pass_fwd", "warp_pass_adjoint"),
                               warp_bytes(torch, apos, ashift, a, esz, BITS)))
            flops = {"warp_pass_fwd": 10.0 * n * v * l,
                     "warp_pass_adjoint": 4.0 * n * v * l + 4.0 * n * a * l}
            for kname, kfn, pfn, x, extra in (
                    ("warp_pass_fwd", warp.warp_pass_fwd,
                     warp.warp_pass_plain, src, ()),
                    ("warp_pass_adjoint", warp.warp_pass_adjoint,
                     warp.warp_pass_adjoint_plain, g, (a,))):
                ms = time_ms(torch, lambda: kfn(x, apos, ashift, BITS,
                                                *extra))
                plain_ms = time_ms(torch, lambda: pfn(x, apos, ashift, BITS,
                                                      *extra),
                                   iters=3, warmup=1)
                bytes_ms = touched[kname] / HBM_BYTES_PER_S * 1e3
                ops_ms = flops[kname] / F32_FLOPS * 1e3
                bound_ms = max(bytes_ms, ops_ms)
                bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
                full_ms = full / HBM_BYTES_PER_S * 1e3
                log(f"  {kname} {pname} {dtype_name} (ADA p=0.5 positions): "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                    f"{bound_ms:.4f} ms ({bound_by}; touched "
                    f"{touched[kname] / 1e6:.1f} MB, "
                    f"{100 * bound_ms / ms:.1f} % of it), full-read bound "
                    f"{full_ms:.4f} ms ({full / 1e6:.1f} MB), "
                    f"{flops[kname] / 1e9:.2f} GFLOP f32")
                rows[(kname, pname, dtype_name)] = dict(
                    max_abs_err=errs[kname], ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by)
            del src, g, rpos, rshift
            torch.cuda.empty_cache()

    # Edge cases of the tent positions at the pass-1 shape, n = 4.
    a, v, l = PASSES["pass1"]["a"], PASSES["pass1"]["v"], PASSES["pass1"]["l"]
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        src, _, shift = warp_inputs(torch, 4, a, v, l, dtype, 6)
        g = torch.randn(4, v, l, device="cuda").to(dtype)
        for case in ("ends", "clamped", "nonmonotone", "many_per_row",
                     "skips_rows"):
            pos = edge_positions(torch, case, 4, a, v)
            check_pair(torch, warp, f"pass1 n=4 {case}", src, g, pos, shift,
                       BITS, dtype_name)
            once = warp.warp_pass_adjoint(g, pos, shift, BITS, a)
            if not torch.equal(once, warp.warp_pass_adjoint(g, pos, shift,
                                                             BITS, a)):
                raise AssertionError(f"adjoint {case} {dtype_name}: two "
                                     "runs differ")
        del src, g, shift
    torch.cuda.empty_cache()

    s5 = SHAPE_512
    src, pos, shift = warp_inputs(torch, s5["n"], s5["a"], s5["v"], s5["l"],
                                  torch.bfloat16, 2, smax=s5["smax"])
    g = torch.randn(s5["n"], s5["v"], s5["l"], device="cuda").to(
        torch.bfloat16)
    check_pair(torch, warp, f"512px pass1 n={s5['n']}", src, g, pos, shift,
               s5["bits"], "bfloat16")
    for kname, kfn, x, extra in (
            ("warp_pass_fwd", warp.warp_pass_fwd, src, ()),
            ("warp_pass_adjoint", warp.warp_pass_adjoint, g, (s5["a"],))):
        ms = time_ms(torch, lambda: kfn(x, pos, shift, s5["bits"], *extra),
                     iters=5)
        log(f"  {kname} 512px pass1 bfloat16 (random positions): kernel "
            f"{ms:.4f} ms")
    del src, pos, shift, g
    torch.cuda.empty_cache()

    # Grad-of-grad through the autograd pair (R1's double backward) against
    # autograd through the plain version.
    # Shifts below 14 (bits 4); tent rows at positions 14..39, so the
    # clamped tail carries weight.
    src, pos, shift = warp_inputs(torch, 2, 40, 24, 136, torch.float32, 4,
                                  smax=14)
    shift = shift.remainder(14.0)

    def gg(fn):
        s = src.clone().requires_grad_(True)
        (g1,) = torch.autograd.grad((fn(s, pos, shift, 4) ** 2).sum(), s,
                                    create_graph=True)
        (g2,) = torch.autograd.grad((g1 ** 2).sum(), s)
        return g2

    check_close(torch, "grad-of-grad WarpPass vs plain autograd",
                gg(warp.warp_pass), gg(warp.warp_pass_plain), "float32")
    return rows


def phase_glue(torch):
    """Times the copies around the two kernel launches of one warp at the
    256 px main path (n = 64, bf16): the swap select, each pass's edge-pad
    (pass 2's reads pass 1's output transposed) and the shift's
    repeat_interleave."""
    from style_big_gan_tpu_torch.augment.ada import _edge_pad_front
    n, side, out_side = 2 * BATCH, 816, 512
    up = torch.randn(n, side, side, 3, device="cuda").to(torch.bfloat16)
    tmp = torch.randn(n, out_side, side, 3, device="cuda").to(torch.bfloat16)
    swap = torch.arange(n, device="cuda") % 2 == 0
    sigma = torch.rand(n, side, device="cuda") * 2 * SMAX
    parts = {
        "swap select": lambda: torch.where(swap[:, None, None, None],
                                           up.transpose(1, 2), up),
        "pass-1 edge pad": lambda: _edge_pad_front(up, SMAX, 1),
        "pass-2 transpose + edge pad": lambda: _edge_pad_front(
            tmp.transpose(1, 2), SMAX, 1),
        "pass-1 shift repeat_interleave": lambda: sigma.repeat_interleave(
            3, dim=1).contiguous(),
    }
    for name, fn in parts.items():
        log(f"[glue] {name}: {time_ms(torch, fn):.4f} ms")


def run_trainer(torch, out_dir, batches, extra):
    from style_big_gan_tpu_torch import registries
    from style_big_gan_tpu_torch.arguments import load_config

    cfg = load_config(argv=[
        "exp.name=chip_smoke", "data.dataset=seeded_random",
        "data.dataset_path=in_memory", "perf.device=cuda",
        f"gen.batch={BATCH}", f"gen.kimg={batches * BATCH / 1000}",
        f"log.kimg_per_tick={TICK_BATCHES * BATCH / 1000}",
        f"log.output={out_dir}", *extra],
        yaml_path=os.path.join(ROOT, "configs", "ffhq256_sg2ada.yaml"))
    trainer = registries.trainers[str(cfg.exp.trainer)]()
    trainer.run(cfg)
    with open(os.path.join(trainer.run_dir, "stats.jsonl")) as f:
        ticks = [json.loads(line) for line in f]
    for t in ticks:
        for k, v in t.items():
            if k.startswith("Loss/") and not math.isfinite(v):
                raise AssertionError(f"non-finite {k} = {v}")
    return trainer, ticks


def phase_main_path(torch, warp):
    out_dir = os.path.join(ROOT, "build", "chip_smoke_runs")
    shutil.rmtree(out_dir, ignore_errors=True)

    torch.cuda.reset_peak_memory_stats()
    warp.reset_launch_counts()
    t0 = time.time()
    trainer, ticks = run_trainer(torch, out_dir, MAIN_BATCHES, [])
    wall = time.time() - t0
    launches = dict(warp.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    counts = trainer.phase_counts
    for ph in ("Dmain", "Dreg", "Gmain", "Greg"):
        if not counts.get(ph):
            raise AssertionError(f"phase {ph} never ran: {counts}")
    seen = set().union(*ticks)
    for key in ("Loss/D/loss", "Loss/G/loss", "Loss/D/r1reg", "Loss/G/reg"):
        if key not in seen:
            raise AssertionError(f"{key} missing from stats.jsonl")
    final_p = ticks[-1]["Progress/augment"]
    if trainer.ada_adjustments < 1:
        raise AssertionError("ADA never adjusted p")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} never launched on the main "
                                 "path")
    steady = ticks[1:]
    sec_per_kimg = sum(t["Timing/sec_per_kimg"] for t in steady) / \
        len(steady)
    log(f"[main] SG2Trainer ffhq256_sg2ada full width, batch {BATCH}, "
        f"{trainer.batches_done} batches in {wall:.1f} s (setup included)")
    log(f"[main] imgs/s {1000.0 / sec_per_kimg:.2f} (ticks 1-{len(ticks) - 1},"
        f" {TICK_BATCHES} batches each; includes Greg every 4 batches, "
        f"excludes the one Dreg of tick 0); ADA adjusted p "
        f"{trainer.ada_adjustments} times, final p {final_p:.6f}")
    for ph, secs in trainer.phase_seconds.items():
        log(f"[main] phase {ph}: {counts[ph]} runs, "
            f"{secs / counts[ph]:.3f} s each")
    log(f"[main] peak device memory {peak_gib:.2f} GiB")
    per_iter = {k: v / trainer.batches_done for k, v in launches.items()}
    log(f"[main] launches {launches}, per iteration "
        f"{json.dumps(per_iter)}")
    log(f"[main] last tick: G/loss {ticks[-1]['Loss/G/loss']:.4f} "
        f"D/loss {ticks[-1]['Loss/D/loss']:.4f}")

    # The trained G_ema on the card agrees with its CPU copy (f32 path).
    G = trainer.G_ema
    z = torch.randn(2, G.z_dim, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        img_gpu = G(z.cuda(), noise_mode="const", force_fp32=True).cpu()
        img_cpu = G.cpu()(z, noise_mode="const", force_fp32=True)
    if tuple(img_gpu.shape) != (2, 3, 256, 256) or \
            not bool(torch.isfinite(img_gpu).all()):
        raise AssertionError(f"bad G_ema output {tuple(img_gpu.shape)}")
    diff = float((img_gpu - img_cpu).abs().max())
    log(f"[main] G_ema 256px f32 card vs CPU: max abs diff {diff:.3e} "
        "(tol 1e-3)")
    if not diff < 1e-3:
        raise AssertionError("G_ema on the card disagrees with the CPU")
    del trainer, G
    torch.cuda.empty_cache()

    counts_before = dict(warp.LAUNCHES)
    fixed, fticks = run_trainer(torch, out_dir, FIXED_BATCHES,
                                ["aug.aug=fixed", "aug.p=0.5"])
    if warp.LAUNCHES["warp_pass_fwd"] <= counts_before["warp_pass_fwd"]:
        raise AssertionError("aug=fixed run did not launch the kernels")
    log(f"[main] aug=fixed p=0.5: {fixed.batches_done} batches, G/loss "
        f"{fticks[-1]['Loss/G/loss']:.4f} D/loss "
        f"{fticks[-1]['Loss/D/loss']:.4f}")
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from style_big_gan_tpu_torch.ops import warp
        from style_big_gan_tpu_torch.utils.misc import \
            gpu_name_and_power_limit
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name_and_power_limit()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"[env] cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
        f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    log(f"[env] nvidia-smi name,power.limit: {smi}")

    rows = phase_kernels(torch, warp)
    phase_glue(torch)
    launches = phase_main_path(torch, warp)

    replaces = {"warp_pass_fwd":
                "style_big_gan_tpu/ops/warp_pallas.py:67",
                "warp_pass_adjoint":
                "style_big_gan_tpu/ops/warp_pallas.py:84"}
    kernels = []
    for kname in ("warp_pass_fwd", "warp_pass_adjoint"):
        r = rows[(kname, "pass1", "bfloat16")]
        kernels.append(dict(
            name=kname, route="cuda",
            source="style_big_gan_tpu_torch/csrc/warp_pass.cu",
            replaces=replaces[kname], launches=launches[kname],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
