"""Model FLOPs of a StyleGAN2(-ADA) training period, from the layer shapes
of the configuration alone (never from the program or a profiler), split by
the precision each layer computes in.

What is counted: the multiply-adds of the convolutions (modulated 3x3,
toRGB and fromRGB 1x1, D's 3x3 and its 1x1 residual skips), of the
modulated convolutions' demodulation product (``styles^2 @ sum_k w^2``)
and of the fully connected layers (mapping, affine, D's epilogue and label
mapping), at 2 FLOPs each.  An up-sampling convolution is counted as the
transposed convolution it is, on the input grid; a down-sampling one on
its output grid.  FIR filters, the ADA pipe, bias and activation,
normalisation, minibatch-std, the optimizer and the EMA are not counted,
nor is any recomputation.

A layer is charged at its block's precision: bfloat16 in the blocks at or
above the first of the ``num_fp16_res`` highest resolutions (a synthesis
block's convolutions and toRGB, a D block's fromRGB, convolutions and
skip), float32 elsewhere; the fully connected layers (mapping, affines, D's
epilogue) compute in float32.

A training phase costs a stated multiple of a forward pass (``FACTORS``):
a backward pass that takes input and weight gradients costs 2 forwards, one
that takes input gradients alone (D, frozen, inside Gmain) 1.  R1 and PPL
differentiate a graph of one forward and one input-gradient backward
(2 forwards) with respect to the weights and inputs again (2 x 2), so each
costs 1 + 1 + 4 = 6 forwards of the network it differentiates.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Flops = Dict[str, float]

FACTORS = {
    "Dmain": "G forward (fakes, no gradient) + D forward and backward "
             "(input + weight gradients) over fakes and reals: G 1, D 3 "
             "over 2 x batch",
    "Gmain": "G forward and backward (input + weight), D forward and an "
             "input-gradient backward: G 3, D 2",
    "Dreg": "R1 on the reals: D 6",
    "Greg": "PPL on batch / pl_batch_shrink rows: synthesis 6, mapping 3",
}


def _add(acc: Flops, prec: str, macs: float, times: float = 1.0) -> None:
    acc[prec] = acc.get(prec, 0.0) + 2.0 * macs * times


def _scaled(f: Flops, k: float) -> Flops:
    return {p: v * k for p, v in f.items()}


def _merge(*fs: Flops) -> Flops:
    out: Flops = {}
    for f in fs:
        for p, v in f.items():
            out[p] = out.get(p, 0.0) + v
    return out


def _channels(res: int, base: int, cmax: int) -> int:
    return min(base // res, cmax)


def _fp16_res(img_res: int, num_fp16_res: int) -> int:
    if num_fp16_res <= 0:
        return img_res * 2
    return max(2 ** (int(np.log2(img_res)) + 1 - num_fp16_res), 8)


def mapping_forward(z_dim: int, c_dim: int, w_dim: int, num_layers: int,
                    embed_features=None, layer_features=None) -> Flops:
    """One image through a MappingNetwork (float32)."""
    acc: Flops = {}
    embed = w_dim if embed_features is None else embed_features
    if c_dim == 0:
        embed = 0
    layer = layer_features or w_dim
    if c_dim > 0:
        _add(acc, "f32", c_dim * embed)
    features = z_dim + embed
    for idx in range(num_layers):
        out = w_dim if idx == num_layers - 1 else layer
        _add(acc, "f32", features * out)
        features = out
    return acc


def synthesis_forward(g: dict, img_res: int, img_channels: int) -> Flops:
    """One image through the synthesis network ('skip' architecture)."""
    if g.get("architecture", "skip") != "skip":
        raise ValueError("the count covers the 'skip' synthesis")
    acc: Flops = {}
    base, cmax = int(g["channel_base"]), int(g.get("channel_max", 512))
    w_dim = int(g["w_dim"])
    fp16 = _fp16_res(img_res, int(g.get("num_fp16_res", 0)))
    res = 4
    while res <= img_res:
        prec = "bf16" if res >= fp16 else "f32"
        cout = _channels(res, base, cmax)
        layers = []                       # (cin, macs of the conv)
        if res == 4:
            layers.append((cout, res * res * cout * cout * 9))
        else:
            cin = _channels(res // 2, base, cmax)
            layers.append((cin, (res // 2) ** 2 * cin * cout * 9))
            layers.append((cout, res * res * cout * cout * 9))
        for cin, macs in layers:
            _add(acc, "f32", w_dim * cin)            # affine
            _add(acc, "f32", cin * cout)             # demodulation
            _add(acc, prec, macs)
        _add(acc, "f32", w_dim * cout)               # toRGB affine
        _add(acc, prec, res * res * cout * img_channels)
        res *= 2
    return acc


def discriminator_forward(d: dict, img_res: int, img_channels: int,
                          c_dim: int) -> Flops:
    """One image through D ('resnet' or 'orig' blocks, the epilogue and the
    label mapping)."""
    arch = d.get("architecture", "resnet")
    if arch not in ("resnet", "orig"):
        raise ValueError("the count covers 'resnet' and 'orig' D blocks")
    acc: Flops = {}
    base, cmax = int(d["channel_base"]), int(d.get("channel_max", 512))
    fp16 = _fp16_res(img_res, int(d.get("num_fp16_res", 0)))
    res = img_res
    while res > 4:
        prec = "bf16" if res >= fp16 else "f32"
        tmp = _channels(res, base, cmax)
        out = _channels(res // 2, base, cmax)
        if res == img_res:
            _add(acc, prec, res * res * img_channels * tmp)       # fromRGB
        _add(acc, prec, res * res * tmp * tmp * 9)                # conv0
        _add(acc, prec, (res // 2) ** 2 * tmp * out * 9)          # conv1
        if arch == "resnet":
            _add(acc, prec, (res // 2) ** 2 * tmp * out)          # skip
        res //= 2
    c4 = _channels(4, base, cmax)
    mbstd = 1 if (d.get("epilogue_kwargs") or {}).get(
        "mbstd_num_channels", 1) else 0
    cmap = 0
    if c_dim > 0:
        cmap = int(d.get("cmap_dim") or c4)
        mk = dict(d.get("mapping_kwargs") or {})
        acc = _merge(acc, mapping_forward(
            0, c_dim, cmap, int(mk.get("num_layers", 8)),
            mk.get("embed_features"), mk.get("layer_features")))
    _add(acc, "f32", 16 * (c4 + mbstd) * c4 * 9)    # epilogue conv
    _add(acc, "f32", c4 * 16 * c4)                  # fc
    _add(acc, "f32", c4 * (cmap if cmap else 1))    # out
    return acc


def period_flops(config: dict, batches: int) -> Tuple[Flops, Dict[str, Flops]]:
    """(FLOPs by precision of ``batches`` training batches with every phase
    at its interval, the FLOPs of each phase over those batches)."""
    g, d = config["generator"], config["discriminator"]
    res, ch = int(config["resolution"]), int(config["img_channels"])
    c_dim, batch = int(config["label_dim"]), int(config["batch"])
    mk = dict(g.get("mapping_kwargs") or {})
    mapping = mapping_forward(int(g["z_dim"]), c_dim, int(g["w_dim"]),
                              int(mk.get("num_layers", 8)),
                              mk.get("embed_features"),
                              mk.get("layer_features"))
    # A second mapping call for the style-mixing latent (the sg2 arch
    # makes it whenever style_mixing_prob > 0).
    maps = 2 if float(config["style_mixing_prob"]) > 0 else 1
    synth = synthesis_forward(g, res, ch)
    g_fwd = _merge(_scaled(mapping, maps), synth)
    d_fwd = discriminator_forward(d, res, ch, c_dim)
    phases = {
        "Dmain": _merge(_scaled(g_fwd, batch),
                        _scaled(d_fwd, 3 * 2 * batch)),
        "Gmain": _merge(_scaled(g_fwd, 3 * batch),
                        _scaled(d_fwd, 2 * batch)),
    }
    runs = {"Dmain": batches, "Gmain": batches}
    regs = config["regularizers"]
    if "r1" in regs:
        phases["Dreg"] = _scaled(d_fwd, 6 * batch)
        runs["Dreg"] = batches // int(regs["r1"]["interval"])
    if "ppl" in regs:
        rows = max(1, int(batch // float(regs["ppl"]["pl_batch_shrink"])))
        phases["Greg"] = _merge(_scaled(synth, 6 * rows),
                                _scaled(mapping, 3 * maps * rows))
        runs["Greg"] = batches // int(regs["ppl"]["interval"])
    per = {k: _scaled(v, runs[k]) for k, v in phases.items()}
    return _merge(*per.values()), per
