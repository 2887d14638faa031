"""The shape-only FLOP count against torch's FlopCounterMode over the
frozen reference's forward passes, at a tiny width on the CPU.  The FIR
filters are not model FLOPs: they run through a stand-in of the same
shapes that multiplies nothing."""

import copy

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from gpubench import harness
from gpubench.flops import stylegan2 as flops
from gpubench.reference import conv2d_resample as cr_mod
from gpubench.reference import stylegan2 as sg2
from gpubench.reference import upfirdn2d as fir_mod


def _no_fir(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1):
    """upfirdn2d's output shape, by repeat, pad and slicing alone."""
    upx, upy = (up, up) if isinstance(up, int) else up
    dx, dy = (down, down) if isinstance(down, int) else down
    px0, px1, py0, py1 = fir_mod._parse_padding(padding)
    fh, fw = fir_mod._filter_taps(f)
    if upx > 1 or upy > 1:
        x = x.repeat_interleave(upy, dim=2).repeat_interleave(upx, dim=3)
    x = F.pad(x, [px0, px1, py0, py1])
    return x[:, :, :x.shape[2] - fh + 1:dy, :x.shape[3] - fw + 1:dx]


@pytest.fixture
def counted(monkeypatch):
    monkeypatch.setattr(fir_mod, "upfirdn2d", _no_fir)
    monkeypatch.setattr(cr_mod, "upfirdn2d", _no_fir)

    def count(fn):
        with FlopCounterMode(display=False) as fc:
            fn()
        return fc.get_total_flops()
    return count


def _tiny(name):
    c = copy.deepcopy(harness.config_of(name))
    c["resolution"] = 32
    for k in ("generator", "discriminator"):
        c[k]["channel_base"] = 256
        c[k]["channel_max"] = 64
    c["generator"].update(z_dim=16, w_dim=24)
    return c


@pytest.mark.parametrize("name", ["ffhq256_sg2ada", "sg2ada"])
def test_forward_counts_match_flop_counter(name, counted):
    c = _tiny(name)
    n, cdim = 4, int(c["label_dim"])
    common = dict(c_dim=cdim, img_resolution=c["resolution"],
                  img_channels=c["img_channels"])
    torch.manual_seed(0)
    G = sg2.Generator(**common, **c["generator"])
    D = sg2.Discriminator(**common, **c["discriminator"])
    z = torch.randn(n, c["generator"]["z_dim"])
    lab = torch.eye(max(cdim, 1))[:n, :cdim]
    with torch.no_grad():
        got_g = counted(lambda: G(z, lab))
        img = G(z, lab).float()
        got_d = counted(lambda: D(img, lab))
    g, d = c["generator"], c["discriminator"]
    mk = g["mapping_kwargs"]
    want_g = sum(flops.mapping_forward(
        g["z_dim"], cdim, g["w_dim"], mk["num_layers"]).values()) + \
        sum(flops.synthesis_forward(g, c["resolution"], 3).values())
    want_d = sum(flops.discriminator_forward(d, c["resolution"], 3,
                                             cdim).values())
    assert got_g == pytest.approx(n * want_g, rel=1e-9)
    assert got_d == pytest.approx(n * want_d, rel=1e-9)


def test_precision_split_follows_num_fp16_res():
    c = harness.config_of("ffhq256_sg2ada")
    g = flops.synthesis_forward(c["generator"], 256, 3)
    assert g["bf16"] > 10 * g["f32"]
    # cifar at 32 px: bf16 from 8 px, the 4 px block in float32
    g = flops.synthesis_forward(harness.config_of("sg2ada")["generator"],
                                32, 3)
    assert g["bf16"] > 10 * g["f32"] > 0


def test_period_counts_each_phase_at_its_interval():
    c = harness.config_of("ffhq256_sg2ada")
    total, per = flops.period_flops(c, 16)
    one, _ = flops.period_flops(c, 4)
    assert set(per) == {"Dmain", "Gmain", "Dreg", "Greg"}
    d_fwd = sum(flops.discriminator_forward(c["discriminator"], 256, 3,
                                            0).values())
    assert sum(per["Dreg"].values()) == pytest.approx(6 * 64 * d_fwd)
    # 16 batches hold one R1 and four PPL; 4 hold no R1 and one PPL.
    assert sum(total.values()) == pytest.approx(
        4 * sum(one.values()) + sum(per["Dreg"].values()))
