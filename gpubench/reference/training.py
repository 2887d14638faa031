"""The plain reference of a StyleGAN2-ADA training run's first iterations.

It computes what the trainer of the recipe computes in its first
dispatch windows: the first from the seed alone, each later one from the
state the trainer had at its start, where one is given (``State``: the
modules' weights and buffers, Adam's moments and step counts, the training
generator's state and PPL's running mean); without one it goes on from its
own.  From the seed it takes the same seeded weights (built
as the trainer builds them: ``torch.manual_seed(seed)``, G, D, then G_ema a
copy of G), the same data (the images and labels of ``datagen`` in the
order of the loader's windowed reshuffle, mirrored views for ``mirror``,
the generator's labels drawn per window), the same draws from one training
``torch.Generator`` in the same order (latents, style mixing, noise, the
ADA pipe where the traffic names one, PPL's image-space noise), and per
window the phases in the trainer's order: Dmain then Gmain for each of its
k batches, then every R1 due in the window, then every PPL due, each on its
own batch.  Every layer is a frozen plain copy (this folder); the warp of
the ADA pipe is its plain PyTorch form, aten's autograd differentiates
every convolution (PPL's bfloat16 ones twice in float32, conv.py), and
Adam and the EMA are written out here.

Each lazy regularizer call (R1, PPL) starts from the state the trainer
had just before it, where one is given, so that it is judged on its own:
the window's Dmain and Gmain phases are judged from the window's start to
that point.

What it returns (``Readings``): each phase's loss statistic in order with
its window, the first gradient each optimizer received (a norm per
parameter), the change of every parameter of G, D and G_ema over each
window's Dmain and Gmain phases (a norm per parameter), and for each
regularizer call its penalty and the gradient its optimizer received (a
norm per parameter).
``lower_precision`` runs the whole of it one precision step down
(precision.py): the control.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gpubench import datagen
from gpubench.reference import conv
from gpubench.reference.ada import AUGPIPE_SPECS, AugmentPipe
from gpubench.reference.precision import lower_precision
from gpubench.reference.state import Readings, State
from gpubench.reference.stylegan2 import Discriminator, Generator


def infinite_sampler(n: int, seed: int, window_size: float = 0.5
                     ) -> Iterator[int]:
    """The windowed-reshuffle index stream of the program's loader (a copy
    of style_big_gan_tpu_torch/data/dataloader.py::infinite_sampler)."""
    order = np.arange(n)
    rnd = np.random.RandomState(seed)
    rnd.shuffle(order)
    window = int(np.rint(order.size * window_size))
    idx = 0
    while True:
        i = idx % order.size
        yield int(order[i])
        if window >= 2:
            j = (i - rnd.randint(window)) % order.size
            order[i], order[j] = order[j], order[i]
        idx += 1


class Data:
    """The cell's dataset as the recipe's ``image_folder`` sees it: images
    in name order, doubled by mirrored views under ``mirror``, one-hot
    labels."""

    def __init__(self, config: dict, traffic: dict, data_seed: int):
        n = int(traffic["dataset_images"])
        self.images = datagen.images(data_seed, n, int(config["resolution"]))
        self.label_dim = int(config["label_dim"])
        self.labels = datagen.labels(data_seed, n, self.label_dim)
        self.mirror = bool(config["mirror"])
        self.raw = n

    def __len__(self) -> int:
        return self.raw * (2 if self.mirror else 1)

    def image(self, idx: int) -> np.ndarray:
        img = self.images[idx % self.raw]
        return img[:, ::-1] if idx >= self.raw else img

    def label(self, idx: int) -> np.ndarray:
        out = np.zeros(self.label_dim, np.float32)
        if self.label_dim:
            out[int(self.labels[idx % self.raw])] = 1.0
        return out


def gen_labels(data: Data, seed: int, batch_idx: int, k: int,
               batch: int) -> np.ndarray:
    """The generator's labels of the k batches of the window from
    ``batch_idx`` ([k, batch, label_dim]): one stream seeded at the
    window's first batch, draws of dataset positions."""
    if data.label_dim == 0:
        return np.zeros((k, batch, 0), np.float32)
    rnd = np.random.RandomState((seed * 1000003 + batch_idx) % (2 ** 31 - 1))
    idx = rnd.randint(len(data), size=k * batch)
    return np.stack([data.label(int(i)) for i in idx]).reshape(
        k, batch, data.label_dim)


class Adam:
    """torch.optim.Adam's update, written out: m <- b1 m + (1 - b1) g,
    v <- b2 v + (1 - b2) g^2, p <- p - lr / (1 - b1^t) * m /
    (sqrt(v) / sqrt(1 - b2^t) + eps)."""

    def __init__(self, params, lr: float, betas, eps: float):
        self.params = list(params)
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.t = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = math.sqrt(1.0 - self.b2 ** self.t)
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.addcdiv_(m, v.sqrt().div_(c2).add_(self.eps),
                       value=-self.lr / c1)


class Follower:
    """The reference trainer (see the module docstring)."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 data_seed: int, device: torch.device):
        c = config
        self.c, self.seed, self.dev = c, int(seed), device
        self.batch, self.k = int(c["batch"]), int(c["steps_per_dispatch"])
        self.rounds = self.batch // int(c["batch_device"])
        self.data = Data(c, traffic, data_seed)
        self.sampler = infinite_sampler(len(self.data), self.seed)
        common = dict(c_dim=int(c["label_dim"]),
                      img_resolution=int(c["resolution"]),
                      img_channels=int(c["img_channels"]))
        torch.manual_seed(self.seed)
        np.random.seed(self.seed)
        self.G = Generator(**common, **c["generator"]).to(device)
        self.D = Discriminator(**common, **c["discriminator"]).to(device)
        self.G_ema = copy.deepcopy(self.G).eval().requires_grad_(False)
        # no pipe, and no draw for one, where the traffic has none (the
        # program's aug=noaug)
        self.pipe = None if traffic["augpipe"] is None else \
            AugmentPipe(**AUGPIPE_SPECS[traffic["augpipe"]])
        self.p = torch.tensor(float(traffic["p"]), device=device)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(self.seed)
        regs = c["regularizers"]
        self.r1 = regs.get("r1")
        self.ppl = regs.get("ppl")
        self.pl_mean = torch.zeros((), device=device)
        ad = c["adam"]

        def adam(module, interval):
            ratio = interval / (interval + 1) if interval else 1.0
            return Adam(module.parameters(), ad["lr"] * ratio,
                        (ad["betas"][0] ** ratio, ad["betas"][1] ** ratio),
                        ad["eps"])
        self.opt_d = adam(self.D, self.r1["interval"] if self.r1 else 0)
        self.opt_g = adam(self.G, self.ppl["interval"] if self.ppl else 0)
        self.out = Readings()
        self.window_index = 0

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"G": self.G, "D": self.D, "G_ema": self.G_ema}

    # ------------------------------------------------------------- data

    def window_batches(self, batch_idx: int):
        d, k, n = self.data, self.k, self.batch
        idx = [next(self.sampler) for _ in range(k * n)]
        u8 = np.stack([d.image(i) for i in idx]).reshape(
            (k, n) + d.images.shape[1:])
        real = torch.from_numpy(np.ascontiguousarray(u8)).to(self.dev)
        real = real.movedim(-1, -3).float().div_(127.5).sub_(1.0)
        real_c = np.stack([d.label(i) for i in idx]).reshape(
            k, n, d.label_dim)
        gen_c = gen_labels(d, self.seed, batch_idx, k, n)
        return (real, torch.from_numpy(real_c).to(self.dev),
                torch.from_numpy(gen_c).to(self.dev))

    # ------------------------------------------------------------ model

    def mixed_ws(self, z, c, update_emas: bool = False):
        ws = self.G.map_ws(z, c, update_emas=update_emas)
        prob = float(self.c["style_mixing_prob"])
        if prob > 0:
            num_ws = ws.shape[1]
            z2 = torch.randn(z.shape, device=z.device, generator=self.gen)
            ws2 = self.G.map_ws(z2, c, skip_w_avg_update=True)
            cutoff = torch.randint(1, num_ws, (), device=z.device,
                                   generator=self.gen)
            mixing = torch.rand((), device=z.device,
                                generator=self.gen) < prob
            mask = (torch.arange(num_ws, device=z.device) >= cutoff) & mixing
            ws = torch.where(mask[None, :, None], ws2, ws)
        return ws

    def run_G(self, z, c, update_emas: bool = False):
        return self.G.synthesize(self.mixed_ws(z, c, update_emas),
                                 generator=self.gen)

    def run_D(self, img, c):
        if self.pipe is not None:
            img = self.pipe(img, self.gen, self.p)
        return self.D(img, c)

    # ----------------------------------------------------------- phases

    def _z(self, n: int):
        return torch.randn((n, int(self.c["generator"]["z_dim"])),
                           device=self.dev, generator=self.gen)

    def _rounds(self, module, loss_fn, args) -> Dict[str, float]:
        """backward() of loss_fn over the accumulation rounds, each from
        the module's buffers as the phase found them; stats averaged."""
        r = self.rounds
        saved = [(b, b.detach().clone()) for b in module.buffers()]
        stats: Dict[str, torch.Tensor] = {}
        for i in range(r):
            if i:
                with torch.no_grad():
                    for b, v in saved:
                        b.copy_(v)
            loss, st = loss_fn(*[a.chunk(r)[i] if torch.is_tensor(a) else a
                                 for a in args])
            (loss / r).backward()
            for k, v in st.items():
                stats[k] = stats.get(k, 0.0) + v.detach() / r
        return stats

    def _update(self, module, opt, key: str) -> Dict[str, float]:
        """The optimizer's step; returns the norm of each parameter's
        gradient as the optimizer got it."""
        for p in module.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            p.grad.nan_to_num_(nan=0.0, posinf=1e5, neginf=-1e5)
        norms = {n: float(p.grad.norm()) for n, p in module.named_parameters()}
        self.out.grad1.setdefault(key, norms)
        opt.step()
        for p in module.parameters():
            p.grad = None
        return norms

    def _record_reg(self, phase: str, call: int, stats, key: str,
                    norms: Dict[str, float]) -> None:
        self.out.regs.append((phase, self.window_index, call,
                              float(stats[key]), norms))

    def _record(self, stats, key: str, index: int) -> None:
        self.out.losses.append((key, self.window_index, index,
                                float(stats[key])))

    def d_main(self, z, real, rc, gc):
        with torch.no_grad():
            fake = self.run_G(z, gc)
        half = int(fake.shape[0])
        gs = int(self.c["discriminator"]["epilogue_kwargs"]
                 ["mbstd_group_size"])
        if gs <= half and half % gs == 0:
            m = half // gs

            def ilv(a, b):
                if a.numel() == 0:
                    return torch.cat([a, b], dim=0)
                ab = torch.cat([a.reshape(-1, m, *a.shape[1:]),
                                b.reshape(-1, m, *b.shape[1:])], dim=1)
                return ab.reshape(2 * half, *a.shape[1:])
            logits = self.run_D(ilv(fake.to(real.dtype), real), ilv(gc, rc))
            lg = logits.reshape(-1, 2 * m, *logits.shape[1:])
            gen_l = lg[:, :m].reshape(half, *logits.shape[1:])
            real_l = lg[:, m:].reshape(half, *logits.shape[1:])
        else:
            gen_l = self.run_D(fake, gc)
            real_l = self.run_D(real, rc)
        loss = F.softplus(-real_l.float()).mean() + \
            F.softplus(gen_l.float()).mean()
        return loss, {"Loss/D/loss": loss}

    def d_step(self, real, rc, gc, index: int):
        z = self._z(gc.shape[0])
        stats = self._rounds(self.D, self.d_main, [z, real, rc, gc])
        self._update(self.D, self.opt_d, "D")
        self._record(stats, "Loss/D/loss", index)

    def g_main(self, z, gc):
        img = self.run_G(z, gc, update_emas=True)
        loss = F.softplus(-self.run_D(img, gc).float()).mean()
        return loss, {"Loss/G/loss": loss}

    def g_step(self, gc, beta: torch.Tensor, index: int):
        z = self._z(gc.shape[0])
        self.D.requires_grad_(False)
        stats = self._rounds(self.G, self.g_main, [z, gc])
        self.D.requires_grad_(True)
        self._update(self.G, self.opt_g, "G")
        with torch.no_grad():
            for pe, p in zip(self.G_ema.parameters(), self.G.parameters()):
                pe.copy_(p.lerp(pe, beta))
            for be, b in zip(self.G_ema.buffers(), self.G.buffers()):
                be.copy_(b)
        self._record(stats, "Loss/G/loss", index)

    def r1_loss(self, real, rc):
        real = real.detach().float().requires_grad_(True)
        logits = self.run_D(real, rc)
        (grads,) = torch.autograd.grad(logits.float().sum(), real,
                                       create_graph=True)
        pen = grads.square().sum(dim=(1, 2, 3))
        loss = pen.mean() * (float(self.r1["r1_gamma"]) / 2.0)
        return loss * float(self.r1["interval"]), \
            {"Loss/r1_penalty": pen.mean()}

    def d_reg_step(self, real, rc, call: int):
        stats = self._rounds(self.D, self.r1_loss, [real, rc])
        norms = self._update(self.D, self.opt_d, "D")
        self._record_reg("Dreg", call, stats, "Loss/r1_penalty", norms)

    def ppl_loss(self, z, gc, new_mean: List[torch.Tensor]):
        pl = self.ppl
        rows = max(1, int(z.shape[0] // float(pl["pl_batch_shrink"])))
        z, c = z[:rows], gc[:rows]
        # bfloat16 convolutions differentiated twice in float32 (conv.py)
        with conv.float32_operands():
            ws = self.mixed_ws(z, c)
            img = self.G.synthesize(ws, generator=self.gen).float()
            h, w = img.shape[2], img.shape[3]
            noise = torch.randn(img.shape, device=img.device,
                                generator=self.gen) / np.sqrt(h * w)
            (g,) = torch.autograd.grad((img * noise).sum(), ws,
                                       create_graph=True)
        lengths = g.float().square().sum(dim=2).mean(dim=1).sqrt()
        old = self.pl_mean
        mean = (old + float(pl["pl_decay"]) * (lengths.mean() - old)).detach()
        new_mean[:] = [mean]
        pen = (lengths - mean).square()
        loss = pen.mean() * float(pl["pl_weight"])
        return loss * float(pl["interval"]), {"Loss/pl_penalty": pen.mean()}

    def g_reg_step(self, gc, call: int):
        z = self._z(gc.shape[0])
        new_mean: List[torch.Tensor] = []
        self.D.requires_grad_(False)
        stats = self._rounds(self.G, lambda z, c: self.ppl_loss(
            z, c, new_mean), [z, gc])
        self.D.requires_grad_(True)
        norms = self._update(self.G, self.opt_g, "G")
        self.pl_mean = new_mean[0]
        self._record_reg("Greg", call, stats, "Loss/pl_penalty", norms)

    # ----------------------------------------------------------- driver

    def ema_beta(self, cur_nimg: int) -> float:
        ema = self.c["ema"]
        nimg = float(ema["kimg"]) * 1000
        if ema["ramp"] is not None:
            nimg = min(nimg, cur_nimg * float(ema["ramp"]))
        return 0.5 ** (self.batch / max(nimg, 1e-8))

    def window(self, batch_idx: int, p0, states=None, keep=None) -> None:
        """One window from ``batch_idx``; ``p0`` the parameters at its
        start.  Each regularizer call starts from ``states[(phase,
        window, call)]`` where given; ``keep`` receives this follower's own
        state there."""
        real, real_c, gen_c = self.window_batches(batch_idx)
        betas = torch.tensor(
            [self.ema_beta((batch_idx + j) * self.batch)
             for j in range(self.k)], dtype=torch.float32, device=self.dev)
        for j in range(self.k):
            self.d_step(real[j], real_c[j], gen_c[j], j)
            self.g_step(gen_c[j], betas[j], j)
        self.out.change[self.window_index] = {
            name: {n: float((p.detach() - p0[name][n]).norm())
                   for n, p in m.named_parameters()}
            for name, m in self.modules().items()}
        for phase, reg in (("Dreg", self.r1), ("Greg", self.ppl)):
            if not reg:
                continue
            due = [j for j in range(self.k)
                   if (batch_idx + j) % int(reg["interval"]) == 0]
            for call, j in enumerate(due):
                key = (phase, self.window_index, call)
                if keep is not None:
                    keep[key] = self.state()
                if states and key in states:
                    self.load(states[key])
                if phase == "Dreg":
                    self.d_reg_step(real[j], real_c[j], call)
                else:
                    self.g_reg_step(gen_c[j], call)

    def _params(self):
        return {name: {n: p.detach().clone()
                       for n, p in m.named_parameters()}
                for name, m in self.modules().items()}

    def state(self) -> State:
        """This follower's own state, in the form the trainer's is kept."""
        adam = {}
        for key, opt, module in (("G", self.opt_g, self.G),
                                 ("D", self.opt_d, self.D)):
            names = [n for n, _ in module.named_parameters()]
            adam[key] = {n: (m.to("cpu", copy=True),
                             v.to("cpu", copy=True), opt.t)
                         for n, m, v in zip(names, opt.m, opt.v)}
        return State(
            modules={k: {n: t.detach().cpu().clone()
                         for n, t in m.state_dict().items()}
                     for k, m in self.modules().items()},
            adam=adam, generator=self.gen.get_state(),
            pl_mean=float(self.pl_mean))

    @torch.no_grad()
    def load(self, st: State) -> None:
        for k, m in self.modules().items():
            m.load_state_dict(st.modules[k])
        for key, opt, module in (("G", self.opt_g, self.G),
                                 ("D", self.opt_d, self.D)):
            names = [n for n, _ in module.named_parameters()]
            for n, m, v in zip(names, opt.m, opt.v):
                sm, sv, t = st.adam[key][n]
                m.copy_(sm)
                v.copy_(sv)
                opt.t = int(t)
        self.gen.set_state(st.generator)
        self.pl_mean = torch.tensor(float(st.pl_mean), device=self.dev)

    def run(self, windows: int, states: Optional[Dict[tuple, State]] = None,
            lower: bool = False, keep: Optional[Dict[tuple, State]] = None
            ) -> Readings:
        """Windows 0 .. ``windows`` - 1; window w starts from
        ``states[("start", w)]`` and each regularizer call from its own
        key's state (``State``), where given.  ``keep`` receives this
        follower's own state at each of those points after the first."""
        with lower_precision(lower):
            for w in range(windows):
                self.window_index = w
                key = ("start", w)
                if w and keep is not None:
                    keep[key] = self.state()
                if states and key in states:
                    self.load(states[key])
                self.window(w * self.k, self._params(), states, keep)
        return self.out


def follow(config: dict, traffic: dict, seed: int, data_seed: int,
           windows: int, device, states: Optional[Dict[tuple, State]] = None,
           lower: bool = False, keep: Optional[Dict[tuple, State]] = None
           ) -> Readings:
    """The reference's readings of the first ``windows`` windows, each
    after the first, and each regularizer call, from ``states`` where
    given (see the module docstring and ``Follower.run``); float32 with TF32 off where the configuration
    states float32."""
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return Follower(config, traffic, seed, data_seed,
                        torch.device(device)).run(windows, states, lower,
                                                  keep)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
