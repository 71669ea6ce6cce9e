"""Dis-PU training in plain PyTorch: the step's input draw and
augmentation, the PU losses, the PointNet++-MSG patch critic of the GAN
variant (LSGAN, the critic then the generator each batch), and Adam.

Sources: liruihui/Dis-PU ``DisPU/model.py`` (losses, the input draw),
``DisPU/model_gan.py`` and ``Common/pointnet_util.py`` (the critic), with
the benchmarked program's stated conventions: the draws take a
``torch.Generator`` in a fixed order (so the same generator state gives
the same inputs), ties go to the lower index, Adam is optax's
``scale_by_adam`` term for term (b2 0.999, eps 1e-8 outside the root),
the critic's parameters are clipped to ±``d_clip`` after its update.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference import ops
from port_bench.reference.flops import uncounted
from port_bench.reference.generator import dense, generator

ADAM_B2, ADAM_EPS = 0.999, 1e-8


def is_buffer(name: str) -> bool:
    """Running batch-norm statistics: state, not parameters."""
    return name.endswith(".bn.mean") or name.endswith(".bn.var")


# ------------------------------------------------------------------ draws

def draw_inputs(gt, n_in, gen):
    """The Gaussian-biased subsample of each dense patch: ``loc_u`` (b,)
    uniform and Gumbel noise (b, n), then the top ``n_in`` of the
    log-density of N((0.1 + 0.8u)·n, 0.3·n) plus the noise."""
    b, n, _ = gt.shape
    loc_u = torch.rand((b,), generator=gen, device=gt.device)
    u = torch.rand((b, n), generator=gen, device=gt.device)
    noise = -torch.log(-torch.log(torch.clamp_min(
        u, torch.finfo(torch.float32).tiny)))
    loc = loc_u[:, None] * 0.8 + 0.1
    pos = (torch.arange(n, dtype=torch.float32, device=gt.device) + 0.5) / n
    log_density = -((pos - loc) ** 2) / (2.0 * 0.3 ** 2)
    order = torch.sort(log_density + noise, dim=-1, descending=True,
                       stable=True).indices[:, :n_in]
    return ops.take(gt, order)


def rot_z(angle):
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], dim=-2)


def augment(inputs, gt, gen, sigma=0.01, clip=0.03, low=0.8, high=1.2):
    """Jitter (inputs), a shared z rotation and a shared scale."""
    b, dev = inputs.shape[0], inputs.device
    normal = torch.randn(inputs.shape, generator=gen, device=dev)
    angle = torch.rand((b,), generator=gen, device=dev) * 2.0 * math.pi
    scale = torch.rand((b, 1, 1), generator=gen, device=dev) * (high - low) \
        + low
    inputs = inputs + torch.clamp(sigma * normal, -clip, clip)
    rot = rot_z(angle)
    inputs = torch.einsum("bnc,bcd->bnd", inputs, rot)
    gt = torch.einsum("bnc,bcd->bnd", gt, rot)
    return inputs * scale, gt * scale


# ----------------------------------------------------------------- losses

def _relu(x):
    return torch.maximum(x, x.new_zeros(()))


def nn_dists(gt, pred):
    """Each gt point's squared distance to its nearest pred point, and each
    pred point's to its nearest gt point, differentiable at the chosen
    pairs."""
    d1 = torch.sum((gt - ops.take(pred, ops.nearest(gt, pred))) ** 2, -1)
    d2 = torch.sum((pred - ops.take(gt, ops.nearest(pred, gt))) ** 2, -1)
    return d1, d2


def chamfer(pred, gt, radius):
    d1, d2 = nn_dists(gt, pred)
    return torch.mean((torch.mean(d1, 1) + torch.mean(d2, 1)) / radius)


def hausdorff(pred, gt, radius):
    d1, d2 = nn_dists(gt, pred)
    return torch.amax((torch.amax(d1, 1) + torch.amax(d2, 1)) / radius)


def repulsion(pred, nsample=20, radius=0.07, h=0.001):
    """The 5 nearest of the ball's first ``nsample`` members, self dropped:
    ``mean(max(0, h − d²))``."""
    idx5 = ops.ball_query(radius, nsample, pred, pred, select_smallest=5)
    d5 = torch.sum((ops.group(pred, idx5) - pred[:, :, None, :]) ** 2, -1)
    return torch.mean(_relu(h + (-d5[:, :, 1:])))


def uniform(pcd, percentages=(0.004, 0.006, 0.008, 0.010, 0.012)):
    """The NN-spacing uniformity statistic inside disks around 5% FPS
    seeds (PU-GAN's uniform loss)."""
    _, n, _ = pcd.shape
    npoint = int(n * 0.05)
    seeds = ops.take(pcd, ops.fps(npoint, pcd.detach()))
    loss = []
    for p in percentages:
        nsample = max(int(n * p), 2)
        disk_area = math.pi * p / nsample
        expect = math.sqrt(disk_area)
        idx = ops.ball_query(math.sqrt(p), nsample, pcd, seeds)
        flat = ops.group(pcd, idx).reshape(-1, nsample, 3)
        nbr = ops.take(flat, ops.knn(2, flat, flat)[:, :, 1])
        spacing = torch.sqrt(torch.abs(torch.sum((flat - nbr) ** 2, -1)
                                       + 1e-8))
        dev = (spacing - expect) ** 2 / (expect + 1e-8)
        loss.append(torch.mean(dev) * (p * 100) ** 2)
    return sum(loss) / len(percentages)


def weight_fine(epoch, boundaries=(10.0, 20.0, 30.0),
                values=(0.01, 0.1, 0.5, 1.0)):
    i = int(torch.searchsorted(torch.tensor(boundaries, dtype=torch.float32),
                               torch.tensor(epoch, dtype=torch.float32),
                               side="left"))
    return float(torch.tensor(values, dtype=torch.float32)[i])


def learning_rate(epoch, base=1e-3, step=30, rate=0.7, clip=1e-6):
    f32 = torch.float32
    k = torch.floor(torch.tensor(epoch, dtype=f32) / step)
    factor = torch.tensor(rate, dtype=f32) ** k
    return float(torch.maximum(base * factor, torch.tensor(clip, dtype=f32)))


def pu_losses(coarse, fine, gt, radius, w_fine):
    """``1000·CD(coarse) + w_fine·1000·CD(fine) + repulsion``."""
    return (1000.0 * chamfer(coarse, gt, radius)
            + w_fine * (1000.0 * chamfer(fine, gt, radius))
            + repulsion(fine))


# ----------------------------------------------------------------- critic

MLPS = ((16, 16, 32), (32, 32, 64), (32, 48, 64))   # divide_ratio 2
NSAMPLES = (8, 16, 24)                              # kNN grouping


def leaky(x):
    return torch.where(x >= 0, x, 0.2 * x)


def critic_geometry(gt, pred, downsample=8):
    """FPS seeds on gt (n/8), then per scale both clouds' k nearest to
    each seed, centred on it: ``(seeds, [(gt_idx, pred_idx), …])``."""
    seeds = ops.take(gt, ops.fps(gt.shape[1] // downsample, gt.detach()))
    return seeds, [(ops.knn(k, gt, seeds), ops.knn(k, pred, seeds))
                   for k in NSAMPLES]


def critic(D, gt, pred, geometry):
    """(b, n_seeds, 2, 1) patch values: [:, :, 0] real (gt), [:, :, 1]
    fake (pred)."""
    seeds, per_scale = geometry
    feats = []
    for i, ((ig, ip), ns, mlps) in enumerate(zip(per_scale, NSAMPLES, MLPS)):
        g = torch.cat([ops.group(gt, ig), ops.group(pred, ip)], dim=2)
        g = g - seeds[:, :, None, :]
        for j in range(len(mlps)):
            g = leaky(dense(D, f"layer1.conv{i}_{j}", g, act=False))
        feats.append(torch.stack([torch.amax(g[:, :, :ns], dim=2),
                                  torch.amax(g[:, :, ns:], dim=2)], dim=2))
    return dense(D, "patch", torch.cat(feats, dim=-1), act=False)


# ------------------------------------------------------------------- adam

def _bias_correction(decay, count):
    f32 = torch.float32
    return float(torch.tensor(1.0, dtype=f32)
                 - torch.tensor(decay, dtype=f32)
                 ** torch.tensor(count, dtype=f32))


@torch.no_grad()
def adam(params, grads, mu, nu, count, lr, b1=0.9, clip=0.0):
    """One Adam step (the ``count``-th) in place; the root in f64 rounded
    to f32; with ``clip`` the parameters clipped to ±clip."""
    bc1, bc2 = _bias_correction(b1, count), _bias_correction(ADAM_B2, count)
    for name, p in params.items():
        g = grads[name]
        m = (1 - b1) * g + b1 * mu[name]
        v = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu[name]
        p.sub_(lr * ((m / bc1) / (torch.sqrt((v / bc2).double()).float()
                                  + ADAM_EPS)))
        if clip > 0:
            p.clamp_(-clip, clip)
        mu[name].copy_(m)
        nu[name].copy_(v)


class Trainer:
    """The reference's training state: generator weights ``G`` (and the
    critic's ``D`` with ``gan``), Adam moments, counts; :meth:`step` is
    one batch, returning its losses; ``first_grads`` keeps the gradient
    the first generator and critic updates were given."""

    def __init__(self, G, D=None, attention_bf16=False, gen_update=2,
                 d_clip=0.01, lr_d=1e-4):
        self.G = {k: v.clone() for k, v in G.items()}
        self.D = None if D is None else {k: v.clone() for k, v in D.items()}
        self.bf16 = attention_bf16
        self.gen_update, self.d_clip, self.lr_d = gen_update, d_clip, lr_d
        self.state = {}
        for net, W in (("G", self.G), ("D", self.D)):
            if W is None:
                continue
            params = {k: v for k, v in W.items() if not is_buffer(k)}
            self.state[net] = dict(
                params=params, count=0,
                mu={k: torch.zeros_like(v) for k, v in params.items()},
                nu={k: torch.zeros_like(v) for k, v in params.items()})
        self.first_grads = {}
        self.steps, self.epoch = 0, 0.0

    def _update(self, net, loss, lr, clip=0.0):
        st = self.state[net]
        names = list(st["params"])
        grads = torch.autograd.grad(loss, [st["params"][k] for k in names],
                                    allow_unused=True, retain_graph=True)
        grads = {k: (torch.zeros_like(st["params"][k]) if g is None else g)
                 for k, g in zip(names, grads)}
        if net not in self.first_grads:
            self.first_grads[net] = {k: g.detach().clone()
                                     for k, g in grads.items()}
        st["count"] += 1
        adam(st["params"], grads, st["mu"], st["nu"], st["count"], lr,
             clip=clip)

    def step(self, gt, radius, gen, n_in=256, batch_rows=None):
        """One step on (b, n, 3) dense patches; ``batch_rows``, when given,
        keeps only those rows after the draws (a fault a check must catch:
        half a batch left out)."""
        for st in self.state.values():
            for p in st["params"].values():
                p.requires_grad_(True)
        with uncounted():  # the input's draw is no model arithmetic
            inputs = draw_inputs(gt, n_in, gen)
            inputs, gt_aug = augment(inputs, gt, gen)
        if batch_rows is not None:
            inputs, gt_aug, radius = (t[batch_rows] for t in
                                      (inputs, gt_aug, radius))
        w_fine = weight_fine(self.epoch)
        lr_g = learning_rate(self.epoch)
        coarse, fine = generator(self.G, inputs, training=True,
                                 attention_bf16=self.bf16)
        pu = pu_losses(coarse, fine, gt_aug, radius, w_fine)
        out = {}
        if self.D is not None:
            fine0 = fine.detach()
            geometry = critic_geometry(gt_aug, fine0)
            hold = (self.d_clip == 0 and self.gen_update > 1
                    and self.steps % self.gen_update != 0)
            values = critic(self.D, gt_aug, fine0, geometry)
            real, fake = values[:, :, 0], values[:, :, 1]
            d_loss = 0.5 * (torch.mean((real - 1.0) ** 2)
                            + torch.mean(fake ** 2))
            if not hold:
                self._update("D", d_loss, self.lr_d, clip=self.d_clip)
            for p in self.state["D"]["params"].values():
                p.requires_grad_(False)
            g_fake = critic(self.D, gt_aug, fine, geometry)[:, :, 1]
            total = pu + torch.mean((g_fake - 1.0) ** 2)
            with torch.no_grad():
                out["uniform"] = 10.0 * uniform(fine0)
            out["d_loss"] = d_loss.detach()
        else:
            total = pu
        self._update("G", total, lr_g)
        self.steps += 1
        out["total"] = total.detach()
        return out

    def params(self, net):
        return self.state[net]["params"]
