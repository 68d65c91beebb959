"""The plain float32 reference of the regressor's training step: the
config's device augmentations (drawn from the step's ``torch.Generator``
in the order the port draws them), the training forward (batch
statistics, the classifier's dropout), the weighted loss, AdamW, the
weight EMA and the running statistics.  A frozen copy of the arithmetic of
the port's ``data/transforms.py``, ``losses/`` and ``train/steps.py`` as
they stood when the benchmark was written; plain ``torch``, float32."""

import math
from contextlib import nullcontext

import torch

from .models import lowered


def _uniform(n, lo, hi, gen, device):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)


def _rows(x, like):
    return x.view(-1, *([1] * (like.dim() - 1)))


def _affine_warp(imgs, inv):
    """dst(x, y) = src(inv @ [x, y, 1]), bilinear, zeros outside."""
    b, h, w, c = imgs.shape
    dev = imgs.device
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing='ij')
    m = [inv[:, i, j].view(b, 1, 1) for i in range(2) for j in range(3)]
    sx = m[0] * gx + m[1] * gy + m[2]
    sy = m[3] * gx + m[4] * gy + m[5]
    flat = imgs.reshape(b, h * w, c)

    def nodes(coord):
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.to(torch.int32)
        return [(index, 1 - upper_w), (index + 1, upper_w)]

    out = None
    for iy, wy in nodes(sy):
        for ix, wx in nodes(sx):
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            lin = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long()
            v = torch.gather(flat, 1, lin.view(b, -1, 1).expand(-1, -1, c))
            v = torch.where(valid.view(b, -1, 1), v, 0.0).view(b, h, w, c)
            term = (wy * wx)[..., None] * v
            out = term if out is None else out + term
    return out


def _rotate(imgs, kps, angle):
    h, w = imgs.shape[1], imgs.shape[2]
    rad = angle * (math.pi / 180.0)
    cos, sin = torch.cos(rad) - 1, torch.sin(rad)
    dh = w / 2 * cos + h / 2 * sin
    dw = w / 2 * sin + h / 2 * cos
    scale = torch.maximum(w / (w + 2 * dw.abs()), h / (h + 2 * dh.abs()))
    cx, cy = w * 0.5, h * 0.5
    a, b = scale * torch.cos(rad), scale * torch.sin(rad)
    m = torch.stack([torch.stack([a, b, (1 - a) * cx - b * cy], -1),
                     torch.stack([-b, a, b * cx + (1 - a) * cy], -1)], 1)
    a, b = m[:, 0, 0], m[:, 0, 1]
    tx, ty = m[:, 0, 2], m[:, 1, 2]
    det = a * a + b * b
    ia, ib = a / det, b / det
    inv = torch.stack([torch.stack([ia, -ib, -(ia * tx - ib * ty)], -1),
                       torch.stack([ib, ia, -(ib * tx + ia * ty)], -1)], 1)
    return (_affine_warp(imgs, inv),
            kps @ m[:, :, :2].transpose(1, 2) + m[:, None, :, 2])


def augment(imgs, kps, gen, aug):
    """uint8 BGR ``[B,h,w,3]`` and pixel keypoints ``[B,9,2]`` → the
    normalised float32 RGB images and keypoints in [0, 1]: colour
    conversion, flip, brightness/contrast, rotation, normalisation, as the
    config ``aug`` sets them; every draw first, in the port's order."""
    n, dev = imgs.shape[0], imgs.device
    flip_do = torch.rand(n, generator=gen, device=dev) < aug['flip_p']
    c, b = aug['contrast'], aug['brightness']
    alpha = 1.0 + _uniform(n, -c, c, gen, dev)
    beta = _uniform(n, -b, b, gen, dev) * 255.0
    bc_do = torch.rand(n, generator=gen, device=dev) < aug['bc_p']
    angle = _uniform(n, -aug['angle'], aug['angle'], gen, dev)
    rot_do = torch.rand(n, generator=gen, device=dev) < aug['rotate_p']
    x, k = imgs.float().flip(-1), kps.float()
    w = x.shape[2]
    fx = x.flip(2)
    fk = torch.stack([w - 1 - k[..., 0], k[..., 1]], -1)
    x = torch.where(_rows(flip_do, x), fx, x)
    k = torch.where(_rows(flip_do, k), fk, k)
    bx = (x * _rows(alpha, x) + _rows(beta, x)).clamp(0, 255)
    x = torch.where(_rows(bc_do, x), bx, x)
    rx, rk = _rotate(x, k, angle)
    x = torch.where(_rows(rot_do, x), rx, x)
    k = torch.where(_rows(rot_do, k), rk, k)
    mean = torch.tensor(aug['mean'], dtype=torch.float32) * 255.0
    std = torch.tensor(aug['std'], dtype=torch.float32) * 255.0
    x = (x - mean.to(dev)) / std.to(dev)
    k = k / torch.tensor([x.shape[2], x.shape[1]], dtype=torch.float32,
                         device=dev)
    return x, k


def loss_fn(kp, gt_kp, logits, cats, coeffs):
    """``coeffs`` (l1, ADD, cross entropy) weigh the three losses."""
    l1 = (kp - gt_kp).abs().mean()
    add = torch.linalg.norm(kp - gt_kp, dim=2).sum(1).mean()
    ce = (torch.logsumexp(logits, -1)
          - logits.gather(-1, cats[:, None].long())[:, 0]).mean()
    return coeffs[0] * l1 + coeffs[1] * add + coeffs[2] * ce


class Trainer:
    """The reference's training state: the model, AdamW and the EMA of
    the parameters, started from the benchmark's weights."""

    def __init__(self, model, opt, lower=None):
        self.model = model
        self.opt_cfg = opt
        self.lower = lower
        self.params = list(model.parameters())
        self.optimizer = torch.optim.AdamW(
            self.params, lr=opt['lr'], betas=tuple(opt['betas']), eps=1e-8,
            weight_decay=opt['wd'], foreach=False)
        d = torch.tensor(opt['ema_decay'], dtype=torch.float32)
        self.decay, self.rest = float(d), float(1.0 - d)
        self.ema = [p.detach().clone() for p in self.params]

    def step(self, imgs, kps, cats, gen, aug, coeffs):
        """One step; returns the loss (float) and the gradients as AdamW
        received them."""
        x, k = augment(imgs, kps, gen, aug)
        with (lowered(self.lower) if self.lower else nullcontext()):
            kp, logits = self.model(x, cats=cats, train=True, generator=gen)
            loss = loss_fn(kp, k, logits, cats, coeffs)
        self.optimizer.zero_grad(set_to_none=False)
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss.backward()
        grads = [p.grad.detach().clone() for p in self.params]
        self.optimizer.step()
        with torch.no_grad():
            for e, p in zip(self.ema, self.params):
                e.mul_(self.decay).add_(p.detach(), alpha=self.rest)
        return float(loss.detach()), grads

