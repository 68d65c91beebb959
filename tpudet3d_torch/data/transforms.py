"""Device augmentations, batched over ``[B,H,W,3]`` (counterpart of
``tpudet3d/data/transforms.py``).

The registry's names and parameters are the JAX package's, so a config's
pipeline carries over verbatim.  Each transform is split in two:

* ``draw(n, generator, device)``: the per-sample parameters (factors,
  shifts, a blur size, ``color_jitter``'s order, ``one_of``'s branch),
  drawn from a ``torch.Generator`` on the batch's device;
* ``apply(imgs, kps, params)``: a plain tensor function of the float32
  images, the pixel keypoints and those parameters.

A step with ``p < 1`` also draws ``do``, a per-sample Bernoulli(p), and
keeps the original sample where it is false (JAX's ``_maybe``).  Per-sample
choices among a few programs (``color_jitter``'s 24 orders, ``blur``'s
sizes, ``one_of``'s branches) compute every candidate over the batch and
select with ``torch.where``: nothing reads the device from the host, so
the pipeline runs inside a train step without a synchronisation.

``jax.random`` and ``torch.Generator`` streams differ, so the port does
not reproduce the JAX package's draws; given the same parameters, each
``apply`` computes what JAX's transform does (tests/test_torch_port_data.py).
"""

import itertools
import math

import torch
import torch.nn.functional as F

__all__ = ['build_augmentations', 'build_transform', 'Pipeline',
           'TRANSFORMS_REGISTRY', 'rgb_to_hsv', 'hsv_to_rgb']

_LUMA = (0.299, 0.587, 0.114)    # ITU-R 601 (torchvision rgb_to_grayscale)
_PERMS = tuple(itertools.permutations(range(4)))


def _uniform(n, lo, hi, generator, device):
    return lo + (hi - lo) * torch.rand(n, generator=generator, device=device)


def _per_sample(x, like):
    """A [B] parameter broadcast against ``like`` ([B, ...])."""
    return x.view(-1, *([1] * (like.dim() - 1)))


def _pick(which, candidates):
    """``candidates[which]`` elementwise (``which`` broadcasts against
    them): the first candidate whose index matches, the last one where
    none does, as ``jnp.select`` with a default."""
    out = candidates[-1]
    for k in range(len(candidates) - 2, -1, -1):
        out = torch.where(which == k, candidates[k], out)
    return out


class _Consts:
    """Small constants on each device the transform meets, copied once (a
    pinned, non-blocking copy: no synchronisation).  ``values`` is a tuple
    (or a tuple of tuples), which also keys the cache."""

    def __init__(self):
        self.cache = {}

    def __call__(self, values, device, dtype=torch.float32):
        key = (values, device, dtype)
        if key not in self.cache:
            t = torch.tensor(values, dtype=dtype)
            if device.type == 'cuda':
                t = t.pin_memory().to(device, non_blocking=True)
            self.cache[key] = t
        return self.cache[key]


class Transform:
    """``apply(imgs, kps, params) -> (imgs, kps)`` with per-sample
    ``params`` from ``draw``; ``p`` is the probability that a sample is
    transformed."""

    p = 1.0

    def draw(self, n, generator, device):
        return {}

    def apply(self, imgs, kps, params):
        raise NotImplementedError


def _maybe(t, imgs, kps, params):
    new_imgs, new_kps = t.apply(imgs, kps, params)
    if 'do' not in params:
        return new_imgs, new_kps
    do = params['do']
    return (torch.where(_per_sample(do, imgs), new_imgs, imgs),
            torch.where(_per_sample(do, kps), new_kps, kps))


def _draw_maybe(t, n, generator, device, always=False):
    params = t.draw(n, generator, device)
    if always or t.p < 1.0:
        params['do'] = torch.rand(n, generator=generator,
                                  device=device) < t.p
    return params


# --- geometry -----------------------------------------------------------

def _affine_warp(imgs, inv):
    """dst(x, y) = src(inv @ [x, y, 1]) per sample: bilinear, each
    neighbour outside the image counting as 0 (``map_coordinates(order=1,
    mode='constant', cval=0)``, its products and sums in its order).
    ``inv`` is [B, 2, 3]."""
    b, h, w, c = imgs.shape
    dev = imgs.device
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing='ij')
    m = [inv[:, i, j].view(b, 1, 1) for i in range(2) for j in range(3)]
    sx = m[0] * gx + m[1] * gy + m[2]
    sy = m[3] * gx + m[4] * gy + m[5]
    flat = imgs.reshape(b, h * w, c)

    def nodes(coord, size):
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.to(torch.int32)
        return [(index, 1 - upper_w), (index + 1, upper_w)]

    out = None
    for iy, wy in nodes(sy, h):
        for ix, wx in nodes(sx, w):
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            lin = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long()
            v = torch.gather(flat, 1, lin.view(b, -1, 1).expand(-1, -1, c))
            v = torch.where(valid.view(b, -1, 1), v, 0.0).view(b, h, w, c)
            term = (wy * wx)[..., None] * v
            out = term if out is None else out + term
    return out


def _rotation_matrix(cx, cy, angle_deg, scale):
    """[B, 2, 3], cv2.getRotationMatrix2D semantics (positive angle = CCW),
    float32 as the JAX package computes it."""
    rad = angle_deg * (math.pi / 180.0)
    a = scale * torch.cos(rad)
    b = scale * torch.sin(rad)
    return torch.stack([torch.stack([a, b, (1 - a) * cx - b * cy], -1),
                        torch.stack([-b, a, b * cx + (1 - a) * cy], -1)], 1)


def _invert_affine(m):
    """The inverse of [[a, b, tx], [-b, a, ty]] (a scaled rotation) in
    closed form: no pivoting, no error check, so no synchronisation."""
    a, b = m[:, 0, 0], m[:, 0, 1]
    tx, ty = m[:, 0, 2], m[:, 1, 2]
    det = a * a + b * b
    ia, ib = a / det, b / det
    return torch.stack([torch.stack([ia, -ib, -(ia * tx - ib * ty)], -1),
                        torch.stack([ib, ia, -(ib * tx + ia * ty)], -1)], 1)


def _scale_by_angle(angle_deg, h, w):
    """Auto-scale keeping the rotated frame inside the canvas."""
    rad = angle_deg * (math.pi / 180.0)
    cos = torch.cos(rad) - 1
    sin = torch.sin(rad)
    delta_h = w / 2 * cos + h / 2 * sin
    delta_w = w / 2 * sin + h / 2 * cos
    return torch.maximum(w / (w + 2 * delta_w.abs()),
                         h / (h + 2 * delta_h.abs()))


def _apply_affine_kp(kps, m):
    return kps @ m[:, :, :2].transpose(1, 2) + m[:, None, :, 2]


class RandomRotate(Transform):
    """Rotate with the keep-inside auto-scale."""

    def __init__(self, angle_limit=10.0, p=0.5, **_kw):
        self.angle_limit, self.p = float(angle_limit), p

    def draw(self, n, generator, device):
        return {'angle': _uniform(n, -self.angle_limit, self.angle_limit,
                                  generator, device)}

    def apply(self, imgs, kps, params):
        h, w = imgs.shape[1], imgs.shape[2]
        angle = params['angle']
        scale = _scale_by_angle(angle, float(h), float(w))
        m = _rotation_matrix(w * 0.5, h * 0.5, angle, scale)
        return (_affine_warp(imgs, _invert_affine(m)),
                _apply_affine_kp(kps, m))


class RandomRescale(Transform):
    """Scale the image about its centre and the keypoints about the
    origin (the reference's RandomRescale)."""

    def __init__(self, scale_limit=0.1, p=0.5, **_kw):
        self.lo, self.hi = ((scale_limit[0], scale_limit[1])
                            if isinstance(scale_limit, (tuple, list))
                            else (-scale_limit, scale_limit))
        self.p = p

    def draw(self, n, generator, device):
        return {'scale': 1.0 + _uniform(n, self.lo, self.hi, generator,
                                        device)}

    def apply(self, imgs, kps, params):
        h, w = imgs.shape[1], imgs.shape[2]
        scale = params['scale']
        zero = torch.zeros_like(scale)
        m_img = _rotation_matrix(w * 0.5, h * 0.5, zero, scale)
        m_kp = _rotation_matrix(0.0, 0.0, zero, scale)
        return (_affine_warp(imgs, _invert_affine(m_img)),
                _apply_affine_kp(kps, m_kp))


# --- flips and colour ---------------------------------------------------

class ConvertColor(Transform):
    """BGR → RGB."""

    def __init__(self, **_kw):
        pass

    def apply(self, imgs, kps, params):
        return imgs.flip(-1), kps


class HorizontalFlip(Transform):
    """Keypoints flip as x → (w − 1) − x, as albumentations flips them."""

    def __init__(self, p=0.5, **_kw):
        self.p = p

    def apply(self, imgs, kps, params):
        w = imgs.shape[2]
        return imgs.flip(2), torch.stack([w - 1 - kps[..., 0], kps[..., 1]],
                                         -1)


class RandomBrightnessContrast(Transform):
    """albumentations RandomBrightnessContrast, brightness_by_max=True:
    out = clip(img · (1 + U[−c, c]) + U[−b, b] · 255)."""

    def __init__(self, brightness_limit=0.2, contrast_limit=0.2, p=0.5,
                 **_kw):
        self.b, self.c, self.p = brightness_limit, contrast_limit, p

    def draw(self, n, generator, device):
        alpha = 1.0 + _uniform(n, -self.c, self.c, generator, device)
        beta = _uniform(n, -self.b, self.b, generator, device) * 255.0
        return {'alpha': alpha, 'beta': beta}

    def apply(self, imgs, kps, params):
        out = (imgs * _per_sample(params['alpha'], imgs)
               + _per_sample(params['beta'], imgs))
        return out.clamp(0, 255), kps


class RgbShift(Transform):
    def __init__(self, r_shift_limit=20, g_shift_limit=20, b_shift_limit=20,
                 p=0.5, **_kw):
        self.limits = (r_shift_limit, g_shift_limit, b_shift_limit)
        self.consts = _Consts()
        self.p = p

    def draw(self, n, generator, device):
        u = _uniform((n, 3), -1.0, 1.0, generator, device)
        return {'shift': u * self.consts(self.limits, u.device)}

    def apply(self, imgs, kps, params):
        return (imgs + params['shift'][:, None, None, :]).clamp(0, 255), kps


def rgb_to_hsv(img):
    """[..., 3] RGB float 0..255 → (h_deg, s, v): h ∈ [0, 360), s, v ∈
    0..255, cv2's float conventions."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = img.amax(-1)
    mn = img.amin(-1)
    delta = v - mn
    safe = torch.where(delta > 0, delta, 1.0)
    h = torch.where(v == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(v == g, (b - r) / safe + 2.0,
                                (r - g) / safe + 4.0)) * 60.0
    h = torch.where(delta > 0, h, 0.0)
    s = torch.where(v > 0, delta / torch.where(v > 0, v, 1.0), 0.0) * 255.0
    return h, s, v


def hsv_to_rgb(h, s, v):
    """Inverse of :func:`rgb_to_hsv`."""
    h60 = torch.remainder(h, 360.0) / 60.0
    i = torch.floor(h60)
    f = h60 - i
    s01 = s / 255.0
    p = v * (1.0 - s01)
    q = v * (1.0 - f * s01)
    t = v * (1.0 - (1.0 - f) * s01)
    i = torch.remainder(i.to(torch.int32), 6)
    r = _pick(i, (v, q, p, p, t, v))
    g = _pick(i, (t, v, v, q, p, p))
    b = _pick(i, (p, p, t, v, v, q))
    return torch.stack([r, g, b], -1)


class HueSaturationValue(Transform):
    """albumentations HueSaturationValue: hue + U[−h, h] in cv2's uint8
    units (2°) about the circle, saturation and value + U[−l, l] clipped."""

    def __init__(self, hue_shift_limit=20, sat_shift_limit=30,
                 val_shift_limit=20, p=0.5, **_kw):
        self.limits = (hue_shift_limit, sat_shift_limit, val_shift_limit)
        self.p = p

    def draw(self, n, generator, device):
        return {k: _uniform(n, -lim, lim, generator, device)
                for k, lim in zip(('hue', 'sat', 'val'), self.limits)}

    def apply(self, imgs, kps, params):
        h, s, v = rgb_to_hsv(imgs)
        h = torch.remainder(h + _per_sample(params['hue'], h) * 2.0, 360.0)
        s = (s + _per_sample(params['sat'], s)).clamp(0, 255)
        v = (v + _per_sample(params['val'], v)).clamp(0, 255)
        return hsv_to_rgb(h, s, v).clamp(0, 255), kps


class ColorJitter(Transform):
    """torchvision's ColorJitter: brightness, contrast and saturation blend
    with the ITU-R 601 grey, hue rotates by U[−hue, hue] of a cycle, in a
    random order of the four per sample."""

    def __init__(self, brightness=0.2, contrast=0.2, saturation=0.2, hue=0.2,
                 p=0.5, **_kw):
        self.limits = (brightness, contrast, saturation)
        self.hue = hue
        self.p = p
        self.consts = _Consts()

    def draw(self, n, generator, device):
        out = {'perm': torch.randint(0, len(_PERMS), (n,),
                                     generator=generator, device=device)}
        for k, lim in zip(('brightness', 'contrast', 'saturation'),
                          self.limits):
            out[k] = _uniform(n, max(0.0, 1.0 - lim), 1.0 + lim, generator,
                              device)
        out['hue'] = _uniform(n, -self.hue, self.hue, generator, device)
        return out

    def apply(self, imgs, kps, params):
        luma = self.consts(_LUMA, imgs.device)
        fb, fc, fs, fh = (_per_sample(params[k], imgs) for k in
                          ('brightness', 'contrast', 'saturation', 'hue'))

        def brightness(im):
            return (im * fb).clamp(0, 255)

        def contrast(im):
            mean = _per_sample((im @ luma).mean((1, 2)), im)
            return (im * fc + mean * (1.0 - fc)).clamp(0, 255)

        def saturation(im):
            gray = (im @ luma)[..., None]
            return (im * fs + gray * (1.0 - fs)).clamp(0, 255)

        def hue(im):
            h, s, v = rgb_to_hsv(im)
            return hsv_to_rgb(h + fh[..., 0] * 360.0, s, v).clamp(0, 255)

        ops = (brightness, contrast, saturation, hue)
        order = self.consts(_PERMS, imgs.device, torch.int64)[params['perm']]
        for stage in range(4):
            imgs = _pick(_per_sample(order[:, stage], imgs),
                         [op(imgs) for op in ops])
        return imgs, kps


def _mean_blur(imgs, k):
    """cv2.blur: a k×k mean filter over reflect-101 padding."""
    pad = k // 2
    x = F.pad(imgs.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode='reflect')
    c = x.shape[1]
    weight = torch.full((c, 1, k, k), 1.0 / (k * k), dtype=x.dtype,
                        device=x.device)
    return F.conv2d(x, weight, groups=c).permute(0, 2, 3, 1)


class Blur(Transform):
    """albumentations Blur: the kernel size drawn per sample from the odd
    values in [3, blur_limit]."""

    def __init__(self, blur_limit=5, p=0.5, **_kw):
        self.sizes = list(range(3, int(blur_limit) + 1, 2)) or [3]
        self.p = p

    def draw(self, n, generator, device):
        return {'size': torch.randint(0, len(self.sizes), (n,),
                                      generator=generator, device=device)}

    def apply(self, imgs, kps, params):
        return _pick(_per_sample(params['size'], imgs),
                     [_mean_blur(imgs, k) for k in self.sizes]), kps


class Normalize(Transform):
    def __init__(self, mean=(0.5931, 0.4690, 0.4229),
                 std=(0.2471, 0.2214, 0.2157), max_pixel_value=255.0, **_kw):
        # the JAX package's float32 products of mean and std with 255
        self.mean = tuple((torch.tensor(mean, dtype=torch.float32)
                           * max_pixel_value).tolist())
        self.std = tuple((torch.tensor(std, dtype=torch.float32)
                          * max_pixel_value).tolist())
        self.consts = _Consts()

    def apply(self, imgs, kps, params):
        dev = imgs.device
        return ((imgs - self.consts(self.mean, dev))
                / self.consts(self.std, dev), kps)


class ToTensor(Transform):
    """Keypoints to [0, 1] by the image's size; images stay NHWC."""

    def __init__(self, img_shape=None, **_kw):
        self.consts = _Consts()

    def apply(self, imgs, kps, params):
        h, w = imgs.shape[1], imgs.shape[2]
        return imgs, kps / self.consts((w, h), kps.device)


class OneOf(Transform):
    """One branch per sample, drawn uniformly; the branch itself is applied
    with its own probability."""

    def __init__(self, transforms=None, p=0.5, **_kw):
        self.branches = [build_transform(name, kwargs)
                         for name, kwargs in (transforms or [])]
        self.p = p

    def draw(self, n, generator, device):
        return {'branch': torch.randint(0, len(self.branches), (n,),
                                        generator=generator, device=device),
                'branches': [_draw_maybe(b, n, generator, device, always=True)
                             for b in self.branches]}

    def apply(self, imgs, kps, params):
        outs = [_maybe(b, imgs, kps, prm)
                for b, prm in zip(self.branches, params['branches'])]
        branch = params['branch']
        return (_pick(_per_sample(branch, imgs), [o[0] for o in outs]),
                _pick(_per_sample(branch, kps), [o[1] for o in outs]))


TRANSFORMS_REGISTRY = {
    'convert_color': ConvertColor,
    'random_rescale': RandomRescale,
    'horizontal_flip': HorizontalFlip,
    'hue_saturation_value': HueSaturationValue,
    'rgb_shift': RgbShift,
    'random_brightness_contrast': RandomBrightnessContrast,
    'color_jitter': ColorJitter,
    'blur': Blur,
    'normalize': Normalize,
    'to_tensor': ToTensor,
    'one_of': OneOf,
    'random_rotate': RandomRotate,
}

_HOST_ONLY = {'resize'}  # consumed by the host loader (static shapes)
# geometric warps run in the loader threads by default (host_transforms)
_HOST_GEOMETRIC = {'random_rotate', 'random_rescale'}


def build_transform(name, kwargs):
    return TRANSFORMS_REGISTRY[name](**dict(kwargs))


class Pipeline:
    """``pipeline(imgs_u8 [B,H,W,3], kps_px [B,9,2], generator) ->
    (imgs_f32, kps_01)``, i.e. ``apply(imgs, kps, sample(B, generator,
    device))``."""

    def __init__(self, steps):
        self.steps = steps

    def sample(self, n, generator, device):
        return [_draw_maybe(t, n, generator, device) for t in self.steps]

    def apply(self, imgs, kps, params):
        imgs = imgs.float()
        kps = kps.float()
        for t, prm in zip(self.steps, params):
            imgs, kps = _maybe(t, imgs, kps, prm)
        return imgs, kps

    def __call__(self, imgs, kps, generator):
        return self.apply(imgs, kps, self.sample(imgs.shape[0], generator,
                                                 imgs.device))


def build_augmentations(cfg, host_geometric=True):
    """(train_fn, test_fn) :class:`Pipeline` s of the config's
    ``train_data_pipeline`` and ``test_data_pipeline``.  With
    ``host_geometric`` (the default) the geometric warps are left to the
    loader threads (``data/host_transforms.py``)."""
    skip = _HOST_ONLY | (_HOST_GEOMETRIC if host_geometric else set())

    def compile_pipeline(pipeline_cfg):
        return Pipeline([build_transform(name, kwargs)
                         for name, kwargs in pipeline_cfg
                         if name not in skip])

    return (compile_pipeline(cfg.train_data_pipeline),
            compile_pipeline(cfg.test_data_pipeline))
