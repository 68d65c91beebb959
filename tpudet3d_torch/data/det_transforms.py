"""Device augmentations of the detector stage, batched over ``[B,S,S,3]``
(counterpart of ``tpudet3d/data/det_transforms.py``).

BGR→RGB, then in training the photometric distortion (brightness ±32,
contrast and saturation 0.5–1.5, a per-channel hue-like shift ±18),
rot90 / rot270 with ``rot_p / 2`` each and a horizontal flip with
``flip_p``, then ``/255``.  Expand and MinIoURandomCrop run on the host
(``det_host_transforms.py``).

As in ``transforms.py`` each step is split in two: :meth:`sample` draws the
``[B]`` brightness, contrast, saturation and rotation draws, the ``[B,3]``
hue shifts and the ``[B]`` flip flags from a ``torch.Generator`` on the
batch's device; :meth:`apply` is a plain tensor function of them.  The
rotations and the flip are computed for the whole batch and selected per
sample with ``torch.where``, so nothing reads the device from the host.
Rotations assume square images.
"""

import torch

from ..parallel.sharding import local_rows, world

__all__ = ['build_detector_augmentations', 'DetectorAugmentations']


def _where(cond, a, b):
    """``cond [B]`` selects samples of a or b ``[B, ...]``."""
    return torch.where(cond.view(-1, *([1] * (a.dim() - 1))), a, b)


def _hflip(imgs, boxes):
    w = imgs.shape[2]
    x0, y0, x1, y1 = boxes.unbind(-1)
    return imgs.flip(2), torch.stack([w - x1, y0, w - x0, y1], -1)


def _rot90(imgs, boxes):
    """CCW 90°: (x, y) → (y, W-x); square inputs only."""
    w = imgs.shape[2]
    x0, y0, x1, y1 = boxes.unbind(-1)
    return (torch.rot90(imgs, 1, (1, 2)),
            torch.stack([y0, w - x1, y1, w - x0], -1))


def _rot270(imgs, boxes):
    w = imgs.shape[2]
    x0, y0, x1, y1 = boxes.unbind(-1)
    return (torch.rot90(imgs, 3, (1, 2)),
            torch.stack([w - y1, x0, w - y0, x1], -1))


class DetectorAugmentations:
    """``aug(imgs_u8 [B,S,S,3] BGR, boxes [B,G,4], generator) ->
    (imgs float32 [B,S,S,3] RGB in [0, 1], boxes)``."""

    def __init__(self, flip_p=0.5, rot_p=0.5, train=True):
        self.flip_p = float(flip_p)
        self.rot_p = float(rot_p)
        self.train = train

    def sample(self, n, generator, device):
        """The per-sample draws (empty out of training)."""
        if not self.train:
            return {}

        def uniform(lo, hi, *shape):
            return lo + (hi - lo) * torch.rand(n, *shape, generator=generator,
                                               device=device)
        return {'brightness': uniform(-32.0, 32.0),
                'contrast': uniform(0.5, 1.5),
                'saturation': uniform(0.5, 1.5),
                'hue': uniform(-18.0, 18.0, 3),
                'rot': uniform(0.0, 1.0),
                'flip': torch.rand(n, generator=generator, device=device)
                < self.flip_p}

    def apply(self, imgs, boxes, params):
        img = imgs.float().flip(-1)                 # BGR → RGB
        if self.train:
            def per(x):
                return x.view(-1, 1, 1, 1)
            img = img + per(params['brightness'])
            img = img * per(params['contrast'])
            gray = img.mean(-1, keepdim=True)
            img = gray + (img - gray) * per(params['saturation'])
            img = img + params['hue'][:, None, None, :]
            img = img.clamp(0, 255)
            r = params['rot']
            img90, b90 = _rot90(img, boxes)
            img270, b270 = _rot270(img, boxes)
            r90, r270 = r < self.rot_p / 2, r < self.rot_p
            img = _where(r90, img90, _where(r270, img270, img))
            boxes = _where(r90, b90, _where(r270, b270, boxes))
            fimg, fboxes = _hflip(img, boxes)
            img = _where(params['flip'], fimg, img)
            boxes = _where(params['flip'], fboxes, boxes)
        return img / 255.0, boxes

    def __call__(self, imgs, boxes, generator=None):
        # under a process group: the global batch's draws, this process's
        # rows of them (``parallel/``)
        return self.apply(imgs, boxes, local_rows(self.sample(
            imgs.shape[0] * world(), generator, imgs.device)))


def build_detector_augmentations(flip_p=0.5, rot_p=0.5, train=True):
    """The detector's device augmentations (:class:`DetectorAugmentations`)."""
    return DetectorAugmentations(flip_p, rot_p, train)
